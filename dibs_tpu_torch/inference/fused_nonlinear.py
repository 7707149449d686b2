"""Fused sample-and-score estimators for the one-hidden-layer MLP likelihood
(PyTorch twin of ``dibs_tpu/inference/fused_nonlinear.py``).

For ``JointDiBS`` with :class:`~dibs_tpu_torch.models.DenseNonlinearGaussian`
(one hidden layer, biases) and the reparameterization estimator, one call
computes both likelihood gradients

    d scores = sum_m softmax(l_soft)_m grad_scores l_soft_m      (reparam)
    d Theta  = sum_m softmax(l_hard)_m grad_Theta  l_hard_m

in one pass over the samples with an online softmax per stream, without
storing a sample. Every sample is scored relative to the expected graph
``E[G] = sigmoid(alpha s)`` (centred scoring): the reference forward
``pre_ref_h = x @ (E[G] * W1_h) + b1_h``, ``resid_ref = x - mean_ref`` runs
once per particle; per sample only ``D_h = x @ ((G - E[G]) * W1_h)`` is
formed, with the activation differences taken stably (relu in its exact
branch form). The per-sample sums of the centred log-likelihood are float64
in the kernel and in the plain version alike. The maths is written out in
``csrc/fused_nonlinear.cu``.

Kernel #8 (``fused_nonlinear``, replaces ``_fused_nl_call``) takes the
kernel layout built here: ``W1 -> [P, h1, d(in), d(node)]``, the masked-prior
sums ``L1 [P, d, d]``, ``b1 -> [P, h1, d]``, ``W2 || b2 -> [P, h1 + 1, d]``.
The sample-independent prior terms ``-b1/sig_p^2``, ``-W2/sig_p^2`` and
``-b2/sig_p^2`` are added outside the kernel (softmax weights sum to 1);
``H * (-W1/sig_p^2)`` depends on the hard sample and stays inside.

Noise: as :mod:`dibs_tpu_torch.inference.fused_linear` (``streams = (soft,
hard)``, equal streams give the hard sample as the threshold of the soft
sample's noise, or the injected ``eps = (eps_soft, eps_hard)`` of
``[P, M, d, d]``). Dispatch: a CUDA tensor goes to the kernel, a CPU tensor
to the plain version in this module.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from dibs_tpu_torch.inference.fused_linear import _chunks, _noise
from dibs_tpu_torch.models.nonlinear_gaussian import ACTIVATIONS
from dibs_tpu_torch.ops.edges import edge_scores
from dibs_tpu_torch.ops.gpu_kernels import (
    _check_cuda,
    _check_launch,
    _stream,
    build,
)

__all__ = [
    "fused_nonlinear_available",
    "fused_nonlinear_decline_reason",
    "fused_nonlinear_tile_rows",
    "fused_nonlinear_smem_bytes",
    "fused_nonlinear_estimators",
    "fused_nonlinear",
    "fused_nonlinear_plain",
]

# the kernel's shared-memory footprint (csrc/fused_nonlinear.cu: smem_bytes)
_MAX_SMEM = 232448  # 227 KB, the most one block can use on Hopper
_HALF_SMEM = 115712  # two blocks per SM: (228 KB - 2 x 1 KB reserved) / 2
_THREADS = 256
_MAX_H = 16  # the kernel's register arrays
_RED_BYTES = 8 * (2 * 8 + 2)
_TILE_MAX, _TILE_MIN = 128, 8
_MIN_CHUNK = 4  # fewest samples a block loops over


# the activations' derivatives, and the kernel's codes for them
_DACTS = {
    "relu": lambda v: (v > 0.0).to(v.dtype),
    "tanh": lambda v: 1.0 - torch.tanh(v) ** 2,
    "sigmoid": lambda v: torch.sigmoid(v) * (1.0 - torch.sigmoid(v)),
    "leakyrelu": lambda v: torch.where(v > 0.0, torch.ones_like(v),
                                       torch.full_like(v, 0.01)),
}
_ACT_CODES = {"relu": 0, "tanh": 1, "sigmoid": 2, "leakyrelu": 3}


def _act_diff(activation, act, p, dl, pre):
    """``act(p + dl) - act(p)`` given ``pre = p + dl``: relu in its exact
    branch form (no cancellation against a large ``p``), the others as the
    plain difference of bounded or near-linear values."""
    if activation == "relu":
        return torch.where(p >= 0.0, torch.maximum(dl, -p), torch.relu(pre))
    return act(pre) - act(p)


def fused_nonlinear_smem_bytes(d: int, h1: int, tile_rows: int) -> int:
    """Shared memory of one kernel block: ``(7 + 5 h1)`` ``[d, d]``
    matrices, ``3 h1 + 1`` rows of ``d``, ``3 + h1`` data tiles of
    ``tile_rows`` rows, the two ``u_h`` tiles (or, reusing them, the row
    reduction of the block's ``256 // d`` row lanes) and the float64
    reduction slots."""
    tnd = tile_rows * d
    floats = ((7 + 5 * h1) * d * d + (3 * h1 + 1) * d + (3 + h1) * tnd
              + max(2 * h1 * tnd, (2 * h1 + 1) * (_THREADS // d) * d))
    return _RED_BYTES + 4 * floats


def fused_nonlinear_tile_rows(d: int, h1: int, n_obs: int) -> Optional[int]:
    """Data rows per shared-memory tile, or ``None`` where the kernel does
    not fit: the largest of ``min(N, 128)`` halved down to 8 with which two
    blocks share an SM, else with which one block fits in 227 KB."""
    for budget in (_HALF_SMEM, _MAX_SMEM):
        tile = min(n_obs, _TILE_MAX)
        while (fused_nonlinear_smem_bytes(d, h1, tile) > budget
               and tile > _TILE_MIN):
            tile = max(_TILE_MIN, tile // 2)
        if fused_nonlinear_smem_bytes(d, h1, tile) <= budget:
            return tile
    return None


def fused_nonlinear_decline_reason(model, n_obs: int) -> Optional[str]:
    """Why the kernel does not serve ``model`` with ``N = n_obs`` rows, or
    ``None`` when it does."""
    if len(model.hidden_layers) != 1:
        return (f"hidden_layers={model.hidden_layers}: the kernel serves one "
                "hidden layer")
    if not model.bias:
        return "bias=False: the kernel serves layers with biases"
    d, h1 = model.n_vars, model.hidden_layers[0]
    if h1 > _MAX_H:
        return f"hidden width {h1} > {_MAX_H} (the kernel's register arrays)"
    if not 1 <= d <= _THREADS:
        return f"d={d} outside 1..{_THREADS} (one block row per node)"
    if n_obs < 1:
        return "no observations"
    if fused_nonlinear_tile_rows(d, h1, n_obs) is None:
        return (f"d={d}, h1={h1} needs "
                f"{fused_nonlinear_smem_bytes(d, h1, min(n_obs, _TILE_MIN))}"
                f" bytes of shared memory at {_TILE_MIN}-row tiles, over the "
                f"{_MAX_SMEM} a block can use")
    return None


def fused_nonlinear_available(model, n_obs: int) -> bool:
    """True when kernel #8 serves ``model`` with ``N = n_obs`` rows."""
    return fused_nonlinear_decline_reason(model, n_obs) is None


# ---------------------------------------------------------------------------
# plain PyTorch version (explicit particle and sample axes)
# ---------------------------------------------------------------------------


def fused_nonlinear_plain(scores, w1t, l1, b1t, w2t, x, w, *, seed, streams,
                          alpha, tau, n_samples, model, eps=None):
    """Plain version of kernel #8, in its layout: returns ``(d scores [P, d,
    d], dW1 [P, h1, d, d], small [P, 2 h1 + 1, d])`` (``small`` holds the
    ``db1``, ``dW2`` and ``db2`` rows), before the outside prior terms.
    One pass over the samples in chunks with the kernel's online softmax."""
    p, d, _ = scores.shape
    h1 = w1t.shape[1]
    act, dact = ACTIVATIONS[model.activation], _DACTS[model.activation]
    dev = scores.device
    eps_s, eps_h = _noise((p, n_samples, d, d), seed, streams, eps, dev)
    offdiag = 1.0 - torch.eye(d, dtype=scores.dtype, device=dev)
    alpha_s = alpha * scores
    sig = torch.sigmoid(alpha_s) * offdiag  # E[G]
    inv_var = 1.0 / model.obs_noise
    inv_varp = 1.0 / (model.sig_param * model.sig_param)
    w2h = w2t[:, :h1]  # [P, h1, d]
    # centring reference, once per particle
    pre_ref = x @ (sig[:, None] * w1t) + b1t[:, :, None, :]  # [P, h1, N, d]
    mean_ref = w2t[:, h1, None, :]
    for h in range(h1):
        mean_ref = mean_ref + act(pre_ref[:, h]) * w2h[:, h, None, :]
    rr = (x - mean_ref)[:, None]  # [P, 1, N, d]
    pre_ref = pre_ref[:, None]  # [P, 1, h1, N, d]
    w2b = w2h[:, None, :, None, :]  # [P, 1, h1, 1, d]

    def forward(g):
        """Centred ``dll [P, m]``, ``delta [P, m, N, d]``, ``pre``, ``u``
        and ``x^T u`` of a chunk of samples ``g [P, m, d, d]``."""
        dg = g - sig[:, None]
        dl = x @ (dg[:, :, None] * w1t[:, None])  # [P, m, h1, N, d]
        pre = pre_ref + dl
        a_diff = _act_diff(model.activation, act, pre_ref, dl, pre)
        md = 0.0
        for h in range(h1):
            md = md + a_diff[:, :, h] * w2b[:, :, h]
        data = (w * md * (md - 2.0 * rr)).double().sum((-2, -1))
        prior = (dg * l1[:, None]).double().sum((-2, -1))
        ll = (-0.5 * inv_var * data + prior).float()
        delta = inv_var * ((rr - md) * w)
        u = delta[:, :, None] * dact(pre) * w2b
        return ll, delta, pre, u, x.T @ u

    state = {}
    for key in ("soft", "hard"):
        state[key] = [torch.full((p,), -math.inf, device=dev),
                      torch.zeros(p, device=dev), None]
    a_s = alpha_s[:, None]
    for m0, m1 in _chunks(n_samples):
        g_soft = torch.sigmoid(tau * (eps_s[:, m0:m1] + a_s)) * offdiag
        g_hard = ((eps_h[:, m0:m1] + a_s) > 0.0).to(scores.dtype) * offdiag
        ll_s, _, _, _, xtu_s = forward(g_soft)
        c_soft = (tau * alpha * g_soft * (1.0 - g_soft)
                  * (l1[:, None] + (w1t[:, None] * xtu_s).sum(2)),)
        ll_h, delta_h, pre_h, u_h, xtu_h = forward(g_hard)
        c_hard = (g_hard[:, :, None] * (xtu_h - w1t[:, None] * inv_varp),
                  torch.cat([u_h.sum(-2),
                             (delta_h[:, :, None] * act(pre_h)).sum(-2),
                             delta_h.sum(-2)[:, :, None]], dim=2))
        for key, ll, contribs in (("soft", ll_s, c_soft),
                                  ("hard", ll_h, c_hard)):
            run_max, norm, acc = state[key]
            new_max = torch.maximum(run_max, ll.max(dim=1).values)
            scale = torch.exp(run_max - new_max)
            wts = torch.exp(ll - new_max[:, None])
            summed = [torch.einsum("pm,pm...->p...", wts, c) for c in contribs]
            if acc is None:
                acc = summed
            else:
                acc = [a * scale.view((-1,) + (1,) * (a.dim() - 1)) + s_
                       for a, s_ in zip(acc, summed)]
            state[key] = [new_max, norm * scale + wts.sum(1), acc]
    ds = state["soft"][2][0] / state["soft"][1][:, None, None]
    norm_h = state["hard"][1]
    return (ds, state["hard"][2][0] / norm_h[:, None, None, None],
            state["hard"][2][1] / norm_h[:, None, None])


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _chunk(p: int, n_samples: int, smem: int, n_sms: int) -> int:
    """Samples per block: the (particle, chunk) grid fills one wave of the
    blocks the card holds at once (two per SM where two fit), never more,
    so no second wave of a few blocks doubles the time."""
    resident = (2 if smem <= _HALF_SMEM else 1) * n_sms
    splits = max(1, min(n_samples // _MIN_CHUNK, resident // max(p, 1)))
    return -(-n_samples // splits)


def _launch(scores, w1t, l1, b1t, w2t, x, w, *, seed, streams, alpha, tau,
            n_samples, model, eps):
    name = "fused_nonlinear"
    p, d, d2 = scores.shape
    h1 = w1t.shape[1]
    n_obs = x.shape[0]
    shapes = {"w1t": (w1t, (p, h1, d, d)), "l1": (l1, (p, d, d)),
              "b1t": (b1t, (p, h1, d)), "w2t": (w2t, (p, h1 + 1, d)),
              "x": (x, (n_obs, d)), "w": (w, (n_obs, d))}
    bad = [f"{k} {tuple(t.shape)} != {s}" for k, (t, s) in shapes.items()
           if tuple(t.shape) != s]
    if d != d2 or bad:
        raise ValueError(f"{name}: bad shapes (scores {tuple(scores.shape)}"
                         f"): {'; '.join(bad)}")
    _check_cuda(name, scores, w1t, l1, b1t, w2t, x, w)
    eps_ptrs = (None, None)
    if eps is not None:
        _check_cuda(name, *eps)
        for e in eps:
            if tuple(e.shape) != (p, n_samples, d, d):
                raise ValueError(f"{name}: eps must be "
                                 f"{(p, n_samples, d, d)}, got "
                                 f"{tuple(e.shape)}")
        eps_ptrs = tuple(e.data_ptr() for e in eps)
    reason = fused_nonlinear_decline_reason(model, n_obs)
    if reason is not None or model.hidden_layers[0] != h1 \
            or model.n_vars != d:
        raise ValueError(f"{name}: the kernel does not serve this model: "
                         f"{reason or 'model and tensors disagree'}")
    tile_rows = fused_nonlinear_tile_rows(d, h1, n_obs)
    chunk = _chunk(p, n_samples, fused_nonlinear_smem_bytes(d, h1, tile_rows),
                   torch.cuda.get_device_properties(
                       scores.device).multi_processor_count)
    n_split = -(-n_samples // chunk)
    lib = build()
    empty = dict(dtype=torch.float32, device=scores.device)
    ds = torch.empty((p, d, d), **empty)
    dw1 = torch.empty((p, h1, d, d), **empty)
    small = torch.empty((p, 2 * h1 + 1, d), **empty)
    ref = torch.empty((p, h1 + 1, n_obs, d), **empty)
    part = torch.empty((p, n_split, 4 + (1 + h1) * d * d + (2 * h1 + 1) * d),
                       **empty)
    with torch.cuda.device(scores.device):
        rc = lib.dibs_fused_nonlinear(
            scores.data_ptr(), w1t.data_ptr(), l1.data_ptr(), b1t.data_ptr(),
            w2t.data_ptr(), x.data_ptr(), w.data_ptr(), *eps_ptrs,
            ref.data_ptr(), part.data_ptr(), ds.data_ptr(), dw1.data_ptr(),
            small.data_ptr(), p, n_samples, d, h1, n_obs, tile_rows, chunk,
            _ACT_CODES[model.activation], seed & 0xFFFFFFFFFFFFFFFF,
            streams[0] & 0xFFFFFFFF, streams[1] & 0xFFFFFFFF, float(alpha),
            float(tau), 1.0 / model.obs_noise,
            1.0 / (model.sig_param * model.sig_param),
            _stream(scores.device))
    _check_launch(lib, rc, name)
    return ds, dw1, small


def fused_nonlinear(scores, w1t, l1, b1t, w2t, x, w, *, seed, streams, alpha,
                    tau, n_samples, model, eps=None):
    """Kernel #8 in its layout (see :func:`fused_nonlinear_plain`)."""
    kw = dict(seed=seed, streams=streams, alpha=alpha, tau=tau,
              n_samples=n_samples, model=model, eps=eps)
    if scores.device.type == "cpu":
        return fused_nonlinear_plain(scores, w1t, l1, b1t, w2t, x, w, **kw)
    return _launch(scores, w1t, l1, b1t, w2t, x, w, **kw)


# ---------------------------------------------------------------------------
# layouts into and out of the kernel
# ---------------------------------------------------------------------------


def kernel_layout(thetas, model):
    """``(w1t, l1, b1t, w2t)`` of the parameter tree ``[(W1 [P, d, d, h1],
    b1 [P, d, h1]), (W2 [P, d, h1, 1], b2 [P, d, 1])]``."""
    (w1, b1), (w2, b2) = thetas
    sp = model.sig_param
    logpdf = (-0.5 * torch.square(w1 / sp) - math.log(sp)
              - 0.5 * math.log(2.0 * math.pi))
    l1 = logpdf.sum(-1).transpose(1, 2)  # [P, i, j]
    w2t = torch.cat([w2[..., 0].transpose(1, 2), b2[..., 0][:, None]], dim=1)
    return tuple(t.contiguous() for t in (w1.permute(0, 3, 2, 1), l1,
                                          b1.transpose(1, 2), w2t))


def _model_layout(thetas, model, dw1, small):
    """The kernel's ``dW1`` and ``small`` rows as the parameter tree, plus
    the sample-independent prior terms of ``b1``, ``W2`` and ``b2``."""
    (_, b1), (w2, b2) = thetas
    h1 = dw1.shape[1]
    inv_varp = 1.0 / (model.sig_param * model.sig_param)
    db1 = small[:, :h1].transpose(1, 2) - inv_varp * b1
    dw2 = small[:, h1:2 * h1].transpose(1, 2)[..., None] - inv_varp * w2
    db2 = small[:, 2 * h1][..., None] - inv_varp * b2
    return [(dw1.permute(0, 3, 2, 1), db1), (dw2, db2)]


def fused_nonlinear_estimators(*, zs, thetas, x, interv_mask, seed, streams,
                               alpha, tau, n_samples, model, eps=None):
    """``(d scores [P, d, d], d Theta tree)``: the fused reparam
    Z-likelihood and Theta-likelihood estimates for a one-hidden-layer
    :class:`~dibs_tpu_torch.models.DenseNonlinearGaussian`. The caller
    chains ``d scores`` to ``Z`` with ``dU = dS V``, ``dV = dS^T U``."""
    scores = edge_scores(zs).contiguous()
    w = (1.0 - interv_mask.to(torch.float32)).contiguous()
    ds, dw1, small = fused_nonlinear(
        scores, *kernel_layout(thetas, model), x.contiguous(), w,
        seed=int(seed), streams=tuple(int(s) for s in streams),
        alpha=float(alpha), tau=float(tau), n_samples=n_samples, model=model,
        eps=eps)
    return ds, _model_layout(thetas, model, dw1, small)
