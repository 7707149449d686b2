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
``[P, M, d, d]``). Dispatch (:func:`~dibs_tpu_torch.ops.gpu_kernels.
use_kernel`): a CUDA tensor goes to the kernel, a CPU tensor (or any, with
the kill switch off) to the plain version in this module. A particle
shard's ``particle_offset`` (its first particle's global index) launches
the shard build (``csrc/fused_nonlinear_shard.cu``), a fleet's keys the
fleet build.

One kernel body, ``fused_nl_kernel``, in two builds: shapes whose slabs fit
one block run it one block a particle; past that, on a card that launches
thread-block clusters, its cluster build splits each particle's node
columns over the blocks of a cluster. :func:`fused_nonlinear_plan` says
which (``ranks``).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from dibs_tpu_torch.inference.fused_linear import (
    _chunks,
    _fleet_keys,
    _noise,
    per_dataset,
)
from dibs_tpu_torch.models.nonlinear_gaussian import ACTIVATIONS
from dibs_tpu_torch.ops.edges import edge_scores
from dibs_tpu_torch.ops.gpu_kernels import (
    _check_cuda,
    _check_launch,
    _stream,
    build,
    check_offset,
    use_kernel,
)
from dibs_tpu_torch.profiling import count

__all__ = [
    "fused_nonlinear_available",
    "fused_nonlinear_decline_reason",
    "fused_nonlinear_tile_rows",
    "fused_nonlinear_smem_bytes",
    "NonlinearPlan",
    "fused_nonlinear_plan",
    "fused_nonlinear_plan_smem_bytes",
    "fused_nonlinear_estimators",
    "fused_nonlinear",
    "fused_nonlinear_plain",
]

_MAX_SMEM = 232448  # 227 KB, the most one block can use on Hopper
_HALF_SMEM = 115712  # two blocks per SM: (228 KB - 2 x 1 KB reserved) / 2
_THREADS = 256
_BLOCK = 512  # threads of a fused_nl_kernel block
_MAX_H = 16  # the kernel's register arrays
_GROUP_MAX = 2  # samples a group (csrc/fused_nonlinear.cu: kGroupMax)
_CLUSTER_RANKS = (2, 4, 8)  # the portable cluster sizes
_CLUSTER_CAPABILITY = (9, 0)  # the first with thread-block clusters
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


# The shapes kernel #8 serves (the gate) are those where the following
# measure fits one block at tiles of min(N, 8) rows or more. The gate keeps
# this measure, so that the set of served shapes does not change with the
# kernel's layout; the kernel's own footprint (fused_nonlinear_plan) fits
# wherever the measure does (tests/test_torch_fused_nonlinear_plan.py).


def fused_nonlinear_smem_bytes(d: int, h1: int, tile_rows: int) -> int:
    """The gate's measure: ``(7 + 5 h1)`` ``[d, d]`` matrices, ``3 h1 + 1``
    rows of ``d``, ``3 + h1`` data tiles of ``tile_rows`` rows, two
    ``[h1, tile_rows, d]`` tiles (or ``(2 h1 + 1)`` rows of ``256 // d``
    lanes) and 18 float64 slots, in bytes."""
    tnd = tile_rows * d
    floats = ((7 + 5 * h1) * d * d + (3 * h1 + 1) * d + (3 + h1) * tnd
              + max(2 * h1 * tnd, (2 * h1 + 1) * (_THREADS // d) * d))
    return _RED_BYTES + 4 * floats


def fused_nonlinear_tile_rows(d: int, h1: int, n_obs: int) -> Optional[int]:
    """The gate's tile of the measure, or ``None`` where the kernel does
    not serve ``(d, h1, N)``: the largest of ``min(N, 128)`` halved down to
    8 with which the measure fits half an SM, else 227 KB."""
    for budget in (_HALF_SMEM, _MAX_SMEM):
        tile = min(n_obs, _TILE_MAX)
        while (fused_nonlinear_smem_bytes(d, h1, tile) > budget
               and tile > _TILE_MIN):
            tile = max(_TILE_MIN, tile // 2)
        if fused_nonlinear_smem_bytes(d, h1, tile) <= budget:
            return tile
    return None


def _cluster_launch(device) -> bool:
    """True where ``device`` is a CUDA device that launches thread-block
    clusters (compute capability 9.0 or higher)."""
    if device is None or torch.device(device).type != "cuda":
        return False
    return torch.cuda.get_device_capability(device) >= _CLUSTER_CAPABILITY


def fused_nonlinear_decline_reason(model, n_obs: int,
                                   device=None) -> Optional[str]:
    """Why the kernel does not serve ``model`` with ``N = n_obs`` rows on
    ``device``, or ``None`` when it does. Shapes within the one-block
    measure are served on any device; past it, the cluster build serves
    those with a :func:`fused_nonlinear_plan` on a CUDA device that
    launches clusters."""
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
        block = (f"d={d}, h1={h1} needs "
                 f"{fused_nonlinear_smem_bytes(d, h1, min(n_obs, _TILE_MIN))}"
                 f" bytes of shared memory at {_TILE_MIN}-row tiles, over "
                 f"the {_MAX_SMEM} a block can use")
        if fused_nonlinear_plan(d, h1, n_obs) is None:
            return (f"{block}, and no cluster of {_CLUSTER_RANKS} blocks "
                    "holds its node columns (the cluster tier)")
        if not _cluster_launch(device):
            return (f"{block}; the cluster tier needs a CUDA device of "
                    "compute capability "
                    f"{'.'.join(map(str, _CLUSTER_CAPABILITY))} or higher "
                    f"(device: {device})")
    return None


def fused_nonlinear_available(model, n_obs: int, device=None) -> bool:
    """True when kernel #8 serves ``model`` with ``N = n_obs`` rows on
    ``device``."""
    return fused_nonlinear_decline_reason(model, n_obs, device) is None


class NonlinearPlan(NamedTuple):
    """How ``fused_nl_kernel`` runs one shape: blocks a particle's work item
    (1, or a cluster's 2, 4 or 8, each ``ceil(d / ranks)`` node columns at
    most), samples a group, rows of u_h staged at once (a multiple of 4),
    data rows a tile (``N``: resident for every sample), and a block's
    shared memory in bytes."""
    ranks: int
    group: int
    sub_rows: int
    tile_rows: int
    smem_bytes: int


def fused_nonlinear_plan_smem_bytes(d: int, h1: int, group: int,
                                    sub_rows: int, tile_rows: int,
                                    n_obs: int, ranks: int = 1) -> int:
    """Shared memory of one ``fused_nl_kernel`` block, region by region
    (``csrc/fused_nonlinear.cu: smem_bytes``): float64 row and prior
    partials; the data tile (x transposed and row-major, the row-major
    copy twice where the rows are tiled, w, resid_ref, pre_ref_h); the
    double-buffered u_h stage of every (sample, stream); the particle's
    ``[d, d]`` slabs and W2; the accumulators; the group's sample slabs
    and x^T u sums; the hard stream's row sums and the group's dll. The
    hidden unit is the innermost index of W1, pre_ref and u_h, at the odd
    stride ``h1 | 1``. With ``ranks`` > 1, one rank of a cluster: its
    ``ceil(d / ranks)`` node columns of every region indexed by node, and
    the double-buffered float64 exchange slots of the group's dll."""
    cols = -(-d // ranks)
    ldt, ldx = -(-tile_rows // 4) * 4, -(-d // 4) * 4
    dc, hs = d * cols, h1 | 1  # [.., h] rows at an odd stride
    doubles = _BLOCK + _BLOCK // 32 * 2 * _GROUP_MAX
    if ranks > 1:
        doubles += 2 * 2 * _GROUP_MAX
    x_bufs = 2 if tile_rows < n_obs else 1
    tile = d * ldt + x_bufs * tile_rows * ldx + (2 + hs) * tile_rows * cols
    stage = 2 * 2 * group * sub_rows * cols * hs
    particle = (3 + hs) * dc + h1 * cols
    accs = (1 + h1) * dc + (2 * h1 + 1) * cols
    samples = group * (3 + h1) * dc
    sums = (2 * h1 + 1) * _BLOCK // 2 + 2 * _GROUP_MAX
    return 8 * doubles + 4 * (tile + stage + particle + accs + samples + sums)


def _block_plan(d, h1, n_obs, ranks, resident):
    """``(group, sub_rows, tile_rows, smem_bytes)`` of one block (or one
    rank of ``ranks``) at ``(d, h1, N)``, or ``None``. A thread of the
    delta product owns one (sample, stream, node column) and row quads, so
    a group of ``g`` samples over ``c`` columns has ``512 // (2 g c)`` row
    lanes. ``resident``: every data row resident, groups of 2 (else 1),
    u_h staged in sub-tiles of whole rounds of the lanes, balanced over the
    rows (smaller where that does not fit). Else tiles of whole sub-tiles,
    as many rows as fit, loaded once per group."""
    def smem(group, sub, tile):
        return fused_nonlinear_plan_smem_bytes(d, h1, group, sub, tile, n_obs,
                                               ranks)

    cols = -(-d // ranks)
    quads = -(-n_obs // 4)
    groups = [g for g in range(_GROUP_MAX, 0, -1) if 2 * g * cols <= _BLOCK]
    for group in groups:
        lanes = _BLOCK // (2 * group * cols)
        if resident:
            first = 4 * -(-quads // -(-quads // lanes))
            for sub in range(first, 0, -4):
                if smem(group, sub, n_obs) <= _MAX_SMEM:
                    return group, sub, n_obs, smem(group, sub, n_obs)
            continue
        for sub in range(min(4 * lanes, 4 * quads), 0, -4):
            base = smem(group, sub, 0)
            per_row = smem(group, sub, 4) - base  # tiles are whole quads
            fit = (_MAX_SMEM - base) // per_row * 4 if base < _MAX_SMEM else 0
            tile = min((n_obs - 1) // sub, fit // sub) * sub
            if tile >= sub:
                return group, sub, tile, smem(group, sub, tile)
    return None


@functools.lru_cache(maxsize=None)
def fused_nonlinear_plan(d: int, h1: int, n_obs: int) -> Optional[NonlinearPlan]:
    """The kernel's plan for ``(d, h1, N)``, or ``None`` where none holds
    it: one block where the gate's one-block measure fits
    (:func:`fused_nonlinear_tile_rows`), else the fewest ranks of a cluster
    of 2, 4 or 8 with every data row resident, else the fewest with tiles
    (:func:`_block_plan`); none where the per-particle reference's block,
    ``[h1, d, d]`` masked weights, does not fit."""
    if 4 * (h1 * d * d + (2 * h1 + 1) * d) > _MAX_SMEM:
        return None
    one_block = fused_nonlinear_tile_rows(d, h1, n_obs) is not None
    for resident in (True, False):
        for c in (1,) if one_block else _CLUSTER_RANKS:
            plan = _block_plan(d, h1, n_obs, c, resident) if d >= c else None
            if plan is not None:
                return NonlinearPlan(c, *plan)
    return None


# ---------------------------------------------------------------------------
# plain PyTorch version (explicit particle and sample axes)
# ---------------------------------------------------------------------------


def fused_nonlinear_plain(scores, w1t, l1, b1t, w2t, x, w, *, seed, streams,
                          alpha, tau, n_samples, model, eps=None,
                          particle_offset=0):
    """Plain version of kernel #8, in its layout: returns ``(d scores [P, d,
    d], dW1 [P, h1, d, d], small [P, 2 h1 + 1, d])`` (``small`` holds the
    ``db1``, ``dW2`` and ``db2`` rows), before the outside prior terms.
    One pass over the samples in chunks with the kernel's online softmax.
    A fleet's ``x, w [B_ds, N, d]`` with its ``[B_ds]`` keys: each dataset
    in turn. ``particle_offset``: the global index of particle 0 (a
    particle shard's first)."""
    check_offset(seed, particle_offset)
    if x.dim() == 3:
        return per_dataset(fused_nonlinear_plain, 5, scores, w1t, l1, b1t,
                           w2t, x, w, seed=seed, streams=streams, alpha=alpha,
                           tau=tau, n_samples=n_samples, model=model, eps=eps)
    p, d, _ = scores.shape
    h1 = w1t.shape[1]
    act, dact = ACTIVATIONS[model.activation], _DACTS[model.activation]
    dev = scores.device
    eps_s, eps_h = _noise((p, n_samples, d, d), seed, streams, eps, dev,
                          particle_offset)
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


def _chunk(p: int, n_samples: int, n_sms: int) -> int:
    """Samples per block: the (particle, chunk) grid fills one wave of the
    blocks the card holds at once, one an SM (a block's 512 threads take
    the SM's registers), never more, so no second wave of a few blocks
    doubles the time. A plan of ``ranks`` blocks a particle passes
    ``P x ranks``."""
    splits = max(1, min(n_samples // _MIN_CHUNK, n_sms // max(p, 1)))
    return -(-n_samples // splits)


def _launch(scores, w1t, l1, b1t, w2t, x, w, *, seed, streams, alpha, tau,
            n_samples, model, eps, particle_offset=0):
    name = "fused_nonlinear"
    p, d, d2 = scores.shape
    h1 = w1t.shape[1]
    lead = tuple(x.shape[:-2])  # a fleet's [B_ds]
    n_obs = x.shape[-2]
    keys, per = _fleet_keys(name, seed, x, p, scores.device)
    check_offset(seed, particle_offset)
    shapes = {"w1t": (w1t, (p, h1, d, d)), "l1": (l1, (p, d, d)),
              "b1t": (b1t, (p, h1, d)), "w2t": (w2t, (p, h1 + 1, d)),
              "x": (x, (*lead, n_obs, d)), "w": (w, (*lead, n_obs, d))}
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
    reason = fused_nonlinear_decline_reason(model, n_obs, scores.device)
    if reason is not None or model.hidden_layers[0] != h1 \
            or model.n_vars != d:
        raise ValueError(f"{name}: the kernel does not serve this model: "
                         f"{reason or 'model and tensors disagree'}")
    plan = fused_nonlinear_plan(d, h1, n_obs)
    if plan is None:
        raise ValueError(f"{name}: no plan fits d={d}, h1={h1}, N={n_obs}")
    ranks = plan.ranks
    chunk = _chunk(p * ranks, n_samples, torch.cuda.get_device_properties(
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
    launch = (lib.dibs_fused_nonlinear_fleet if keys is not None
              else lib.dibs_fused_nonlinear_shard if particle_offset
              else lib.dibs_fused_nonlinear)
    with torch.cuda.device(scores.device):
        rc = launch(
            scores.data_ptr(), w1t.data_ptr(), l1.data_ptr(), b1t.data_ptr(),
            w2t.data_ptr(), x.data_ptr(), w.data_ptr(),
            None if keys is None else keys.data_ptr(), per,
            particle_offset & 0xFFFFFFFF, *eps_ptrs,
            ref.data_ptr(), part.data_ptr(), ds.data_ptr(), dw1.data_ptr(),
            small.data_ptr(), p, n_samples, d, h1, n_obs, ranks,
            plan.tile_rows, plan.sub_rows, plan.group, chunk,
            _ACT_CODES[model.activation],
            0 if keys is not None else seed & 0xFFFFFFFFFFFFFFFF,
            streams[0] & 0xFFFFFFFF, streams[1] & 0xFFFFFFFF, float(alpha),
            float(tau), 1.0 / model.obs_noise,
            1.0 / (model.sig_param * model.sig_param),
            _stream(scores.device))
    _check_launch(lib, rc, name)
    if ranks > 1:  # the cluster build's launches and blocks a particle
        count("fused_nl_cluster.calls", 1)
        count("fused_nl_cluster.ranks", ranks)
    return ds, dw1, small


def fused_nonlinear(scores, w1t, l1, b1t, w2t, x, w, *, seed, streams, alpha,
                    tau, n_samples, model, eps=None, particle_offset=0):
    """Kernel #8 in its layout (see :func:`fused_nonlinear_plain`)."""
    kw = dict(seed=seed, streams=streams, alpha=alpha, tau=tau,
              n_samples=n_samples, model=model, eps=eps,
              particle_offset=particle_offset)
    if not use_kernel(scores):
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
                               alpha, tau, n_samples, model, eps=None,
                               particle_offset: int = 0):
    """``(d scores [P, d, d], d Theta tree)``: the fused reparam
    Z-likelihood and Theta-likelihood estimates for a one-hidden-layer
    :class:`~dibs_tpu_torch.models.DenseNonlinearGaussian`. The caller
    chains ``d scores`` to ``Z`` with ``dU = dS V``, ``dV = dS^T U``. A
    fleet passes ``x`` and ``interv_mask`` ``[B_ds, N, d]``, the particles
    in dataset order and ``seed`` its ``[B_ds]`` keys. A particle shard
    passes its first particle's global index as ``particle_offset``."""
    scores = edge_scores(zs).contiguous()
    w = (1.0 - interv_mask.to(torch.float32)).contiguous()
    ds, dw1, small = fused_nonlinear(
        scores, *kernel_layout(thetas, model), x.contiguous(), w,
        seed=seed if isinstance(seed, torch.Tensor) else int(seed),
        streams=tuple(int(s) for s in streams),
        alpha=float(alpha), tau=float(tau), n_samples=n_samples, model=model,
        eps=eps, particle_offset=int(particle_offset))
    return ds, _model_layout(thetas, model, dw1, small)
