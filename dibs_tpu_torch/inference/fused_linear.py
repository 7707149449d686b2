"""Fused sample-and-score estimators for the linear-Gaussian likelihood
(PyTorch twin of ``dibs_tpu/inference/fused_linear.py``).

For ``JointDiBS`` with :class:`~dibs_tpu_torch.models.LinearGaussian` and the
reparameterization estimator, one call computes both likelihood gradients

    d scores = sum_m softmax(l_soft)_m grad_scores l_soft_m      (reparam)
    d Theta  = sum_m softmax(l_hard)_m grad_Theta  l_hard_m

without storing a graph sample. Maths (reference ``fused_linear.py:40-45``):

    l(G)   = sum w_nj logN(x_nj; (x @ (G * Theta))_nj, sigma) + sum G logN(Theta)
    dl/dW  = x^T (resid / sigma^2),  W = G * Theta
    dl/dG  = Theta * dl/dW + logN(Theta),  dl/dTheta = G * dl/dW + G (mu_e - Theta) / sig_e^2
    dG_soft/d scores = tau alpha G (1 - G)

Every sample is scored relative to the expected graph ``E[G] = sigmoid(alpha
s)`` (centred scoring): ``resid_ref = x - x @ (E[G] * Theta)`` once per
particle, then per sample only ``delta = x @ ((G - E[G]) * Theta)``, with
``dll = -(1/2 sigma^2) sum w delta (delta - 2 resid_ref) + sum (G - E[G])
logN(Theta)`` and ``resid = (resid_ref - delta) w``. The softmax is
shift-invariant, so the dropped reference log-likelihood never matters. The
per-sample sums of ``dll`` are taken in float64 by the kernels and by the
plain versions alike.

Three hand-written CUDA kernels of one source (``csrc/fused_linear.cu``):

* ``fused_linear_single`` (replaces ``_fused_single``): one pass with an
  online softmax per particle (running max and normaliser per stream);
* ``fused_linear_pass1`` (replaces ``_fused_pass1``): the ``[P, M]`` soft and
  hard ``dll``; the softmax weights are formed in PyTorch;
* ``fused_linear_pass2`` (replaces ``_fused_pass2``): replays the same
  samples with those weights into ``d scores`` and ``d Theta``.

These are one template, the row tier (``fused_linear_kernel``): a block
keeps its particle's ``[d, d]`` matrices in shared memory and works on
groups of up to 4 samples with register-tiled products, sized by
:func:`fused_linear_row_plan`; the gate (:func:`fused_linear_tile_rows`)
serves ``d <= 70``. Past it ``fused_linear_pass1`` / ``fused_linear_pass2`` launch
the wide tier (same source; launches counted as ``fused_linear_wide_pass1``
/ ``fused_linear_wide_pass2``), which computes the two passes per tile of 8
node columns: the linear SEM factorizes over columns, so a pass-2 block
keeps ``[d, 8]`` slabs (the gate, :func:`fused_linear_wide_tile_rows`:
``d <= 602``). Pass 1 (``fused_linear_wide_pass1_kernel``: groups of up to
4 samples, register-tiled products over a transposed data tile, sized by
:func:`fused_linear_wide_pass1_plan`) writes float64 partial
log-likelihoods per column tile, summed in a fixed order before the softmax.
Pass 2 (``fused_linear_wide_kernel``, sized by
:func:`fused_linear_wide_pass2_plan`) replays only the samples with a
non-zero weight over the same transposed tile.
Both ``single_pass`` settings take the two passes there (the same
estimand). While a profiler records (:mod:`dibs_tpu_torch.profiling`),
each wide pass-2 call adds the (particle, sample) pairs it replays (their
two weights not both exactly 0) to the counter ``wide_pass2.replayed``
(counted by the kernel; by the plain version, at the shapes the wide tier
serves, from the weights) and itself to ``wide_pass2.calls``.

Noise: soft samples ``sigmoid(tau (eps + alpha s))`` draw their Logistic
``eps`` from the counter-based stream ``(seed, streams[0])``, hard samples
``1[eps + alpha s > 0]`` from ``(seed, streams[1])`` (equal streams give the
hard sample as the threshold of the soft sample's noise), or the injected
pair ``eps = (eps_soft, eps_hard)`` of ``[P, M, d, d]``. Dispatch
(:func:`~dibs_tpu_torch.ops.gpu_kernels.use_kernel`): a CUDA tensor goes to
the kernels, a CPU tensor (or any, with the kill switch off) to the plain
versions in this module, which take the same noise.

A fleet (:mod:`dibs_tpu_torch.fleet`) passes ``B_ds`` datasets at once: ``x``
and ``w`` ``[B_ds, N, d]``, the particles in dataset order and ``seed`` the
``[B_ds]`` int64 keys. The kernels of both tiers then read each
particle's dataset and key in the same launch (particle counter: the index
within the dataset; the wide passes' ``kFleet`` builds past d = 70); the
plain versions run on each dataset's slice in turn.

A particle shard (:mod:`dibs_tpu_torch.parallel`) passes its first
particle's global index as ``particle_offset``: its particles draw at
those counters, bitwise their part of one launch over the whole batch. A
non-zero offset launches the shard build of the same kernels
(``csrc/fused_linear_shard.cu``), so the other builds compile as without
it.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from dibs_tpu_torch import profiling
from dibs_tpu_torch.ops.edges import edge_scores
from dibs_tpu_torch.ops.gpu_kernels import (
    _check_cuda,
    _check_launch,
    _stream,
    build,
    check_offset,
    fleet_keys,
    fleet_particles,
    philox_uniform,
    use_kernel,
)

__all__ = [
    "fused_linear_available",
    "fused_linear_tile_rows",
    "fused_linear_smem_bytes",
    "fused_linear_estimators",
    "fused_linear_estimators_plain",
    "fused_linear_single",
    "fused_linear_single_plain",
    "fused_linear_pass1",
    "fused_linear_pass1_plain",
    "fused_linear_pass2",
    "fused_linear_pass2_plain",
    "fused_linear_row_items",
    "fused_linear_row_plan",
    "fused_linear_row_smem_bytes",
    "fused_linear_wide_tile_rows",
    "fused_linear_wide_smem_bytes",
    "fused_linear_wide_pass1_group",
    "fused_linear_wide_pass1_plan",
    "fused_linear_wide_pass1_smem_bytes",
    "fused_linear_wide_pass1_tile_rows",
    "fused_linear_wide_pass2_plan",
    "fused_linear_wide_pass2_smem_bytes",
]

# the kernel's shared-memory footprint (csrc/fused_linear.cu: smem_bytes)
_MAX_SMEM = 232448  # 227 KB, the most one block can use on Hopper
_RED_BYTES = 8 * (2 * 8 + 2)
_TILE_MAX, _TILE_MIN = 128, 8
# the row-tier kernel's plan (csrc/fused_linear.cu: row_smem_bytes): the
# float64 slots and group head (1,152 bytes), groups of up to 4 samples,
# x^T resid chunks of up to 64 rows, at most 4 register tiles of x^T resid a
# thread; the grid fills one wave of the blocks an SM holds (one, or two
# where a block leaves room for a second in the SM's 228 KB)
_ROW_HEAD = 8 * (2 * 8 * 8 + 8) + 64
_ROW_GROUPS, _ROW_SUBS, _ROW_MAX_ITEMS = (4, 2, 1), (64, 32), 4
# samples per step of the plain versions' loop (bounds their memory)
_PLAIN_CHUNK = 16
_MODES = {"fused_linear_single": 0, "fused_linear_pass1": 1,
          "fused_linear_pass2": 2, "fused_linear_wide_pass1": 3,
          "fused_linear_wide_pass2": 4}
_WIDE_COLS = 8  # node columns per wide-tier block
# wide pass 1: two blocks share an SM's 228 KB (1 KB reserved per block)
_TWO_PER_SM = 233472 // 2 - 1024


def fused_linear_smem_bytes(d: int, tile_rows: int) -> int:
    """Shared memory of one kernel block: 11 ``[d, d]`` matrices, 5 data
    tiles of ``tile_rows`` rows and the block-reduction slots."""
    return _RED_BYTES + 4 * (11 * d * d + 5 * tile_rows * d)


def fused_linear_tile_rows(d: int, n_obs: int) -> Optional[int]:
    """Data rows per shared-memory tile for ``(d, N)``, or ``None`` where
    the kernel does not fit: tiles of up to 128 rows (all ``N`` rows stay
    resident when ``N <= 128``), halved down to 8 until the block fits in
    227 KB. ``N`` is unbounded; ``d`` is bounded by ``11 d^2 + 40 d``
    floats, i.e. ``d <= 70``."""
    tile = min(n_obs, _TILE_MAX)
    while fused_linear_smem_bytes(d, tile) > _MAX_SMEM and tile > _TILE_MIN:
        tile = max(_TILE_MIN, tile // 2)
    return tile if fused_linear_smem_bytes(d, tile) <= _MAX_SMEM else None


def fused_linear_row_smem_bytes(d: int, tile_rows: int, group: int,
                                sub_rows: int) -> int:
    """Shared memory of one row-tier block (``csrc/fused_linear.cu:
    row_smem_bytes``): the float64 slots and group head, the group's ``A``
    (later ``x^T resid``) ``[d][2 group][dp]``, the transposed data tile
    ``[d][ldn]``, the data, ``w`` and ``resid_ref`` tiles ``[ldn][dp]``, the
    residuals of one chunk ``[2 group][sub_rows][dp]``, and ``6 + 2 group``
    ``[d, d]`` matrices (alpha s, E[G], Theta, logN(Theta), the two
    accumulators, the group's soft and hard samples); ``dp`` and ``ldn`` are
    ``d`` and ``tile_rows`` rounded up to 4."""
    dp, ldn, nc = -(-d // 4) * 4, -(-tile_rows // 4) * 4, 2 * group
    return _ROW_HEAD + 4 * (nc * d * dp + d * ldn + 3 * ldn * dp
                            + nc * sub_rows * dp + (6 + nc) * d * d)


def fused_linear_row_items(d: int, group: int) -> int:
    """4 x 4 tiles of ``x^T resid`` a thread holds in registers
    (``row_items``): the ``(dp / 4)^2`` tiles of one (sample, branch) over
    its team of ``256 / (2 group)`` threads."""
    dq, team = -(-d // 4), 256 // (2 * group)
    return -(-dq * dq // team)


class RowPlan(NamedTuple):
    """The launch of the row-tier kernel for ``(P, d, N, M)``."""
    tile_rows: int
    group: int  # samples a group
    sub_rows: int  # rows of an x^T resid chunk
    smem_bytes: int
    grid: Tuple[int, int]  # (particles, sample chunks)
    chunk: int  # samples a block


def _halvings(n_obs):
    """The gate's tile rows: ``min(N, 128)``, halved down to 8."""
    tile = min(n_obs, _TILE_MAX)
    out = [tile]
    while tile > _TILE_MIN:
        tile = max(_TILE_MIN, tile // 2)
        out.append(tile)
    return out


@functools.lru_cache(maxsize=None)  # once a shape: the engine calls it a step
def fused_linear_row_plan(n_particles: int, d: int, n_obs: int,
                          n_samples: int, sms: int) -> Optional[RowPlan]:
    """Tile rows, group, chunk rows, footprint, grid and samples a block of
    the row-tier kernel on a card of ``sms`` SMs (``None`` where nothing
    fits 227 KB). Of the (group, tile, chunk) that fit, with at most 4
    register tiles a thread, it takes the one that keeps tiles of at least
    ``min(N, 32)`` rows, then two blocks an SM, then the largest group, chunk
    and tile, in that order. The grid is one wave: ``blocks an SM x sms``
    blocks over the particles, each a multiple of ``group`` samples. It fits
    wherever :func:`fused_linear_tile_rows` admits ``(d, N)``
    (``tests/test_torch_fused_linear_row.py``)."""
    best = None
    for group in _ROW_GROUPS:
        if fused_linear_row_items(d, group) > _ROW_MAX_ITEMS:
            continue
        for tile in _halvings(n_obs):
            ldn = -(-tile // 4) * 4
            for sub in sorted({min(s, ldn) for s in _ROW_SUBS}):
                smem = fused_linear_row_smem_bytes(d, tile, group, sub)
                if smem > _MAX_SMEM:
                    continue
                per_sm = 2 if smem <= _TWO_PER_SM else 1
                key = (min(tile, 32), per_sm, group, sub, tile)
                if best is None or key > best[0]:
                    best = (key, (tile, group, sub, smem, per_sm))
    if best is None:
        return None
    tile, group, sub, smem, per_sm = best[1]
    splits = max(1, per_sm * sms // max(n_particles, 1))
    chunk = -(-n_samples // splits)
    chunk = -(-chunk // group) * group
    return RowPlan(tile, group, sub, smem,
                   (n_particles, -(-n_samples // chunk)), chunk)


def fused_linear_wide_smem_bytes(d: int, tile_rows: int) -> int:
    """The wide tier's gate measure (``csrc/fused_linear.cu:
    wide_smem_bytes``): the footprint of the tier's first pass-2 block, 11
    ``[d, 8]`` column slabs, 4 ``[tile_rows, 8]`` tiles, the data tile (rows
    padded to an odd stride) and the block-reduction slots. Both passes now
    launch with smaller plans of their own; the gate keeps this measure so
    that the served shapes do not change."""
    return _RED_BYTES + 4 * (11 * d * _WIDE_COLS + 4 * tile_rows * _WIDE_COLS
                             + tile_rows * (d | 1))


def fused_linear_wide_tile_rows(d: int, n_obs: int) -> Optional[int]:
    """Data rows per shared-memory tile of the wide tier for ``(d, N)``, or
    ``None`` where it does not fit: the row tier's rule over the smaller
    column-slab footprint, which serves ``d <= 602`` for any ``N``."""
    tile = min(n_obs, _TILE_MAX)
    while fused_linear_wide_smem_bytes(d, tile) > _MAX_SMEM and \
            tile > _TILE_MIN:
        tile = max(_TILE_MIN, tile // 2)
    return tile if fused_linear_wide_smem_bytes(d, tile) <= _MAX_SMEM else None


def fused_linear_wide_pass1_smem_bytes(d: int, tile_rows: int,
                                       group: int) -> int:
    """Shared memory of one wide pass-1 block (``csrc/fused_linear.cu:
    wide1_smem_bytes``): the float64 partial slots (two parities of 8 warps
    and ``ldn / 8`` row blocks, ``2 group`` each), 4 ``[d, 8]`` slabs
    (alpha s, E[G], Theta, logN(Theta)), the ``w`` and ``resid_ref`` tiles
    ``[ldn, 8]``, the transposed data tile ``[d, ldn]`` and the group's two
    branches of ``[d, 8]`` slabs; ``ldn`` is ``tile_rows`` rounded up to 8."""
    ldn = -(-tile_rows // 8) * 8
    return (8 * 4 * group * (8 + ldn // 8)
            + 4 * (4 * _WIDE_COLS * d + 2 * _WIDE_COLS * ldn + d * ldn
                   + 2 * _WIDE_COLS * group * d))


def fused_linear_wide_pass1_group(d: int, tile_rows: int) -> int:
    """Samples per group of wide pass 1 (``wide1_group``): the largest of 4,
    2, 1 whose footprint leaves two blocks an SM, else 1."""
    for group in (4, 2):
        if fused_linear_wide_pass1_smem_bytes(d, tile_rows, group) <= \
                _TWO_PER_SM:
            return group
    return 1


def fused_linear_wide_pass1_tile_rows(d: int, n_obs: int) -> Optional[int]:
    """Data rows per tile of wide pass 1, or ``None`` where it does not fit:
    up to 128 rows, halved down to 8 while the block (with its group) does
    not leave two blocks an SM; at most 227 KB. Serves every ``(d, N)`` the
    wide tier serves."""
    def footprint(tile):
        return fused_linear_wide_pass1_smem_bytes(
            d, tile, fused_linear_wide_pass1_group(d, tile))

    tile = min(n_obs, _TILE_MAX)
    while footprint(tile) > _TWO_PER_SM and tile > _TILE_MIN:
        tile = max(_TILE_MIN, tile // 2)
    return tile if footprint(tile) <= _MAX_SMEM else None


class WidePass1Plan(NamedTuple):
    """The launch of wide pass 1 for ``(P, d, N)``."""
    tile_rows: int
    group: int
    smem_bytes: int
    grid: Tuple[int, int]  # (particles, column tiles)


def fused_linear_wide_pass1_plan(n_particles: int, d: int,
                                 n_obs: int) -> Optional[WidePass1Plan]:
    """Tile rows, group, footprint and grid of wide pass 1 (``None`` where
    it does not fit)."""
    tile = fused_linear_wide_pass1_tile_rows(d, n_obs)
    if tile is None:
        return None
    group = fused_linear_wide_pass1_group(d, tile)
    return WidePass1Plan(tile, group,
                         fused_linear_wide_pass1_smem_bytes(d, tile, group),
                         (n_particles, -(-d // _WIDE_COLS)))


def fused_linear_wide_pass2_smem_bytes(d: int, tile_rows: int) -> int:
    """Shared memory of one wide pass-2 block (``csrc/fused_linear.cu:
    wide2_smem_bytes``): 10 ``[d, 8]`` slabs (alpha s, Theta, the two
    branches' ``(G - E[G]) Theta``, the soft and hard samples, the two
    branches' ``x^T resid`` and the two accumulators), the ``w`` and
    ``resid_ref`` tiles ``[ldn, 8]``, the two branches' weighted residuals
    ``[ldn, 16]`` and the transposed data tile ``[d, ldn]``; ``ldn`` is
    ``tile_rows`` rounded up to 4, then to 4 mod 8 (conflict-free stores of
    the transposed tile)."""
    ldn = -(-tile_rows // 4) * 4 | 4
    return 4 * (10 * _WIDE_COLS * d + 4 * _WIDE_COLS * ldn + d * ldn)


class WidePass2Plan(NamedTuple):
    """The launch of wide pass 2 for ``(P, d, N)``."""
    tile_rows: int
    smem_bytes: int
    grid: Tuple[int, int]  # (particles, column tiles)


def fused_linear_wide_pass2_plan(n_particles: int, d: int,
                                 n_obs: int) -> Optional[WidePass2Plan]:
    """Tile rows, footprint and grid of wide pass 2 (``None`` where it does
    not fit): up to 128 rows, halved down to 8 while two blocks do not
    share an SM; at most 227 KB. It fits at every ``(d, N)`` the wide
    tier's gate serves (``tests/test_torch_wide_pass2.py``)."""
    tile = min(n_obs, _TILE_MAX)
    while fused_linear_wide_pass2_smem_bytes(d, tile) > _TWO_PER_SM and \
            tile > _TILE_MIN:
        tile = max(_TILE_MIN, tile // 2)
    smem = fused_linear_wide_pass2_smem_bytes(d, tile)
    if smem > _MAX_SMEM:
        return None
    return WidePass2Plan(tile, smem, (n_particles, -(-d // _WIDE_COLS)))


def fused_linear_available(n_vars: int, n_obs: int) -> bool:
    """True when the fused kernels serve ``d = n_vars`` and ``N = n_obs``:
    the row tier (kernels #5-#7, ``d <= 70``) or the wide tier."""
    return n_vars >= 1 and n_obs >= 1 and (
        fused_linear_tile_rows(n_vars, n_obs) is not None
        or fused_linear_wide_tile_rows(n_vars, n_obs) is not None)


# ---------------------------------------------------------------------------
# plain PyTorch versions (explicit particle and sample axes)
# ---------------------------------------------------------------------------


def _logistic(shape, seed, stream, device, particle_offset=0):
    u = philox_uniform(shape, seed, stream, device, particle_offset)
    return torch.log(u) - torch.log1p(-u)


def _noise(shape, seed, streams, eps, device, particle_offset=0):
    """``(eps_soft, eps_hard)``: the injected pair or the kernels' Philox
    draws (one draw when the two streams are equal), particle ``b`` at the
    counter ``particle_offset + b``."""
    if eps is not None:
        return eps
    eps_soft = _logistic(shape, seed, streams[0], device, particle_offset)
    if streams[1] == streams[0]:
        return eps_soft, eps_soft
    return eps_soft, _logistic(shape, seed, streams[1], device,
                               particle_offset)


class _Particles:
    """Per-particle quantities hoisted out of the sample loop."""

    def __init__(self, scores, thetas, x, w, alpha, tau, model):
        d = scores.shape[-1]
        self.offdiag = 1.0 - torch.eye(d, dtype=scores.dtype,
                                       device=scores.device)
        self.alpha_s = alpha * scores
        self.sig = torch.sigmoid(self.alpha_s) * self.offdiag  # E[G]
        self.thetas, self.x, self.w = thetas, x, w
        self.alpha, self.tau = alpha, tau
        self.inv_var = 1.0 / model.obs_noise
        z = (thetas - model.mean_edge) / model.sig_edge
        self.logpdf = (-0.5 * z * z - math.log(model.sig_edge)
                       - 0.5 * math.log(2.0 * math.pi))
        self.dprior = (model.mean_edge - thetas) / model.sig_edge ** 2
        self.resid_ref = x - x @ (self.sig * thetas)  # [P, N, d]

    def samples(self, eps_soft, eps_hard):
        """Soft and hard samples ``[P, m, d, d]`` from a chunk of noise."""
        a_s = self.alpha_s[:, None]
        g_soft = torch.sigmoid(self.tau * (eps_soft + a_s)) * self.offdiag
        g_hard = ((eps_hard + a_s) > 0.0).to(eps_hard.dtype) * self.offdiag
        return g_soft, g_hard

    def dll(self, g):
        """Centred log-likelihoods ``[P, m]`` (float64 sums)."""
        dg = g - self.sig[:, None]
        delta = self.x @ (dg * self.thetas[:, None])  # [P, m, N, d]
        rr = self.resid_ref[:, None]
        data = (self.w * delta * (delta - 2.0 * rr)).double().sum((-2, -1))
        prior = (dg * self.logpdf[:, None]).double().sum((-2, -1))
        return (-0.5 * self.inv_var * data + prior).float()

    def _dw(self, g):
        delta = self.x @ ((g - self.sig[:, None]) * self.thetas[:, None])
        resid = (self.resid_ref[:, None] - delta) * self.w
        return self.x.T @ resid  # [P, m, d, d]

    def contributions(self, g_soft, g_hard):
        """Per-sample gradient contributions to ``d scores`` and ``d Theta``."""
        th, lp = self.thetas[:, None], self.logpdf[:, None]
        c_soft = (self.tau * self.alpha * g_soft * (1.0 - g_soft)
                  * (th * (self._dw(g_soft) * self.inv_var) + lp))
        c_hard = g_hard * (self._dw(g_hard) * self.inv_var
                           + self.dprior[:, None])
        return c_soft, c_hard


def _chunks(n_samples):
    return [(m0, min(m0 + _PLAIN_CHUNK, n_samples))
            for m0 in range(0, n_samples, _PLAIN_CHUNK)]


def per_dataset(plain, n_particle_args, *args, seed, eps=None, **kw):
    """A fleet's call of a plain version: ``plain`` on each dataset's slice
    in turn (its particles' first ``n_particle_args`` arguments, ``x[i]``
    and ``w[i]``, each further argument a tuple of per-particle tensors,
    its key and noise), the outputs concatenated over the particles."""
    lead, (x, w), rest = (args[:n_particle_args],
                          args[n_particle_args:n_particle_args + 2],
                          args[n_particle_args + 2:])
    keys = seed.reshape(-1).tolist()
    per = fleet_particles(lead[0].shape[0], len(keys))
    outs = []
    for i, key in enumerate(keys):
        sl = slice(i * per, (i + 1) * per)
        outs.append(plain(
            *(t[sl] for t in lead), x[i], w[i],
            *(tuple(t[sl] for t in r) for r in rest), seed=key,
            eps=None if eps is None else tuple(e[sl] for e in eps), **kw))
    return tuple(torch.cat(o) for o in zip(*outs))


def _fleet(x) -> bool:
    return x.dim() == 3


def fused_linear_pass1_plain(scores, thetas, x, w, *, seed, streams, alpha,
                             tau, n_samples, model, eps=None,
                             particle_offset=0):
    """Plain version of kernel #6: ``(dll_soft, dll_hard)``, each ``[P, M]``
    (a fleet's ``x, w [B_ds, N, d]``: each dataset in turn)."""
    if _fleet(x):
        return per_dataset(fused_linear_pass1_plain, 2, scores, thetas, x, w,
                           seed=seed, streams=streams, alpha=alpha, tau=tau,
                           n_samples=n_samples, model=model, eps=eps)
    p, d, _ = scores.shape
    eps_s, eps_h = _noise((p, n_samples, d, d), seed, streams, eps,
                          scores.device, particle_offset)
    part = _Particles(scores, thetas, x, w, alpha, tau, model)
    ll_s, ll_h = [], []
    for m0, m1 in _chunks(n_samples):
        g_soft, g_hard = part.samples(eps_s[:, m0:m1], eps_h[:, m0:m1])
        ll_s.append(part.dll(g_soft))
        ll_h.append(part.dll(g_hard))
    return torch.cat(ll_s, dim=1), torch.cat(ll_h, dim=1)


def fused_linear_pass2_plain(scores, thetas, x, w, weights, *, seed, streams,
                             alpha, tau, n_samples, model, eps=None,
                             particle_offset=0):
    """Plain version of kernel #7: replays the samples with the softmax
    ``weights = (w_soft, w_hard)`` ``[P, M]``; returns ``(d scores, d Theta)``
    (a fleet: each dataset in turn)."""
    if _fleet(x):
        return per_dataset(fused_linear_pass2_plain, 2, scores, thetas, x, w,
                           weights, seed=seed, streams=streams, alpha=alpha,
                           tau=tau, n_samples=n_samples, model=model, eps=eps)
    p, d, _ = scores.shape
    eps_s, eps_h = _noise((p, n_samples, d, d), seed, streams, eps,
                          scores.device, particle_offset)
    part = _Particles(scores, thetas, x, w, alpha, tau, model)
    w_soft, w_hard = weights
    acc_s = torch.zeros_like(scores)
    acc_h = torch.zeros_like(scores)
    for m0, m1 in _chunks(n_samples):
        c_s, c_h = part.contributions(
            *part.samples(eps_s[:, m0:m1], eps_h[:, m0:m1]))
        acc_s = acc_s + torch.einsum("pm,pmij->pij", w_soft[:, m0:m1], c_s)
        acc_h = acc_h + torch.einsum("pm,pmij->pij", w_hard[:, m0:m1], c_h)
    return acc_s, acc_h


def fused_linear_single_plain(scores, thetas, x, w, *, seed, streams, alpha,
                              tau, n_samples, model, eps=None,
                              particle_offset=0):
    """Plain version of kernel #5: one pass over the samples in chunks with
    the kernel's online softmax; returns ``(d scores, d Theta)`` (a fleet:
    each dataset in turn)."""
    if _fleet(x):
        return per_dataset(fused_linear_single_plain, 2, scores, thetas, x, w,
                           seed=seed, streams=streams, alpha=alpha, tau=tau,
                           n_samples=n_samples, model=model, eps=eps)
    p, d, _ = scores.shape
    eps_s, eps_h = _noise((p, n_samples, d, d), seed, streams, eps,
                          scores.device, particle_offset)
    part = _Particles(scores, thetas, x, w, alpha, tau, model)
    neg_inf = torch.full((p,), -math.inf, device=scores.device)
    state = {"soft": [neg_inf, torch.zeros(p, device=scores.device),
                      torch.zeros_like(scores)],
             "hard": [neg_inf, torch.zeros(p, device=scores.device),
                      torch.zeros_like(scores)]}
    for m0, m1 in _chunks(n_samples):
        g_soft, g_hard = part.samples(eps_s[:, m0:m1], eps_h[:, m0:m1])
        c_s, c_h = part.contributions(g_soft, g_hard)
        for key, g, c in (("soft", g_soft, c_s), ("hard", g_hard, c_h)):
            run_max, norm, acc = state[key]
            ll = part.dll(g)
            new_max = torch.maximum(run_max, ll.max(dim=1).values)
            scale = torch.exp(run_max - new_max)
            wts = torch.exp(ll - new_max[:, None])
            state[key] = [new_max, norm * scale + wts.sum(1),
                          acc * scale[:, None, None]
                          + torch.einsum("pm,pmij->pij", wts, c)]
    return (state["soft"][2] / state["soft"][1][:, None, None],
            state["hard"][2] / state["hard"][1][:, None, None])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _checked_ptrs(name, scores, thetas, x, w, n_samples, eps, weights):
    """Checks the inputs of a launch; returns the noise and weight
    pointers (``None`` where absent)."""
    p, d, d2 = scores.shape
    lead = tuple(x.shape[:-2])  # a fleet's [B_ds]
    n_obs = x.shape[-2]
    if d != d2 or tuple(thetas.shape) != (p, d, d) or len(lead) > 1 or \
            tuple(x.shape) != (*lead, n_obs, d) or \
            tuple(w.shape) != (*lead, n_obs, d):
        raise ValueError(f"{name}: bad shapes scores {tuple(scores.shape)}, "
                         f"thetas {tuple(thetas.shape)}, x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    _check_cuda(name, scores, thetas, x, w)
    eps_ptrs = (None, None)
    if eps is not None:
        _check_cuda(name, *eps)
        for e in eps:
            if tuple(e.shape) != (p, n_samples, d, d):
                raise ValueError(f"{name}: eps must be "
                                 f"{(p, n_samples, d, d)}, got "
                                 f"{tuple(e.shape)}")
        eps_ptrs = tuple(e.data_ptr() for e in eps)
    wts_ptrs = (None, None)
    if weights is not None:
        _check_cuda(name, *weights)
        for wt in weights:
            if tuple(wt.shape) != (p, n_samples):
                raise ValueError(f"{name}: weights must be "
                                 f"{(p, n_samples)}, got {tuple(wt.shape)}")
        wts_ptrs = tuple(wt.data_ptr() for wt in weights)
    return eps_ptrs, wts_ptrs


def _fleet_keys(name, seed, x, p, device):
    """``(keys, per)`` of a launch (:func:`~dibs_tpu_torch.ops.gpu_kernels.
    fleet_keys`); a fleet's data ``[B_ds, N, d]`` goes with its ``[B_ds]``
    keys, one dataset's ``[N, d]`` with an int seed."""
    keys, per = fleet_keys(name, seed, p, device)
    if (keys is None) == _fleet(x) or (
            keys is not None and x.shape[0] != keys.numel()):
        raise ValueError(f"{name}: data {tuple(x.shape)} and "
                         f"{'no keys' if keys is None else keys.numel()} "
                         "keys do not match")
    return keys, per


def _launch(name, scores, thetas, x, w, *, seed, streams, alpha, tau,
            n_samples, model, eps, weights=None, plan=None,
            particle_offset=0):
    """Launches the row-tier kernel; ``plan`` (a :class:`RowPlan`) replaces
    :func:`fused_linear_row_plan`'s, for timing other plans."""
    eps_ptrs, wts_ptrs = _checked_ptrs(name, scores, thetas, x, w, n_samples,
                                       eps, weights)
    p, d, _ = scores.shape
    n_obs = x.shape[-2]
    keys, per = _fleet_keys(name, seed, x, p, scores.device)
    check_offset(seed, particle_offset)
    if fused_linear_tile_rows(d, n_obs) is None:
        raise ValueError(f"{name}: d={d} exceeds the kernel's shared-memory "
                         "limit (fused_linear_available)")
    if plan is None:
        plan = fused_linear_row_plan(p, d, n_obs, n_samples,
                                     torch.cuda.get_device_properties(
                                         scores.device).multi_processor_count)
    n_split = plan.grid[1]
    lib = build()
    out_shape = (p, n_samples) if name == "fused_linear_pass1" else (p, d, d)
    empty = dict(dtype=torch.float32, device=scores.device)
    out_a, out_b = torch.empty(out_shape, **empty), torch.empty(out_shape,
                                                                **empty)
    resid_ref = (torch.empty((p, n_split, n_obs, -(-d // 4) * 4), **empty)
                 if plan.tile_rows < n_obs else None)
    part = torch.empty((p, n_split, 4 + 2 * d * d), **empty)
    # a shard's counters start at its offset: the DIBS_FL_SHARD build
    launch = (lib.dibs_fused_linear_shard if particle_offset
              else lib.dibs_fused_linear)
    with torch.cuda.device(scores.device):
        rc = launch(
            _MODES[name], scores.data_ptr(), thetas.data_ptr(), x.data_ptr(),
            w.data_ptr(), None if keys is None else keys.data_ptr(), per,
            particle_offset & 0xFFFFFFFF, *eps_ptrs, *wts_ptrs,
            None if resid_ref is None else resid_ref.data_ptr(),
            part.data_ptr(), out_a.data_ptr(), out_b.data_ptr(), p,
            n_samples, d, n_obs, plan.tile_rows, plan.chunk, plan.group,
            plan.sub_rows, 0 if keys is not None else
            seed & 0xFFFFFFFFFFFFFFFF, streams[0] & 0xFFFFFFFF,
            streams[1] & 0xFFFFFFFF, float(alpha), float(tau),
            1.0 / model.obs_noise, float(model.mean_edge),
            float(model.sig_edge), _stream(scores.device))
    _check_launch(lib, rc, name)
    return out_a, out_b


def _launch_wide(name, scores, thetas, x, w, *, seed, streams, alpha, tau,
                 n_samples, model, eps, weights=None, particle_offset=0):
    """Launches a wide-tier pass; a fleet's (``x, w [B_ds, N, d]``, ``seed``
    its keys) takes the passes' ``kFleet`` builds."""
    eps_ptrs, wts_ptrs = _checked_ptrs(name, scores, thetas, x, w, n_samples,
                                       eps, weights)
    p, d, _ = scores.shape
    n_obs = x.shape[-2]
    keys, per = _fleet_keys(name, seed, x, p, scores.device)
    check_offset(seed, particle_offset)
    tile_rows = fused_linear_wide_tile_rows(d, n_obs)
    if tile_rows is None:
        raise ValueError(f"{name}: d={d} exceeds the wide tier's shared-"
                         "memory limit (fused_linear_available)")
    # each pass has its own plan, which fits wherever the gate does
    if name == "fused_linear_wide_pass1":
        tile_rows = fused_linear_wide_pass1_tile_rows(d, n_obs)
    else:
        tile_rows = fused_linear_wide_pass2_plan(p, d, n_obs).tile_rows
    n_ct = -(-d // _WIDE_COLS)
    lib = build()
    dev = scores.device
    resid_ref = (torch.empty((p, n_ct, n_obs, _WIDE_COLS),
                             dtype=torch.float32, device=dev)
                 if tile_rows < n_obs else None)
    if name == "fused_linear_wide_pass1":
        dlls = [torch.empty((p, n_samples, n_ct), dtype=torch.float64,
                            device=dev) for _ in range(2)]
        outs = [None, None]
    else:
        dlls = [None, None]
        outs = [torch.empty((p, d, d), dtype=torch.float32, device=dev)
                for _ in range(2)]
    replayed = (None if name == "fused_linear_wide_pass1"
                else _replay_counter(dev))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    launch = (lib.dibs_fused_linear_wide_shard if particle_offset
              else lib.dibs_fused_linear_wide)
    with torch.cuda.device(dev):
        rc = launch(
            _MODES[name], scores.data_ptr(), thetas.data_ptr(), x.data_ptr(),
            w.data_ptr(), *eps_ptrs, *wts_ptrs, ptr(resid_ref),
            *map(ptr, dlls), *map(ptr, outs), p, n_samples, d, n_obs,
            tile_rows,
            0 if keys is not None else seed & 0xFFFFFFFFFFFFFFFF,
            particle_offset & 0xFFFFFFFF, streams[0] & 0xFFFFFFFF,
            streams[1] & 0xFFFFFFFF, float(alpha), float(tau),
            1.0 / model.obs_noise, float(model.mean_edge),
            float(model.sig_edge), _stream(dev), ptr(keys), per,
            ptr(replayed))
    _check_launch(lib, rc, name)
    if name == "fused_linear_wide_pass1":
        # the column tiles' float64 partials, summed in a fixed order
        return tuple(dll.sum(dim=-1).float() for dll in dlls)
    return tuple(outs)


def fused_linear_single(scores, thetas, x, w, *, seed, streams, alpha, tau,
                        n_samples, model, eps=None, particle_offset=0):
    """Kernel #5: ``[P, d, d]`` scores and ``Theta``, ``x, w [N, d]`` ->
    ``(d scores, d Theta)`` in one pass (online softmax)."""
    kw = dict(seed=seed, streams=streams, alpha=alpha, tau=tau,
              n_samples=n_samples, model=model, eps=eps,
              particle_offset=particle_offset)
    if not use_kernel(scores):
        return fused_linear_single_plain(scores, thetas, x, w, **kw)
    return _launch("fused_linear_single", scores, thetas, x, w, **kw)


def _row_tier(scores, x) -> bool:
    return fused_linear_tile_rows(scores.shape[-1], x.shape[-2]) is not None


def fused_linear_pass1(scores, thetas, x, w, *, seed, streams, alpha, tau,
                       n_samples, model, eps=None, particle_offset=0):
    """Kernel #6: the ``[P, M]`` soft and hard centred log-likelihoods (past
    the row tier, the wide tier's pass 1: float64 partials per column tile,
    summed in a fixed order)."""
    kw = dict(seed=seed, streams=streams, alpha=alpha, tau=tau,
              n_samples=n_samples, model=model, eps=eps,
              particle_offset=particle_offset)
    if not use_kernel(scores):
        return fused_linear_pass1_plain(scores, thetas, x, w, **kw)
    if _row_tier(scores, x):
        return _launch("fused_linear_pass1", scores, thetas, x, w, **kw)
    return _launch_wide("fused_linear_wide_pass1", scores, thetas, x, w, **kw)


def _replay_counter(device):
    """The counter ``wide_pass2.replayed`` while a profiler records (and
    one more ``wide_pass2.calls``), else ``None``."""
    replayed = profiling.counter("wide_pass2.replayed", 1, device)
    if replayed is not None:
        profiling.count("wide_pass2.calls", 1)
    return replayed


def fused_linear_pass2(scores, thetas, x, w, weights, *, seed, streams,
                       alpha, tau, n_samples, model, eps=None,
                       particle_offset=0):
    """Kernel #7: replays the samples of pass 1 with ``weights = (w_soft,
    w_hard)`` ``[P, M]`` -> ``(d scores, d Theta)`` (past the row tier, the
    wide tier's pass 2, per column tile)."""
    kw = dict(seed=seed, streams=streams, alpha=alpha, tau=tau,
              n_samples=n_samples, model=model, eps=eps,
              particle_offset=particle_offset)
    if not use_kernel(scores):
        replayed = None if _row_tier(scores, x) else _replay_counter(
            scores.device)
        if replayed is not None:  # the pairs the card's wide pass 2 replays
            replayed += ((weights[0] != 0) | (weights[1] != 0)).sum()
        return fused_linear_pass2_plain(scores, thetas, x, w, weights, **kw)
    if _row_tier(scores, x):
        return _launch("fused_linear_pass2", scores, thetas, x, w,
                       weights=weights, **kw)
    return _launch_wide("fused_linear_wide_pass2", scores, thetas, x, w,
                        weights=weights, **kw)


def _softmax_weights(lls):
    return tuple(torch.softmax(ll, dim=1) for ll in lls)


def _estimators(single, pass1, pass2, *, zs, thetas, x, interv_mask, seed,
                streams, alpha, tau, n_samples, model, eps, single_pass,
                particle_offset):
    check_offset(seed, particle_offset)
    scores = edge_scores(zs).contiguous()
    w = (1.0 - interv_mask.to(torch.float32)).contiguous()
    kw = dict(seed=seed if isinstance(seed, torch.Tensor) else int(seed),
              streams=tuple(int(s) for s in streams),
              alpha=float(alpha), tau=float(tau), n_samples=n_samples,
              model=model, eps=eps, particle_offset=int(particle_offset))
    thetas, x = thetas.contiguous(), x.contiguous()
    if single_pass and _row_tier(scores, x):
        return single(scores, thetas, x, w, **kw)
    weights = _softmax_weights(pass1(scores, thetas, x, w, **kw))
    return pass2(scores, thetas, x, w, weights, **kw)


def fused_linear_estimators(*, zs, thetas, x, interv_mask, seed, streams,
                            alpha, tau, n_samples, model,
                            eps: Optional[Tuple[torch.Tensor, ...]] = None,
                            single_pass: bool = True,
                            particle_offset: int = 0):
    """``(d scores [P, d, d], d Theta [P, d, d])``: the fused reparam
    Z-likelihood and Theta-likelihood estimates for ``LinearGaussian``.

    The caller chains ``d scores`` to ``Z`` with ``dU = dS V``,
    ``dV = dS^T U``. ``streams = (soft, hard)``; ``eps`` the injected
    ``(eps_soft, eps_hard)``. ``single_pass=False`` runs kernels #6 and #7
    with the softmax in between instead of kernel #5. Past ``d = 70`` both
    settings run the wide tier's two passes. A fleet passes ``x`` and
    ``interv_mask`` ``[B_ds, N, d]``, ``zs`` and ``thetas`` with the
    particles in dataset order and ``seed`` its ``[B_ds]`` keys (both
    tiers). A particle shard passes its first particle's global index as
    ``particle_offset``: its samples are those of its particles in one call
    over the whole batch.
    """
    return _estimators(fused_linear_single, fused_linear_pass1,
                       fused_linear_pass2, zs=zs, thetas=thetas, x=x,
                       interv_mask=interv_mask, seed=seed, streams=streams,
                       alpha=alpha, tau=tau, n_samples=n_samples, model=model,
                       eps=eps, single_pass=single_pass,
                       particle_offset=particle_offset)


def fused_linear_estimators_plain(*, zs, thetas, x, interv_mask, seed,
                                  streams, alpha, tau, n_samples, model,
                                  eps=None, single_pass: bool = True,
                                  particle_offset: int = 0):
    """:func:`fused_linear_estimators` through the plain versions on any
    device (the yardstick of the kernels)."""
    return _estimators(fused_linear_single_plain, fused_linear_pass1_plain,
                       fused_linear_pass2_plain, zs=zs, thetas=thetas, x=x,
                       interv_mask=interv_mask, seed=seed, streams=streams,
                       alpha=alpha, tau=tau, n_samples=n_samples, model=model,
                       eps=eps, single_pass=single_pass,
                       particle_offset=particle_offset)
