"""BGe determinant pairs for a whole hard-graph batch: the CUDA kernel
wrapper and its plain PyTorch twin.

Counterpart of ``dibs_tpu/ops/bge_kernel.py``. For every graph ``b`` and
node ``j``, with parent mask ``gs[b, :, j]`` and node ``j``'s posterior
matrix ``R_j``, it returns ``logdet R_j[Pa, Pa]`` and
``logdet R_j[Pa u j, Pa u j]`` from one bordered-Schur elimination (see
``csrc/bge_pairs.cu``; on the card each pair takes the route
:func:`dibs_tpu_torch.ops.gpu_kernels.bge_pairs_plan` names for its parent
count). Forward only: the REINFORCE estimators treat graph samples as
constants. Serves ``2 <= d <= 128``; an all-zero mask gives
``logdet_pa == 0``. A fleet (:mod:`dibs_tpu_torch.fleet`) passes one set of
posterior matrices a dataset, ``[B_ds, d, d, d]``, with its graphs in
dataset order: graph ``g`` reads the set of dataset ``g // (B / B_ds)``, in
one launch.

While a profiler records (:mod:`dibs_tpu_torch.profiling`), each call adds
its pairs to the counter ``bge_pairs.parents``, a histogram ``[d + 1]`` of
the parent count k (the kernel that reads each pair's parent set fills it
on the card; ``torch.bincount`` of the masks on the plain path), and its
graphs and itself to ``bge_pairs.graphs`` and ``bge_pairs.calls``.
"""
from __future__ import annotations

import ctypes

import torch

from dibs_tpu_torch import profiling
from dibs_tpu_torch.ops.gpu_kernels import (
    _check_cuda,
    _check_launch,
    _stream,
    bge_route_plans,
    build,
    use_kernel,
)

__all__ = ["BGE_MAX_D", "bge_logdet_pairs", "bge_logdet_pairs_plain"]

# the largest d the kernel serves (from d = 2), as in dibs_tpu
BGE_MAX_D = 128


def _dataset_sets(r_mats: torch.Tensor, b: int, d: int):
    """``r_mats`` as ``[B_ds, d, d, d]`` and the graphs a dataset; raises
    ``ValueError`` for any other shape or a batch that does not split."""
    if r_mats.dim() not in (3, 4) or tuple(r_mats.shape[-3:]) != (d, d, d):
        raise ValueError(f"r_mats must be {(d, d, d)} or [B_ds, {d}, {d}, "
                         f"{d}], got {tuple(r_mats.shape)}")
    sets = r_mats.reshape(-1, d, d, d)
    if b % sets.shape[0]:
        raise ValueError(f"{b} graphs do not split into {sets.shape[0]} "
                         "datasets")
    return sets, b // sets.shape[0]


def bge_logdet_pairs_plain(r_mats: torch.Tensor, gs: torch.Tensor):
    """Plain twin: the kernel's bordered-Schur sweep on ``[B, d, d, d]``
    masked matrices, one pivot per step over the whole batch, with the
    kernel's float32 operations in the kernel's order and the log-pivots
    summed in float64. ``r_mats`` is ``[d, d, d]`` or a fleet's ``[B_ds, d,
    d, d]`` (graph ``g`` of dataset ``g // (B / B_ds)``); every operation is
    elementwise per graph, so each dataset's pairs are bitwise those of a
    call on its graphs alone."""
    b, d, _ = gs.shape
    sets, gpd = _dataset_sets(r_mats, b, d)
    n_ds = sets.shape[0]
    m = gs.transpose(1, 2)  # [B, j, r]: parent mask of node j
    mm = m[..., :, None] * m[..., None, :]  # [B, j, r, c]
    eye = torch.eye(d, dtype=r_mats.dtype, device=r_mats.device)
    a = (sets[:, None] * mm.view(n_ds, gpd, d, d, d)
         + eye * (1.0 - mm.view(n_ds, gpd, d, d, d))).reshape(b, d, d, d)
    # [B_ds, j, r] = R_j[r, j] of each dataset
    r_col = sets.diagonal(dim1=1, dim2=3).transpose(-1, -2)
    v = (r_col[:, None] * m.reshape(n_ds, gpd, d, d)).reshape(b, d, d)
    s = sets.diagonal(dim1=1, dim2=2).diagonal(dim1=1, dim2=2)  # R_j[j, j]
    s = s[:, None].expand(n_ds, gpd, d).reshape(b, d)
    acc = torch.zeros((b, d), dtype=torch.float64, device=r_mats.device)
    for i in range(d):
        pivot = a[..., i, i]
        inv = 1.0 / pivot
        acc = acc + torch.log(pivot.double())
        vi = v[..., i]
        s = s - vi * vi * inv
        # in place on fresh tensors: the updated block never overlaps the
        # pivot row and column it reads
        colf = a[..., i + 1:, i] * inv[..., None]  # rows below the pivot
        v[..., i + 1:] -= colf * vi[..., None]
        a[..., i + 1:, i + 1:] -= colf[..., :, None] * a[..., i, None, i + 1:]
    return acc.float(), (acc + torch.log(s.double())).float()


def bge_logdet_pairs(r_mats: torch.Tensor, gs: torch.Tensor):
    """Batched BGe determinant pairs.

    Args:
        r_mats: ``[d, d, d]`` per-node posterior matrices ``R_j`` (PD), or
            a fleet's ``[B_ds, d, d, d]``, one set a dataset
        gs: ``[B, d, d]`` adjacency samples; node ``j``'s parents are the
            column ``gs[:, :, j]``; with ``B_ds`` sets, ``B / B_ds`` graphs
            a dataset, in dataset order

    Returns:
        ``(logdet_pa, logdet_full)``, each ``[B, d]``.
    """
    b, d, _ = gs.shape
    if not 2 <= d <= BGE_MAX_D:
        raise ValueError(f"bge_logdet_pairs serves 2 <= d <= {BGE_MAX_D}, "
                         f"got d={d}")
    _, gpd = _dataset_sets(r_mats, b, d)
    parents = profiling.counter("bge_pairs.parents", d + 1, gs.device)
    if parents is not None:
        profiling.count("bge_pairs.graphs", b)
        profiling.count("bge_pairs.calls", 1)
    if not use_kernel(gs):
        if parents is not None:
            parents[:d + 1] += torch.bincount(
                (gs != 0).sum(1).reshape(-1), minlength=d + 1)
        return bge_logdet_pairs_plain(r_mats, gs)
    _check_cuda("bge_pairs", r_mats, gs)
    lib = build()
    out_pa = torch.empty((b, d), dtype=torch.float32, device=gs.device)
    out_full = torch.empty((b, d), dtype=torch.float32, device=gs.device)
    # past d = 32: each pair's parent set as four 32-bit words, node-major,
    # a flag a graph for mask values other than 0 and 1, and each route's
    # chunk counter
    plans = bge_route_plans()
    words = soft = counters = None
    if d > 32:
        words = torch.empty((d, b, 4), dtype=torch.int32, device=gs.device)
        soft = torch.empty(b, dtype=torch.int32, device=gs.device)
        counters = torch.empty(len(plans) - 1, dtype=torch.int32,
                               device=gs.device)
    plan = [v for p in plans for v in (p.threads, p.smem_bytes)]
    with torch.cuda.device(gs.device):
        rc = lib.dibs_bge_pairs(
            r_mats.data_ptr(), gs.data_ptr(), out_pa.data_ptr(),
            out_full.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (words, soft, counters)),
            b, max(1, gpd), d, (ctypes.c_int * len(plan))(*plan),
            _stream(gs.device),
            None if parents is None else parents.data_ptr())
    _check_launch(lib, rc, "bge_pairs")
    return out_pa, out_full
