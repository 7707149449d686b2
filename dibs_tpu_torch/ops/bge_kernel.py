"""BGe determinant pairs for a whole hard-graph batch: the CUDA kernel
wrapper and its plain PyTorch twin.

Counterpart of ``dibs_tpu/ops/bge_kernel.py``. For every graph ``b`` and
node ``j``, with parent mask ``gs[b, :, j]`` and node ``j``'s posterior
matrix ``R_j``, it returns ``logdet R_j[Pa, Pa]`` and
``logdet R_j[Pa u j, Pa u j]`` from one bordered-Schur elimination (see
``csrc/bge_pairs.cu``). Forward only: the REINFORCE estimators treat graph
samples as constants. Serves ``2 <= d <= 128``; an all-zero mask gives
``logdet_pa == 0``.
"""
from __future__ import annotations

import torch

from dibs_tpu_torch.ops.gpu_kernels import (
    _check_cuda,
    _check_launch,
    _stream,
    build,
)

__all__ = ["bge_logdet_pairs", "bge_logdet_pairs_plain"]

_MAX_D = 128


def bge_logdet_pairs_plain(r_mats: torch.Tensor, gs: torch.Tensor):
    """Plain twin: the kernel's bordered-Schur sweep on ``[B, d, d, d]``
    masked matrices, one pivot per step over the whole batch, with the
    kernel's float32 operations in the kernel's order and the log-pivots
    summed in float64."""
    b, d, _ = gs.shape
    m = gs.transpose(1, 2)  # [B, j, r]: parent mask of node j
    mm = m[..., :, None] * m[..., None, :]  # [B, j, r, c]
    eye = torch.eye(d, dtype=r_mats.dtype, device=r_mats.device)
    a = r_mats[None] * mm + eye * (1.0 - mm)
    jj = torch.arange(d, device=r_mats.device)
    r_col = r_mats[jj, :, jj]  # [j, r] = R_j[r, j]
    v = r_col[None] * m  # [B, j, r]
    s = r_mats[jj, jj, jj].expand(b, d)
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
        r_mats: ``[d, d, d]`` per-node posterior matrices ``R_j`` (PD)
        gs: ``[B, d, d]`` adjacency samples; node ``j``'s parents are the
            column ``gs[:, :, j]``

    Returns:
        ``(logdet_pa, logdet_full)``, each ``[B, d]``.
    """
    b, d, _ = gs.shape
    if not 2 <= d <= _MAX_D:
        raise ValueError(f"bge_logdet_pairs serves 2 <= d <= {_MAX_D}, "
                         f"got d={d}")
    if tuple(r_mats.shape) != (d, d, d):
        raise ValueError(f"r_mats must be {(d, d, d)}, got "
                         f"{tuple(r_mats.shape)}")
    if gs.device.type == "cpu":
        return bge_logdet_pairs_plain(r_mats, gs)
    _check_cuda("bge_pairs", r_mats, gs)
    lib = build()
    out_pa = torch.empty((b, d), dtype=torch.float32, device=gs.device)
    out_full = torch.empty((b, d), dtype=torch.float32, device=gs.device)
    with torch.cuda.device(gs.device):
        rc = lib.dibs_bge_pairs(r_mats.data_ptr(), gs.data_ptr(),
                                out_pa.data_ptr(), out_full.data_ptr(), b, d,
                                _stream(gs.device))
    _check_launch(lib, rc, "bge_pairs")
    return out_pa, out_full
