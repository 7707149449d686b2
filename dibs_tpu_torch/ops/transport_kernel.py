"""Fused SVGD transport family (PyTorch twin of
``dibs_tpu/ops/transport_kernel.py``).

One transport family in one pass over the ``[P, n]`` operands:

    phi = -(1/P) (K_own^T (g + c v') + K_other^T g) + (c/P) colsum(K_own) ⊙ v'

with ``v' = v - mu``, by the SE-family identity

    k_mat^T g + c (K_own^T v' - colsum(K_own) ⊙ v')
        = K_own^T (g + c v') + K_other^T g - c colsum(K_own) ⊙ v'

(``k_mat = K_own + K_other``; ``k_other=None`` is the marginal form, one
product). The CUDA kernel (``csrc/transport_phi.cu``) computes both products
as one contraction of length 2P, the rhs combine, the centring, the ``-1/P``
scale and the rank-1 epilogue ``(c/P) colsum(K_own) ⊙ v'`` in its own body;
``colsum(K_own)`` is formed outside it, as the JAX package forms it outside
its ``pallas_call``. float32 with float32 accumulation: the TPU kernel's bf16
hi/lo emulation is not carried over.

Any ``P`` and ``n``, in one of two instantiations of the same kernel: the
aligned one (16-byte global loads and stores) where every operand row starts
on 16 bytes, i.e. ``P % 4 == 0``, ``n % 4 == 0`` and every pointer 16-byte
aligned (config 5's ``[1000, 32768]`` and ``[1000, 16384]``); the scalar-load
one otherwise (``P = 30`` at d=20, the ragged ``[7, 130]``).
:func:`transport_phi_aligned` decides from the shapes and ``data_ptr()``.

A fleet (:mod:`dibs_tpu_torch.fleet`) passes every operand with a leading
dataset axis, ``[B_ds, P, P]`` and ``[B_ds, P, n]``: one launch computes
every dataset's family (a grid axis over the datasets), each with the bits
of the unbatched launch on its operands.

Dispatch (:func:`~dibs_tpu_torch.ops.gpu_kernels.use_kernel`): a CPU tensor,
or any with the kill switch off, goes to :func:`transport_phi_plain`; a CUDA
tensor to the kernel, and a build or launch failure raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from dibs_tpu_torch.ops.gpu_kernels import (
    _check_cuda,
    _check_launch,
    _stream,
    build,
    use_kernel,
)

__all__ = ["transport_phi", "transport_phi_aligned", "transport_phi_plain",
           "transport_phi_available"]


def transport_phi_available(p: int, n: int) -> bool:
    """The kernel serves every ``[P, n]`` family (the TPU's P <= 1024,
    P % 8 and n % 256 were its VMEM and Mosaic tiling bounds)."""
    return p >= 1 and n >= 1


def transport_phi_aligned(p: int, n: int, *tensors) -> bool:
    """Whether the aligned instantiation serves this call: every row of the
    ``[P, P]`` and ``[P, n]`` operands starts on 16 bytes (``P % 4 == 0``,
    ``n % 4 == 0``, 16-byte aligned pointers). Otherwise the kernel's
    scalar-load instantiation takes it."""
    return (p % 4 == 0 and n % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def transport_phi_plain(k_own: torch.Tensor, k_other: Optional[torch.Tensor],
                        g: torch.Tensor, v: torch.Tensor, *, c: float,
                        mu: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same formula, two matmuls); a
    fleet's operands ``[B_ds, ...]`` give each dataset's family from this
    version on its operands alone."""
    if g.dim() == 3:
        return torch.stack([
            transport_phi_plain(k_own[i], None if k_other is None
                                else k_other[i], g[i], v[i], c=c,
                                mu=None if mu is None else mu[i])
            for i in range(g.shape[0])])
    p = g.shape[0]
    vc = v if mu is None else v - mu
    acc = k_own.T @ (g + c * vc)
    if k_other is not None:
        acc = acc + k_other.T @ g
    return acc * (-1.0 / p) + ((c / p) * k_own.sum(dim=0))[:, None] * vc


def transport_phi(k_own: torch.Tensor, k_other: Optional[torch.Tensor],
                  g: torch.Tensor, v: torch.Tensor, *, c: float,
                  mu: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused transport family ``phi [P, n]`` (see module docstring).

    Args:
        k_own: ``[P, P]`` kernel matrix of the repulsion family.
        k_other: ``[P, P]`` other additive component, or ``None`` (marginal).
        g: ``[P, n]`` flat scores.
        v: ``[P, n]`` flat particle values.
        c: repulsion factor ``-2/h`` of the SE kernel (a float).
        mu: optional ``[1, n]`` column means of ``v`` (the centring).

    A fleet passes each with a leading ``[B_ds]`` axis (``mu`` ``[B_ds, 1,
    n]``) and gets ``[B_ds, P, n]``.

    Returns:
        ``[P, n]`` transport, already negated and ``/P``-scaled.
    """
    if g.dim() not in (2, 3):
        raise ValueError(f"transport_phi: g must be [P, n] or [B_ds, P, n], "
                         f"got {tuple(g.shape)}")
    lead = tuple(g.shape[:-2])
    p, n = g.shape[-2:]
    mats = (k_own,) if k_other is None else (k_own, k_other)
    for mat in mats:
        if tuple(mat.shape) != (*lead, p, p):
            raise ValueError(f"transport_phi: kernel matrix must be "
                             f"{(*lead, p, p)}, got {tuple(mat.shape)}")
    if tuple(v.shape) != (*lead, p, n):
        raise ValueError(f"transport_phi: v must be {(*lead, p, n)}, got "
                         f"{tuple(v.shape)}")
    if mu is not None and mu.numel() != n * math.prod(lead):
        raise ValueError(f"transport_phi: mu must have {n} entries a "
                         f"dataset, got {tuple(mu.shape)}")
    if not use_kernel(g):
        return transport_phi_plain(k_own, k_other, g, v, c=c, mu=mu)
    extra = () if mu is None else (mu,)
    _check_cuda("transport_phi", *mats, g, v, *extra)
    lib = build()
    colsum = k_own.sum(dim=-2)
    out = torch.empty((*lead, p, n), dtype=torch.float32, device=g.device)
    vec = transport_phi_aligned(p, n, *mats, g, v, *extra, out)
    with torch.cuda.device(g.device):
        rc = lib.dibs_transport_phi(
            k_own.data_ptr(), None if k_other is None else k_other.data_ptr(),
            g.data_ptr(), v.data_ptr(), None if mu is None else mu.data_ptr(),
            colsum.data_ptr(), out.data_ptr(), math.prod(lead), p, n,
            float(c), float(c) / p, int(vec), _stream(g.device))
    _check_launch(lib, rc, "transport_phi")
    return out
