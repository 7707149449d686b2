"""NOTEARS acyclicity constraint ``h(G) = tr[(I + G/d)^d] - d``.

PyTorch twin of ``dibs_tpu/ops/acyclic.py``: the ``'notears'`` form and
the ``'spectral'`` option (:func:`acyclic_constr_spectral`). The NOTEARS
backward is the closed form

    d h / d G = ((I + G/d)^(d-1))^T,

so the forward computes ``P = M^(d-1)`` by binary exponentiation, takes
``h = sum(M * P^T) - d`` without forming ``M^d``, and keeps ``P`` as the only
saved tensor. Batched over any leading dims.

For ``d >= 160`` the power chain tracks a power-of-two scale per matrix so
dense cyclic soft graphs saturate finitely instead of overflowing float32;
DAGs are never rescaled (see the overflow note in the reference module).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from dibs_tpu_torch.config import matmul_precision
from dibs_tpu_torch.profiling import span

__all__ = ["acyclic_constr", "acyclic_constr_spectral",
           "elwise_acyclic_constr", "matrix_power"]

_SCALE_CAP_LOG2 = 56
_RECON_SHIFT_CAP = 60
_SCALED_MIN_D = 160


def matrix_power(m: torch.Tensor, n: int,
                 precision: str = "highest") -> torch.Tensor:
    """``m ** n`` of ``[..., d, d]`` by binary exponentiation, its products
    at the matmul ``precision`` (``'highest'``: IEEE float32; ``'high'``
    and ``'default'``: TF32 on the card). ``n`` is an int >= 0."""
    if n < 0:
        raise ValueError("matrix_power requires n >= 0")
    with matmul_precision(precision):
        return _scaled_matrix_power(m, n, scaled=False)[0]


def _rescale_pow2(mat, shift):
    mx = mat.abs().amax(dim=(-2, -1))
    ex = torch.ceil(torch.log2(torch.clamp(mx, min=1e-30))) - _SCALE_CAP_LOG2
    s = torch.clamp(ex, min=0.0).to(torch.int32)
    return torch.ldexp(mat, -s[..., None, None].to(mat.dtype)), shift + s


def _scaled_matrix_power(m, n, scaled):
    """``(p, shift)`` with ``m ** n == ldexp(p, shift)`` per matrix."""
    d = m.shape[-1]
    zero = torch.zeros(m.shape[:-2], dtype=torch.int32, device=m.device)
    resc = _rescale_pow2 if scaled else (lambda mat, shift: (mat, shift))
    result = torch.eye(d, dtype=m.dtype, device=m.device).expand(m.shape)
    r_shift = zero
    base, b_shift = resc(m, zero)
    while n > 0:
        if n & 1:
            result, r_shift = resc(result @ base, r_shift + b_shift)
        n >>= 1
        if n:
            base, b_shift = resc(base @ base, 2 * b_shift)
    return result, r_shift


def _recon(shift, dtype):
    return torch.ldexp(torch.ones((), dtype=dtype, device=shift.device),
                       torch.clamp(shift, max=_RECON_SHIFT_CAP).to(dtype))


class _AcyclicConstr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, precision):
        d = g.shape[-1]
        scaled = d >= _SCALED_MIN_D
        with span("dibs.prior.acyclic"):
            m = torch.eye(d, dtype=g.dtype, device=g.device) + (1.0 / d) * g
            with matmul_precision(precision):
                p, shift = _scaled_matrix_power(m, d - 1, scaled)
            tr = (m * p.transpose(-1, -2)).sum(dim=(-2, -1))
            if scaled:
                h = tr * _recon(shift, tr.dtype) - d
            else:
                h = tr - d
        ctx.save_for_backward(p, shift)
        ctx.scaled = scaled
        return h

    @staticmethod
    def backward(ctx, h_bar):
        p, shift = ctx.saved_tensors
        with span("dibs.prior.acyclic"):
            grad = p.transpose(-1, -2)
            if ctx.scaled:
                grad = grad * _recon(shift, grad.dtype)[..., None, None]
            return h_bar[..., None, None] * grad, None


def acyclic_constr(g: torch.Tensor, n_vars: Optional[int] = None,
                   precision: str = "highest") -> torch.Tensor:
    """``h(G)`` for ``[..., d, d]`` (soft) adjacencies -> ``[...]``, with the
    closed-form backward; ``n_vars``, where given (the reference's
    ``acyclic_constr(g, n_vars)``), must be ``d``. ``precision`` is the
    power chain's matmul precision, as the reference's: ``'highest'``
    (IEEE float32, what the exact ``h == 0`` DAG checks need) or ``'high'``
    / ``'default'`` (TF32 on the card, about 2^-11 relative); the engine
    passes nothing."""
    if n_vars is not None and g.shape[-1] != n_vars:
        raise ValueError(f"expected d = {n_vars}, got {g.shape[-1]}")
    return _AcyclicConstr.apply(g, precision)


def elwise_acyclic_constr(gs: torch.Tensor, n_vars: int) -> torch.Tensor:
    """Batched ``h(G)`` over a leading batch dimension: ``[n, d, d] -> [n]``."""
    return acyclic_constr(gs, n_vars)


# --- spectral-radius penalty (the reference's beyond-reference option) ---
#
# For an entrywise-nonnegative (soft) adjacency the spectral radius
# rho(G) is real (Perron-Frobenius) and zero iff G is nilpotent, i.e.
# acyclic: the zero set of the NOTEARS penalty at O(K d^2) matvecs instead
# of O(d^3 log d) products. Power iteration for the right and left Perron
# vectors; the gradient is the eigenvalue perturbation ``u v^T / (u.v)``.

_SPECTRAL_ITERS = 24
_SPECTRAL_EPS = 1e-9


def _power_iteration(g, n_iter):
    """``(lam, u, v)`` per ``[d, d]`` matrix of ``g [..., d, d]``."""
    d = g.shape[-1]
    v = torch.full(g.shape[:-1], 1.0 / math.sqrt(d), dtype=g.dtype,
                   device=g.device)  # right
    u = v.clone()  # left
    for _ in range(n_iter):
        v_new = (g @ v[..., None])[..., 0]
        v_new = v_new / (torch.linalg.vector_norm(v_new, dim=-1,
                                                  keepdim=True)
                         + _SPECTRAL_EPS)
        u_new = (u[..., None, :] @ g)[..., 0, :]
        u_new = u_new / (torch.linalg.vector_norm(u_new, dim=-1,
                                                  keepdim=True)
                         + _SPECTRAL_EPS)
        u, v = u_new, v_new
    gv = (g @ v[..., None])[..., 0]
    lam = (u * gv).sum(-1) / ((u * v).sum(-1) + _SPECTRAL_EPS)
    return lam, u, v


class _SpectralConstr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, n_iter, precision):
        with span("dibs.prior.acyclic"), matmul_precision(precision):
            lam, u, v = _power_iteration(g, n_iter)
        ctx.save_for_backward(u, v)
        return lam

    @staticmethod
    def backward(ctx, h_bar):
        u, v = ctx.saved_tensors
        with span("dibs.prior.acyclic"):
            denom = (u * v).sum(-1) + _SPECTRAL_EPS
            grad = u[..., :, None] * v[..., None, :]
            return (h_bar / denom)[..., None, None] * grad, None, None


def acyclic_constr_spectral(g: torch.Tensor, n_iter: int = _SPECTRAL_ITERS,
                            precision: str = "highest") -> torch.Tensor:
    """Spectral acyclicity penalty ``h(G) ~= rho(G)`` for ``[..., d, d]``
    entrywise-nonnegative adjacencies -> ``[...]``, by ``n_iter`` power
    iterations (matmuls at ``precision``, as :func:`acyclic_constr`); zero
    iff acyclic. The backward is the Perron outer product ``h_bar u v^T /
    (u.v + eps)`` with the iterates held constant."""
    return _SpectralConstr.apply(g, n_iter, precision)
