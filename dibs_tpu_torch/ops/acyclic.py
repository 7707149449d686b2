"""NOTEARS acyclicity constraint ``h(G) = tr[(I + G/d)^d] - d``.

PyTorch twin of ``dibs_tpu/ops/acyclic.py`` (the ``'notears'`` form; the
spectral option is not ported yet). The backward is the closed form

    d h / d G = ((I + G/d)^(d-1))^T,

so the forward computes ``P = M^(d-1)`` by binary exponentiation, takes
``h = sum(M * P^T) - d`` without forming ``M^d``, and keeps ``P`` as the only
saved tensor. Batched over any leading dims.

For ``d >= 160`` the power chain tracks a power-of-two scale per matrix so
dense cyclic soft graphs saturate finitely instead of overflowing float32;
DAGs are never rescaled (see the overflow note in the reference module).
"""
from __future__ import annotations

import torch

__all__ = ["acyclic_constr", "elwise_acyclic_constr"]

_SCALE_CAP_LOG2 = 56
_RECON_SHIFT_CAP = 60
_SCALED_MIN_D = 160


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
    def forward(ctx, g):
        d = g.shape[-1]
        scaled = d >= _SCALED_MIN_D
        m = torch.eye(d, dtype=g.dtype, device=g.device) + (1.0 / d) * g
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
        grad = p.transpose(-1, -2)
        if ctx.scaled:
            grad = grad * _recon(shift, grad.dtype)[..., None, None]
        return h_bar[..., None, None] * grad


def acyclic_constr(g: torch.Tensor) -> torch.Tensor:
    """``h(G)`` for ``[..., d, d]`` (soft) adjacencies -> ``[...]``, with the
    closed-form backward."""
    return _AcyclicConstr.apply(g)


def elwise_acyclic_constr(gs: torch.Tensor, n_vars: int) -> torch.Tensor:
    """Batched ``h(G)`` over a leading batch dimension: ``[n, d, d] -> [n]``."""
    if gs.shape[-1] != n_vars:
        raise ValueError(f"expected d = {n_vars}, got {gs.shape[-1]}")
    return acyclic_constr(gs)
