"""The counter-based noise the port's kernels draw, in plain PyTorch.

A frozen copy of the arithmetic: Philox4x32-10 (Random123's round and key
schedule) with the counter ``(element, sample, particle, stream)`` and the
key ``(seed mod 2^32, seed >> 32)``; the first output word's top 24 bits,
offset by half a unit and clamped below 1, give a uniform in (0, 1); a
Logistic(0, 1) variate is ``log u - log(1 - u)``.

The 32 x 32-bit products are taken as one int64 multiplication: both
factors are below 2^32, so the wrapped 64-bit product holds the exact bits,
and its high and low words are the two halves.
"""
from __future__ import annotations

import torch

__all__ = ["uniform", "logistic"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    prod = b * a
    return (prod >> 32) & _MASK, prod & _MASK


def _philox_word0(c0, c1, c2, c3, k0: int, k1: int) -> torch.Tensor:
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def uniform(n_particles: int, n_samples: int, d: int, seed: int,
            stream: int, device, first_particle: int = 0) -> torch.Tensor:
    """``[n, n_samples, d, d]`` float32 uniforms of particles
    ``first_particle .. first_particle + n - 1`` of stream ``stream``."""
    kw = dict(dtype=torch.int64, device=device)
    # each counter word varies along one axis; the rounds broadcast them,
    # so the first two rounds work on small tensors
    c0 = torch.arange(d * d, **kw).view(1, 1, d, d)
    c1 = torch.arange(n_samples, **kw).view(1, n_samples, 1, 1)
    c2 = (torch.arange(n_particles, **kw) + first_particle).view(-1, 1, 1, 1)
    c3 = torch.full((1, 1, 1, 1), stream & _MASK, **kw)
    word = _philox_word0(c0, c1, c2, c3, seed & _MASK, (seed >> 32) & _MASK)
    word = word.expand(n_particles, n_samples, d, d)
    u = (word >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 0.5 / (1 << 24)
    return torch.clamp(u, max=1.0 - 2.0 ** -23)


def logistic(n_particles: int, n_samples: int, d: int, seed: int,
             stream: int, device, dtype=torch.float64,
             first_particle: int = 0) -> torch.Tensor:
    """Logistic(0, 1) variates of :func:`uniform`'s draw, in ``dtype``."""
    u = uniform(n_particles, n_samples, d, seed, stream, device,
                first_particle).to(dtype)
    return torch.log(u) - torch.log1p(-u)
