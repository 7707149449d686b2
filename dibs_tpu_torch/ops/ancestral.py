"""Ancestral sampling for additive-noise SEMs (PyTorch twin of
``dibs_tpu/ops/ancestral.py``).

Uses the DAG fixed-point identity: iterating
``x <- where(intervened, clamp, f(x) + z)`` ``d`` times from ``x = 0``
converges exactly when ``f_j`` reads only node ``j``'s parents, so no
topological sort is needed.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

__all__ = ["interv_to_vectors", "sample_sem_obs"]


def interv_to_vectors(interv: Optional[Dict[int, float]], n_vars: int,
                      device="cpu"):
    """``{node: clamp_value}`` -> ``(mask [d], values [d])`` float tensors."""
    mask = torch.zeros(n_vars, device=device)
    values = torch.zeros(n_vars, device=device)
    for node, val in (interv or {}).items():
        mask[int(node)] = 1.0
        values[int(node)] = float(val)
    return mask, values


def sample_sem_obs(*, generator: torch.Generator, n_samples: int, n_vars: int,
                   mean_fn: Callable[[torch.Tensor], torch.Tensor],
                   obs_noise: float, interv_mask: torch.Tensor,
                   interv_values: torch.Tensor) -> torch.Tensor:
    """Samples ``[n_samples, d]`` observations. The Gaussian noise comes from
    ``generator`` (a CPU generator) and is moved to ``interv_mask``'s
    device."""
    device = interv_mask.device
    z = math.sqrt(obs_noise) * torch.randn((n_samples, n_vars),
                                           generator=generator).to(device)
    x = torch.zeros((n_samples, n_vars), device=device)
    clamp = interv_mask > 0
    for _ in range(n_vars):
        x = torch.where(clamp, interv_values, mean_fn(x) + z)
    return x
