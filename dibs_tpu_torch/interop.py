"""Carries the JAX package's run state over into the port.

Takes plain numpy arrays (never JAX objects), so that both packages can step
from the same particles and a test can teacher-force the port with the
reference's state at every step.
"""
from __future__ import annotations

import numpy as np
import torch

from dibs_tpu_torch.inference.optimizers import ScaleByRmsState
from dibs_tpu_torch.inference.svgd import SVGDState
from dibs_tpu_torch.models.linear_gaussian import BGe

__all__ = ["state_from_reference", "bge_from_reference"]


def _tensor(a, device):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def state_from_reference(*, z, nu, sf_baseline, t, seed: int,
                         device="cpu") -> SVGDState:
    """Marginal :class:`SVGDState` from the reference's ``z``, rmsprop ``nu``
    (``opt_state_z[0].nu``), ``sf_baseline`` and ``t``. The reference's PRNG
    key has no counterpart; ``seed`` keys the port's noise streams."""
    z_t = _tensor(z, device)
    return SVGDState(t=int(t), seed=int(seed), z=z_t, theta=None,
                     opt_state_z=(ScaleByRmsState(nu=_tensor(nu, device)),),
                     opt_state_theta=None,
                     sf_baseline=_tensor(sf_baseline, device))


def bge_from_reference(*, n_vars, mean_obs, alpha_mu, alpha_lambd,
                       device="cpu") -> BGe:
    """A port :class:`BGe` with the reference model's hyperparameters."""
    return BGe(n_vars=n_vars, mean_obs=np.array(mean_obs, np.float32),
               alpha_mu=float(alpha_mu), alpha_lambd=float(alpha_lambd),
               device=device)
