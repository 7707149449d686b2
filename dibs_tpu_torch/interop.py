"""Carries the JAX package's run state, models and targets over into the port.

Takes plain numpy arrays (never JAX objects), so that both packages can step
from the same particles and a test can teacher-force the port with the
reference's state at every step.
"""
from __future__ import annotations

import numpy as np
import torch

from dibs_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from dibs_tpu_torch.inference.optimizers import ScaleByRmsState
from dibs_tpu_torch.inference.svgd import SVGDState
from dibs_tpu_torch.models.linear_gaussian import BGe, LinearGaussian

__all__ = ["state_from_reference", "bge_from_reference",
           "linear_gaussian_from_reference", "target_from_reference"]


def _tensor(a, device):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def state_from_reference(*, z, nu, sf_baseline, t, seed: int, theta=None,
                         nu_theta=None, device=DEFAULT_DEVICE) -> SVGDState:
    """:class:`SVGDState` from the reference's ``z``, rmsprop ``nu``
    (``opt_state_z[0].nu``), ``sf_baseline`` and ``t``; for a joint state
    also ``theta`` and its rmsprop ``nu_theta`` (``opt_state_theta[0].nu``).
    The reference's PRNG key has no counterpart; ``seed`` keys the port's
    noise streams."""
    device = resolve_device(device)
    joint = theta is not None
    return SVGDState(
        t=int(t), seed=int(seed), z=_tensor(z, device),
        theta=_tensor(theta, device) if joint else None,
        opt_state_z=(ScaleByRmsState(nu=_tensor(nu, device)),),
        opt_state_theta=((ScaleByRmsState(nu=_tensor(nu_theta, device)),)
                         if joint else None),
        sf_baseline=_tensor(sf_baseline, device))


def bge_from_reference(*, n_vars, mean_obs, alpha_mu, alpha_lambd,
                       device=DEFAULT_DEVICE) -> BGe:
    """A port :class:`BGe` with the reference model's hyperparameters."""
    return BGe(n_vars=n_vars, mean_obs=np.array(mean_obs, np.float32),
               alpha_mu=float(alpha_mu), alpha_lambd=float(alpha_lambd),
               device=device)


def linear_gaussian_from_reference(*, n_vars, obs_noise, mean_edge, sig_edge,
                                   min_edge) -> LinearGaussian:
    """A port :class:`LinearGaussian` with the reference model's
    hyperparameters."""
    return LinearGaussian(n_vars=n_vars, obs_noise=float(obs_noise),
                          mean_edge=float(mean_edge),
                          sig_edge=float(sig_edge), min_edge=float(min_edge))


def target_from_reference(*, g, theta, device=DEFAULT_DEVICE):
    """The reference ``Data.g`` / ``Data.theta`` (numpy) as the port's
    ``(g int32 [d, d], theta float32 [d, d])``."""
    device = resolve_device(device)
    g_t = torch.from_numpy(np.array(g, dtype=np.int32)).to(device)
    return g_t, _tensor(theta, device)
