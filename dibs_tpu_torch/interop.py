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
from dibs_tpu_torch.models.nonlinear_gaussian import DenseNonlinearGaussian

__all__ = ["state_from_reference", "fleet_state_from_reference",
           "bge_from_reference",
           "linear_gaussian_from_reference",
           "nonlinear_gaussian_from_reference", "params_from_reference",
           "target_from_reference"]


def _tensor(a, device):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def params_from_reference(theta, device=DEFAULT_DEVICE):
    """The reference's parameters as the port's tree: an array becomes a
    float32 tensor, the MLP pytree ``[(W1, b1), (W2, b2), ...]`` (nested
    lists and tuples of arrays) a list of tuples of tensors."""
    device = resolve_device(device)
    if isinstance(theta, (list, tuple)):
        inner = [params_from_reference(t, device) for t in theta]
        return tuple(inner) if isinstance(theta, tuple) else inner
    return _tensor(theta, device)


def state_from_reference(*, z, nu, sf_baseline, t, seed: int, theta=None,
                         nu_theta=None, device=DEFAULT_DEVICE) -> SVGDState:
    """:class:`SVGDState` from the reference's ``z``, rmsprop ``nu``
    (``opt_state_z[0].nu``), ``sf_baseline`` and ``t``; for a joint state
    also ``theta`` and its rmsprop ``nu_theta`` (``opt_state_theta[0].nu``),
    arrays or parameter pytrees (:func:`params_from_reference`).
    The reference's PRNG key has no counterpart; ``seed`` keys the port's
    noise streams."""
    device = resolve_device(device)
    joint = theta is not None
    return SVGDState(
        t=int(t), seed=int(seed), z=_tensor(z, device),
        theta=params_from_reference(theta, device) if joint else None,
        opt_state_z=(ScaleByRmsState(nu=_tensor(nu, device)),),
        opt_state_theta=((ScaleByRmsState(
            nu=params_from_reference(nu_theta, device)),)
                         if joint else None),
        sf_baseline=_tensor(sf_baseline, device))


def fleet_state_from_reference(state, *, seeds,
                               device=DEFAULT_DEVICE) -> SVGDState:
    """The port's fleet state from the reference's stacked
    :class:`SVGDState` (``dibs_tpu.fleet.fleet_sample(...,
    return_states=True)``, its arrays as numpy with a leading dataset
    axis): ``z``, rmsprop ``nu``, ``sf_baseline``, the common ``t`` and, for
    a joint state, ``theta`` and its rmsprop ``nu`` (parameter pytrees as
    :func:`params_from_reference` takes them). The reference's per-dataset
    PRNG keys have no counterpart; ``seeds`` (``[B]`` ints) key the port's
    noise streams."""
    device = resolve_device(device)
    steps = np.unique(np.asarray(state.t))
    if steps.size != 1:
        raise ValueError(f"a fleet's datasets share one step counter, got "
                         f"{steps.tolist()}")
    joint = state.theta is not None
    return SVGDState(
        t=int(steps[0]),
        seed=torch.as_tensor(np.asarray(seeds, dtype=np.int64)).to(device),
        z=_tensor(state.z, device),
        theta=params_from_reference(state.theta, device) if joint else None,
        opt_state_z=(ScaleByRmsState(nu=_tensor(state.opt_state_z[0].nu,
                                                device)),),
        opt_state_theta=((ScaleByRmsState(nu=params_from_reference(
            state.opt_state_theta[0].nu, device)),) if joint else None),
        sf_baseline=_tensor(state.sf_baseline, device))


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


def nonlinear_gaussian_from_reference(*, n_vars, hidden_layers, obs_noise,
                                      sig_param, activation="relu",
                                      bias=True) -> DenseNonlinearGaussian:
    """A port :class:`DenseNonlinearGaussian` with the reference model's
    hyperparameters."""
    return DenseNonlinearGaussian(
        n_vars=n_vars, hidden_layers=tuple(int(h) for h in hidden_layers),
        obs_noise=float(obs_noise), sig_param=float(sig_param),
        activation=activation, bias=bool(bias))


def target_from_reference(*, g, theta, device=DEFAULT_DEVICE):
    """The reference ``Data.g`` / ``Data.theta`` (numpy) as the port's
    ``(g int32 [d, d], theta)``, ``theta`` a float32 ``[d, d]`` tensor or
    the MLP parameter tree."""
    device = resolve_device(device)
    g_t = torch.from_numpy(np.array(g, dtype=np.int32)).to(device)
    return g_t, params_from_reference(theta, device)
