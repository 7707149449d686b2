"""The numbers that decide ``correct``: how far the port's states lie from
the plain reference's, each against its limit from the configuration file.

For each compared leaf ``L`` of the state (``z``, and ``theta`` for a
joint model) and each of two states, ``start`` (what set-up derived in the
traffic's ``warm_steps`` steps from the initial particles) and ``end`` (the
output of the window's last segment), with ``p`` the port's tensors, ``r``
the reference's and ``r_before`` the reference's state the phase started
from (the initial particles, then the start state):

* ``<state>_L = ||p - r|| / ||r - r_before||``: the gap over the whole
  leaf, against the change the reference made in that phase;
* ``<state>_p50_L``, ``<state>_p90_L``, ``<state>_max_L``: the same ratio
  a particle, each particle against its own change; the median, the 90th
  percentile and the largest over the particles;
* ``<state>_over_L``: the share of the particles whose own ratio passes
  the limit of ``<state>_p90_L`` (where that has a limit). A few particles
  of a sound run pass it (a hard sample decided one way in float32 and
  the other in the reference's float64 sends a particle another way); a
  fault confined to a block of particles, too few to move the 90th
  percentile, passes it in every particle of the block.

The likelihood's part of a step is seldom visible in the states at
these steps: at d = 128 the sampled NOTEARS gradient of the early, dense
soft graphs is some 10^20 times the likelihood's, so ``z`` moves the same
to the last bit with half of the likelihood's samples. So the last step
of the window's last segment is checked by itself: after the window the
segment runs once more to the state that step starts from, the engine's
likelihood estimator is called on it as the step calls it, and the
reference's likelihood at those same inputs is compared, for each output
``O`` (``dz``, and ``dtheta`` for a joint model):

* ``lik_p50_O``, ``lik_p90_O`` (and ``lik_O``, ``lik_max_O``): ``||p -
  r|| / ||r||`` a particle, the median and the 90th percentile (the whole
  output, the largest particle); ``lik_over_O`` as ``<state>_over_L``;
* ``replay``: the largest difference between that step run again and the
  window's last segment's output, which must be 0 (the port's kernels
  are deterministic): the checked inputs are the window's.

A run is correct when every number the configuration gives a limit is
finite and at most that limit; the others are printed by the calibration
tool only.
"""
from __future__ import annotations

import math

import torch

__all__ = ["numbers", "stage_numbers", "replay_gap", "judged", "judge"]


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float64).reshape(t.shape[0], -1)


def _over(out: dict, name: str, per: torch.Tensor, limits: dict) -> None:
    """``out[<prefix>_over_<leaf>]`` where ``name`` (``<prefix>_p90_<leaf>``)
    has a limit: the share of ``per`` above it."""
    if name in limits:
        prefix, leaf = name.split("_p90_")
        out[f"{prefix}_over_{leaf}"] = float((per > limits[name]).double()
                                             .mean())


def numbers(leaves: list, port_start: dict, port_end: dict, ref_init: dict,
            ref_start: dict, ref_end: dict, limits: dict = None) -> dict:
    """``{name: value}`` of every compared number (float64 arithmetic on
    the reference's device); ``limits`` gives the thresholds of the
    ``_over_`` shares."""
    limits = limits or {}
    out = {}
    for leaf in leaves:
        dev = ref_end[leaf].device
        port = {"start": port_start, "end": port_end}
        before = {"start": ref_init, "end": ref_start}
        after = {"start": ref_start, "end": ref_end}
        for state in ("start", "end"):
            p = _flat(port[state][leaf].to(dev))
            r, r0 = _flat(after[state][leaf]), _flat(before[state][leaf])
            out[f"{state}_{leaf}"] = float((p - r).norm() / (r - r0).norm())
            per = (p - r).norm(dim=1) / (r - r0).norm(dim=1)
            q = torch.quantile(per, torch.tensor([0.5, 0.9], dtype=per.dtype,
                                                 device=dev))
            out[f"{state}_p50_{leaf}"] = float(q[0])
            out[f"{state}_p90_{leaf}"] = float(q[1])
            out[f"{state}_max_{leaf}"] = float(per.max())
            _over(out, f"{state}_p90_{leaf}", per, limits)
    return out


def stage_numbers(port_out: dict, ref_out: dict, limits: dict = None) -> dict:
    """The likelihood stage's numbers (see the module docstring)."""
    limits = limits or {}
    out = {}
    for name, r in ref_out.items():
        dev = r.device
        p, r = _flat(port_out[name].to(dev)), _flat(r)
        gap = (p - r).norm(dim=1)
        size = r.norm(dim=1)
        per = torch.where(size > 0, gap / size.clamp_min(1e-300),
                          torch.where(gap > 0, torch.inf, 0.0))
        q = torch.quantile(per, torch.tensor([0.5, 0.9], dtype=per.dtype,
                                             device=dev))
        out[f"lik_{name}"] = float((p - r).norm() / r.norm())
        out[f"lik_p50_{name}"] = float(q[0])
        out[f"lik_p90_{name}"] = float(q[1])
        out[f"lik_max_{name}"] = float(per.max())
        _over(out, f"lik_p90_{name}", per, limits)
    return out


def replay_gap(window: dict, again: dict) -> float:
    """The largest difference between two runs of one segment."""
    return max(float((window[k] - again[k]).abs().max()) for k in window)


def judged(values: dict, limits: dict) -> dict:
    """The numbers that have a limit."""
    return {k: v for k, v in values.items() if k in limits}


def judge(values: dict, limits: dict) -> bool:
    return all(math.isfinite(v) and v <= limits[k]
               for k, v in judged(values, limits).items())
