"""Checkpoint / resume of SVGD runs (counterpart of ``dibs_tpu/checkpoint.py``).

The whole carry of a run is one :class:`~dibs_tpu_torch.inference.SVGDState`
and the annealing schedules and noise streams depend only on its step
counter ``t`` and ``seed``, so resuming a loaded state continues the run
exactly as if it had not stopped.

The file holds only tensors, Python scalars, strings, lists, tuples and
dicts: the state's named tuples (``SVGDState``, the rmsprop
``ScaleByRmsState``) are written as tagged dicts and rebuilt on load, and
:func:`load_state` reads with ``torch.load(weights_only=True)``, so nothing
is unpickled. That is what the reference's orbax backend is for; it has no
twin of its own here. ``theta`` may be any parameter tree
(:mod:`dibs_tpu_torch.utils.tree`).
"""
from __future__ import annotations

import os

import torch

from dibs_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from dibs_tpu_torch.inference.optimizers import ScaleByRmsState
from dibs_tpu_torch.inference.svgd import SVGDState

__all__ = ["save_state", "load_state"]

_SUFFIX = ".dibs-ckpt.pt"
_FORMAT = "dibs_tpu_torch.SVGDState/1"
_TENSOR_FIELDS = ("z", "theta", "opt_state_z", "opt_state_theta",
                  "sf_baseline")


def _path(path: str) -> str:
    return path if path.endswith(_SUFFIX) else path + _SUFFIX


def _encode(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, ScaleByRmsState):
        return {"ScaleByRmsState": _encode(obj.nu)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(o) for o in obj)
    if obj is None:
        return None
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _decode(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return ScaleByRmsState(nu=_decode(obj["ScaleByRmsState"], device))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode(o, device) for o in obj)
    return obj


def save_state(state: SVGDState, path: str) -> str:
    """Writes ``state`` to ``path`` (``.dibs-ckpt.pt`` is appended if
    missing) atomically; returns the file's path."""
    target = _path(path)
    directory = os.path.dirname(os.path.abspath(target))
    os.makedirs(directory, exist_ok=True)
    payload = {"format": _FORMAT, "t": int(state.t), "seed": int(state.seed)}
    for field in _TENSOR_FIELDS:
        payload[field] = _encode(getattr(state, field))
    tmp = target + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, target)  # no torn checkpoint if the run dies here
    return target


def load_state(path: str, device=DEFAULT_DEVICE) -> SVGDState:
    """Reads a state written by :func:`save_state` onto ``device`` (the
    card unless ``device="cpu"``), without unpickling anything."""
    dev = resolve_device(device)
    payload = torch.load(_path(path), map_location="cpu", weights_only=True)
    if payload.get("format") != _FORMAT:
        raise ValueError(f"{_path(path)} is not a {_FORMAT} checkpoint")
    return SVGDState(t=int(payload["t"]), seed=int(payload["seed"]),
                     **{field: _decode(payload[field], dev)
                        for field in _TENSOR_FIELDS})
