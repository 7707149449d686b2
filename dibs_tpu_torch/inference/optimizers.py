"""Optimizers for the SVGD transport updates.

PyTorch twin of ``dibs_tpu/inference/optimizers.py``, as small stateless
objects with the optax calling convention (``init(params) -> state``,
``update(grads, state) -> (updates, state)``; apply with ``params +
updates``):

  * ``rmsprop``: ``nu <- gamma nu + (1 - gamma) g^2;  x <- x - lr g / sqrt(nu + eps)``
    with ``eps`` inside the square root. ``torch.optim.RMSprop`` is not
    equivalent: it adds ``eps`` outside the root and defaults gamma to 0.99.
  * ``gd``: plain gradient descent.

Parameters and gradients are parameter trees (:mod:`dibs_tpu_torch.utils.
tree`; a bare tensor is a one-leaf tree), updated leaf by leaf. The rmsprop
state is the tuple ``(ScaleByRmsState(nu),)`` with ``nu`` a tree of the
same structure, the layout of the reference's optax chain
(``opt_state[0].nu``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dibs_tpu_torch.utils.tree import tree_map

__all__ = ["ScaleByRmsState", "RMSProp", "GradientDescent", "rmsprop",
           "sgd", "get_optimizer"]


class ScaleByRmsState(NamedTuple):
    nu: Any  # a tree of the parameters' structure


class RMSProp:
    """Reference-parity RMSProp (eps inside the square root)."""

    def __init__(self, stepsize: float, gamma: float = 0.9, eps: float = 1e-8):
        self.stepsize = stepsize
        self.gamma = gamma
        self.eps = eps

    def init(self, params):
        return (ScaleByRmsState(nu=tree_map(torch.zeros_like, params)),)

    def update(self, grads, state):
        nu = tree_map(lambda g, n: self.gamma * n
                      + (1.0 - self.gamma) * torch.square(g),
                      grads, state[0].nu)
        updates = tree_map(
            lambda g, n: -self.stepsize * (g / torch.sqrt(n + self.eps)),
            grads, nu)
        return updates, (ScaleByRmsState(nu=nu),)


class GradientDescent:
    """Plain SGD: ``x <- x - lr g``."""

    def __init__(self, stepsize: float):
        self.stepsize = stepsize

    def init(self, params):
        return ()

    def update(self, grads, state):
        return tree_map(lambda g: -self.stepsize * g, grads), state


def rmsprop(stepsize: float, gamma: float = 0.9, eps: float = 1e-8):
    """Reference-parity RMSProp (the reference's constructor name)."""
    return RMSProp(stepsize, gamma, eps)


def sgd(stepsize: float):
    """Plain SGD (the reference's constructor name)."""
    return GradientDescent(stepsize)


def get_optimizer(name: str, param: dict):
    """Resolves the reference's string/param optimizer spec
    (choices ``gd`` and ``rmsprop``)."""
    if name == "rmsprop":
        return rmsprop(param.get("stepsize", 0.005))
    if name == "gd":
        return sgd(param.get("stepsize", 0.005))
    raise ValueError(f"Unknown optimizer `{name}`")
