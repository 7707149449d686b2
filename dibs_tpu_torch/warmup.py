"""Kernel build and first-step warming before a run (counterpart of
``dibs_tpu/warmup.py``).

The first kernel call of a process builds the CUDA kernels: ``nvcc`` compiles
every source of ``dibs_tpu_torch/csrc`` (tens of seconds on an H100
machine; cached by source hash under ``dibs_tpu_torch/_build`` afterwards),
and the first step at a shape loads each kernel and warms cuBLAS.
:func:`warmup` does both up front for a shape list, with progress on
stderr, so interactive runs never stall silently.
"""
from __future__ import annotations

import sys
import time
from typing import Iterable, Sequence

import torch

from dibs_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from dibs_tpu_torch.ops import gpu_kernels

__all__ = ["warmup", "MODELS"]

MODELS = ("joint_linear", "marginal_bge", "joint_nonlinear")


def _build(model: str, d: int, n_obs: int, n_grad_mc_samples: int,
           hidden_layers, device):
    from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
    from dibs_tpu_torch.models import (
        BGe,
        DenseNonlinearGaussian,
        ErdosReniDAGDistribution,
        LinearGaussian,
    )

    x = torch.zeros((n_obs, d))  # shapes drive the plans; values don't
    gm = ErdosReniDAGDistribution(d, n_edges_per_node=1)
    if model == "joint_linear":
        return JointDiBS(x=x, graph_model=gm,
                         likelihood_model=LinearGaussian(n_vars=d),
                         n_grad_mc_samples=n_grad_mc_samples, device=device)
    if model == "marginal_bge":
        return MarginalDiBS(x=x, graph_model=gm,
                            likelihood_model=BGe(n_vars=d, device=device),
                            n_grad_mc_samples=n_grad_mc_samples,
                            device=device)
    if model == "joint_nonlinear":
        return JointDiBS(
            x=x, graph_model=gm,
            likelihood_model=DenseNonlinearGaussian(
                n_vars=d, hidden_layers=tuple(hidden_layers)),
            n_grad_mc_samples=n_grad_mc_samples, device=device)
    raise ValueError(f"unknown model {model!r}; choose from {MODELS}")


def _say(verbose, msg):
    if verbose:
        print(f"[dibs-tpu-torch warmup] {msg}", file=sys.stderr, flush=True)


def warmup(d: int | Iterable[int], *, n_obs: int = 100,
           n_particles: int = 30, n_grad_mc_samples: int = 128,
           models: Sequence[str] = MODELS, hidden_layers=(5,),
           verbose: bool = True, device=DEFAULT_DEVICE) -> None:
    """Builds the kernels and runs one SVGD step of each model at the given
    shape(s) on zero data.

    On the card: builds and loads the kernel library
    (:func:`dibs_tpu_torch.ops.gpu_kernels.build`), then for each ``(d,
    model)`` runs the step ``sample()`` runs once from an initial state,
    which loads each kernel the path launches and warms cuBLAS at that
    shape. On the CPU (``device="cpu"``) it runs the plain path and builds
    nothing. Raises where CUDA is absent and ``device`` is not ``"cpu"``.

    Leaves no trace but the loaded library: the global torch RNG, the
    launch counts ``gpu_kernels.LAUNCHES`` and the precision settings are as
    before, so a run after it is bitwise the run without it.
    """
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    ds = [d] if isinstance(d, int) else list(d)
    launches = dict(gpu_kernels.LAUNCHES)
    rng_devices = ([dev.index if dev.index is not None
                    else torch.cuda.current_device()] if on_card else [])
    try:
        with torch.random.fork_rng(devices=rng_devices):
            if on_card:
                _say(verbose, "building the CUDA kernels (the first build "
                     "compiles every source with nvcc; cached afterwards)")
                t0 = time.perf_counter()
                gpu_kernels.build()
                _say(verbose, f"kernels built and loaded in "
                     f"{time.perf_counter() - t0:.1f} s")
            for dd in ds:
                for model in models:
                    t0 = time.perf_counter()
                    dibs = _build(model, dd, n_obs, n_grad_mc_samples,
                                  hidden_layers, dev)
                    state = dibs.init_state(seed=0, n_particles=n_particles)
                    step = dibs._make_step(
                        dibs._resolve_latent_std(state.z.shape[2]))
                    step(state)
                    if on_card:
                        torch.cuda.synchronize(dev)
                    _say(verbose, f"{model} d={dd} N={n_obs} P={n_particles} "
                         f"M={n_grad_mc_samples} on {dev.type}: first step "
                         f"in {time.perf_counter() - t0:.2f} s")
    finally:
        gpu_kernels.LAUNCHES.update(launches)
