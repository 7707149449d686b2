"""The fused acyclicity-gradient kernel (#9) beside the engine's route, and
their microbenchmark.

Counterpart of ``benchmarks/bench_acyclic_kernel.py``: both functions
compute the Monte Carlo mean over ``kmc`` tau = 1 soft graph samples
``g = sigmoid(eps + alpha s)`` of ``d h(g) / d scores``, with
``h(g) = tr[(I + g/d)^d] - d``.

* :func:`fused_acyclic_grad` (``fused_grad``) draws the samples and runs the
  whole power chain on chip, one block per particle
  (``csrc/acyclic_grad.cu`` through :func:`~dibs_tpu_torch.ops.gpu_kernels.
  acyclic_grad`).
* :func:`engine_acyclic_grad` (``xla_grad``) is the route the engine's prior
  takes: the sampler kernel #1 writes the ``[P, K, d, d]`` samples,
  :func:`~dibs_tpu_torch.ops.acyclic.acyclic_constr` runs the chain as
  batched products, and autograd applies the closed-form backward with
  cotangent ``1/kmc``.

The engine does not call :func:`fused_acyclic_grad` (nor does the JAX
package's engine call its TPU kernel). Run the comparison with::

    python -m dibs_tpu_torch.ops.acyclic_kernel [--d 128] [--p 1000] [--kmc 8]

It times both on the card (CUDA events; ``--device cpu`` times the plain
versions on the CPU), prints their ratio, and the agreement of the two
64-sample estimates on the first 64 particles, drawn from other streams.
"""
from __future__ import annotations

import argparse
import time

import torch

from dibs_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from dibs_tpu_torch.ops import gpu_kernels
from dibs_tpu_torch.ops.acyclic import acyclic_constr
from dibs_tpu_torch.ops.soft_graphs import sample_soft_graphs

__all__ = ["MC_AGREEMENT_BAR", "TIMED_CALLS", "fused_acyclic_grad",
           "engine_acyclic_grad", "mc_disagreement", "main"]

# Bar on mc_disagreement of two independent 64-sample estimates: they differ
# by ~0.07-0.08 of the mean's size at d = 8-32 (the CPU tests' seeds), and
# the gap shrinks as 1/sqrt(samples); an estimate 30% off fails it.
MC_AGREEMENT_BAR = 0.15

# Calls timed per route after one warm-up call, as the TPU microbenchmark
# times them.
TIMED_CALLS = 20


def _check_n_vars(scores, n_vars):
    if scores.shape[-1] != n_vars:
        raise ValueError(f"expected d = {n_vars}, got {scores.shape[-1]}")


def fused_acyclic_grad(scores: torch.Tensor, seed: int, alpha: float, *,
                       n_vars: int, kmc: int, tau: float = 1.0,
                       eps: torch.Tensor | None = None) -> torch.Tensor:
    """``[P, d, d]`` scores -> the ``kmc``-sample mean of ``d h / d scores``
    through kernel #9 (its plain version for CPU tensors). Uniforms from
    Philox keyed by ``seed``, or the injected Logistic ``eps [P, kmc, d,
    d]``. Serves ``tau = 1`` and ``d <= gpu_kernels.ACYCLIC_GRAD_MAX_D``
    (raises ``ValueError`` otherwise)."""
    _check_n_vars(scores, n_vars)
    if tau != 1.0:
        raise ValueError(
            f"the fused acyclicity gradient serves tau = 1 only (got "
            f"tau={tau}): it draws g in the tau = 1 form sigmoid(logit(u) + "
            "alpha s), as the TPU kernel does, so another tau would scale a "
            "gradient it did not sample")
    return gpu_kernels.acyclic_grad(scores, seed, alpha, kmc, eps=eps)


def engine_acyclic_grad(scores: torch.Tensor, seed: int, alpha: float, *,
                        n_vars: int, kmc: int,
                        eps: torch.Tensor | None = None) -> torch.Tensor:
    """The same estimate through the engine's route: the sampler writes the
    ``[P, kmc, d, d]`` soft samples (stream 0 of ``seed``, or ``eps``),
    :func:`acyclic_constr` runs the batched power chain, and autograd takes
    the closed-form backward with cotangent ``1/kmc``."""
    _check_n_vars(scores, n_vars)
    with torch.enable_grad():
        s = scores.detach().requires_grad_(True)
        h = acyclic_constr(sample_soft_graphs(s, seed, 0, alpha, 1.0, kmc,
                                              eps=eps))
        (grad,) = torch.autograd.grad(h, s, torch.full_like(h, 1.0 / kmc))
    return grad


def mc_disagreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """``mean |a - b| / mean |b|``: the microbenchmark's agreement of two
    Monte Carlo estimates of the same expectation."""
    return float((a - b).abs().mean() / b.abs().mean())


def _time_ms(fn, device):
    fn()  # warm-up (and, on the card, the kernels' build)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_CALLS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / TIMED_CALLS
    t0 = time.perf_counter()
    for _ in range(TIMED_CALLS):
        fn()
    return 1e3 * (time.perf_counter() - t0) / TIMED_CALLS


def main(argv=None) -> dict:
    """The microbenchmark; returns the printed numbers as a dict."""
    ap = argparse.ArgumentParser(
        prog="python -m dibs_tpu_torch.ops.acyclic_kernel",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--p", type=int, default=1000)
    ap.add_argument("--kmc", type=int, default=8)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    gen = torch.Generator().manual_seed(0)
    scores = (0.5 * torch.randn((args.p, args.d, args.d), generator=gen)
              ).to(device)
    alpha, d, kmc = 0.2, args.d, args.kmc
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain versions)")

    t_fused = _time_ms(lambda: fused_acyclic_grad(
        scores, 7, alpha, n_vars=d, kmc=kmc), device)
    print(f"fused on-chip chain (kernel #9): {t_fused:9.3f} ms  [{where}]",
          flush=True)
    t_engine = _time_ms(lambda: engine_acyclic_grad(
        scores, 7, alpha, n_vars=d, kmc=kmc), device)
    print(f"engine route (sampler + batched chain + autograd): "
          f"{t_engine:9.3f} ms", flush=True)
    print(f"speedup: {t_engine / t_fused:.2f}x", flush=True)

    # statistical sanity: two Monte Carlo estimates of the same expectation
    # from different draws agree loosely
    head = scores[:64]
    a = fused_acyclic_grad(head, 7, alpha, n_vars=d, kmc=64)
    b = engine_acyclic_grad(head, 9, alpha, n_vars=d, kmc=64)
    ratio = mc_disagreement(a, b)
    print(f"mean |diff| / mean |engine| over 64-sample MC: {ratio:.3f}",
          flush=True)
    return dict(fused_ms=t_fused, engine_ms=t_engine, mc_disagreement=ratio,
                device=where)


if __name__ == "__main__":
    main()
