"""The yardstick's work counts: the float32 operations and the bytes each
of the port's CUDA kernels needs at a shape, the least time the card could
take for them, and the card's peaks.

A frozen copy of ``dibs_tpu_torch.accounting.kernel_cost`` / ``bound_ms``
as of the benchmark's first version (a test holds the copy equal to the
program's at every cell's shapes), kept here so that a change to the
program cannot move the measure it is judged by. The work is the same
whatever implements it: the operations each kernel's arithmetic needs and
its inputs read once and its outputs written once (float32, 4 bytes).

Peaks: one NVIDIA H100 SXM5 80 GB at its 700 W limit (NVIDIA's data sheet):
67 TFLOP/s of float32 outside the tensor cores, the rate of every engine
path (the engines refuse TF32), and 3.35 TB/s of HBM3.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["FP32_FLOPS", "HBM_BYTES_S", "kernel_cost", "bound_s"]

FP32_FLOPS = 67.0e12
HBM_BYTES_S = 3350.0e9


def _gumbel_graphs(*, p, m, d):
    return 3 * p * m * d * d, 4 * (p * d * d + p * m * d * d)


def _bge_pairs(*, parent_counts, graphs, d, datasets=1):
    """``parent_counts``: the parent count of every (graph, node) pair."""
    flops = sum(2.0 * (k ** 3 / 3 + k ** 2) for k in parent_counts)
    return flops, 4 * (datasets * d ** 3 + graphs * (d * d + 2 * d))


def _se_matrix(*, a, n, b=None, batch=1, triangle=False):
    if b is None:
        pairs = a * (a + 1) // 2 if triangle else a * a
        return 3 * batch * pairs * n, 4 * batch * (a * n + a * a)
    return 3 * batch * a * b * n, 4 * batch * (a * n + b * n + a * b)


def _transport_phi(*, p, n, n_mats=1, batch=1):
    return (2 * batch * n_mats * p * p * n,
            4 * batch * (3 * p * n + n_mats * p * p + n + p))


def _fused_linear(kind, *, p, m, n, d, datasets=1, replayed=None):
    if kind == "pass2":
        replayed = p * m if replayed is None else replayed
        flops = (2 * replayed * (4 * n * d * d + 2 * n * d)
                 + 2 * p * n * d * d)
    else:
        per = {"single": 4 * n * d * d + 6 * n * d,
               "pass1": 2 * n * d * d + 4 * n * d}[kind]
        flops = 2 * p * m * per + 2 * p * n * d * d
    n_bytes = 4 * (2 * p * d * d + 2 * datasets * n * d)
    if kind != "single":
        n_bytes += 4 * 2 * p * m
    if kind != "pass1":
        n_bytes += 4 * 2 * p * d * d
    return flops, n_bytes


def _fused_nonlinear(*, p, m, n, d, h1, datasets=1):
    flops = 2 * p * m * 4 * h1 * n * d * d + p * 2 * h1 * n * d * d
    inputs = p * ((h1 + 2) * d * d + (2 * h1 + 1) * d) + 2 * datasets * n * d
    outputs = p * ((h1 + 1) * d * d + (2 * h1 + 1) * d)
    return flops, 4 * (inputs + outputs)


def _acyclic_grad(*, p, d, k):
    n = d - 1
    products = max(n.bit_count() - 1, 0) + max(n.bit_length() - 1, 0)
    return 2 * d ** 3 * products * p * k, 2 * 4 * p * d * d


_COSTS = {
    "gumbel_graphs": _gumbel_graphs,
    "bge_pairs": _bge_pairs,
    "se_matrix": _se_matrix,
    "transport_phi": _transport_phi,
    "fused_linear_single": lambda **s: _fused_linear("single", **s),
    "fused_linear_pass1": lambda **s: _fused_linear("pass1", **s),
    "fused_linear_pass2": lambda **s: _fused_linear("pass2", **s),
    "fused_linear_wide_pass1": lambda **s: _fused_linear("pass1", **s),
    "fused_linear_wide_pass2": lambda **s: _fused_linear("pass2", **s),
    "fused_nonlinear": _fused_nonlinear,
    "acyclic_grad": _acyclic_grad,
}


def kernel_cost(kernel: str, **shape) -> Tuple[float, float]:
    """``(flops, bytes)`` of one call of ``kernel`` at ``shape`` (the
    shapes of ``dibs_tpu_torch.accounting.kernel_cost``; ``bge_pairs``
    takes the parent counts of its pairs instead of the masks)."""
    return _COSTS[kernel](**shape)


def bound_s(flops: float, n_bytes: float) -> float:
    """The least seconds the card could take: the larger of ``flops`` at
    the float32 peak and ``n_bytes`` at the memory rate."""
    return max(flops / FP32_FLOPS, n_bytes / HBM_BYTES_S)
