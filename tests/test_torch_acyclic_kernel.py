"""Kernel #9, the fused acyclicity gradient, and its microbenchmark entry
point, against ``benchmarks/bench_acyclic_kernel.py`` on the CPU.

The TPU kernel itself cannot be the oracle here: interpreted on the CPU its
hardware PRNG yields degenerate uniforms (every g ~ 0), and
``interpret=True`` has no lowering for ``prng_seed``. So the port's plain
version is held to the microbenchmark's own comparator, ``xla_grad`` (the
XLA sampler on the CPU, since Pallas is off there), with the reference's
Logistic draw ``random.logistic(key, [P, K, d, d])`` injected.

Tolerance: ``1e-4 * max(1, max|ref|)`` per element at the conftest's
HIGHEST matmul precision (float32 chains of up to 8 products summed in
another order).
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu_torch.ops import acyclic_kernel as ak
from dibs_tpu_torch.ops import gpu_kernels as gk

torch.set_num_threads(1)

_BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "bench_acyclic_kernel.py")


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench_acyclic_kernel",
                                                  _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scores(p, d, alpha, seed):
    """0.5 N(0, 1) scores; particle 0's first row reaches below -88/alpha,
    where exp(-alpha s) overflows float32."""
    s = (0.5 * np.random.default_rng(seed).normal(size=(p, d, d))
         ).astype(np.float32)
    s[0, 0, 1:] = -100.0 / alpha
    return s


def _bar(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("alpha", [0.2, 2.0])
@pytest.mark.parametrize("d", [5, 8, 13])
def test_plain_version_matches_the_xla_route(bench, d, alpha):
    p, kmc = 3, 4
    s = _scores(p, d, alpha, seed=d)
    key = random.PRNGKey(d)
    ref = np.asarray(bench.xla_grad(jnp.asarray(s), key, alpha, n_vars=d,
                                    kmc=kmc))
    eps = torch.from_numpy(np.array(random.logistic(key, (p, kmc, d, d))))
    got = ak.fused_acyclic_grad(torch.from_numpy(s), 0, alpha, n_vars=d,
                                kmc=kmc, eps=eps).numpy()
    assert np.isfinite(got).all()
    # the late-annealing rows: exp overflow gives g = 0, not NaN
    assert np.all(got[0, 0, 1:] == 0.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(ref))
    # the port's engine route on the same draw
    eng = ak.engine_acyclic_grad(torch.from_numpy(s), 0, alpha, n_vars=d,
                                 kmc=kmc, eps=eps).numpy()
    np.testing.assert_allclose(eng, ref, rtol=0, atol=_bar(ref))


@pytest.mark.parametrize("d", [8, 13])
def test_philox_draws_match_their_logits_injected(d):
    """The fast form on the Philox uniforms against ``eps = logit(u)``
    injected (the sigmoid form), and against the engine route, whose
    sampler draws the same uniforms from the same seed and stream."""
    p, kmc, alpha, seed = 3, 4, 0.2, 5
    s = torch.from_numpy(_scores(p, d, alpha, seed=1))
    u = gk.philox_uniform((p, kmc, d, d), seed, 0, "cpu")
    fused = ak.fused_acyclic_grad(s, seed, alpha, n_vars=d, kmc=kmc)
    injected = ak.fused_acyclic_grad(s, seed, alpha, n_vars=d, kmc=kmc,
                                     eps=torch.log(u) - torch.log1p(-u))
    engine = ak.engine_acyclic_grad(s, seed, alpha, n_vars=d, kmc=kmc)
    assert torch.isfinite(fused).all()
    for other in (injected, engine):
        bar = 1e-4 * max(1.0, float(other.abs().max()))
        assert float((fused - other).abs().max()) <= bar
    # another seed draws other samples
    assert float((ak.fused_acyclic_grad(s, seed + 1, alpha, n_vars=d,
                                        kmc=kmc) - fused).abs().max()) > 1e-3


def test_gradient_is_the_transposed_chain():
    """One sample, d=4, by hand: R^T * alpha g (1 - g), not R."""
    d, alpha = 4, 0.7
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.normal(size=(1, d, d)).astype(np.float32))
    eps = torch.from_numpy(rng.logistic(size=(1, 1, d, d)).astype(np.float32))
    g = torch.sigmoid(eps[0, 0] + alpha * s[0]) * (1 - torch.eye(d))
    r = torch.linalg.matrix_power(torch.eye(d) + g / d, d - 1)
    want = r.T * alpha * g * (1 - g)
    got = gk.acyclic_grad(s, 0, alpha, 1, eps=eps)[0]
    assert float((got - want).abs().max()) <= 1e-6
    assert float((r - r.T).abs().max()) > 1e-3  # the transpose matters here


@pytest.mark.parametrize("d", [1, 2, 137, 139])
def test_edge_sizes_run(d):
    """The chain's trivial cases and the kernel's widest shapes (the plain
    version here; the card runs 137 in chip_smoke.py)."""
    s = torch.from_numpy(_scores(1, d, 0.2, seed=d))
    out = gk.acyclic_grad(s, 3, 0.2, 2)
    assert out.shape == (1, d, d) and torch.isfinite(out).all()
    assert float(out.diagonal(dim1=-2, dim2=-1).abs().max()) == 0.0
    if d == 1:
        assert float(out.abs().max()) == 0.0


@pytest.mark.parametrize("kwargs, match", [
    (dict(d=8, tau=0.5), "tau = 1 only"),
    (dict(d=gk.ACYCLIC_GRAD_MAX_D + 1, tau=1.0), "d <= 139"),
])
def test_wrapper_rejects_what_the_kernel_does_not_serve(kwargs, match):
    d = kwargs["d"]
    s = torch.zeros(1, d, d)
    with pytest.raises(ValueError, match=match):
        ak.fused_acyclic_grad(s, 0, 0.2, n_vars=d, kmc=2, tau=kwargs["tau"])
    with pytest.raises(ValueError, match="eps must be"):
        gk.acyclic_grad(torch.zeros(1, 5, 5), 0, 0.2, 2,
                        eps=torch.zeros(1, 3, 5, 5))
    with pytest.raises(ValueError, match="expected d = 6"):
        ak.fused_acyclic_grad(torch.zeros(1, 5, 5), 0, 0.2, n_vars=6, kmc=2)


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ak.main(["--p", "2", "--d", "4", "--kmc", "2"])


def test_entry_point_runs_on_the_cpu(capsys):
    out = ak.main(["--device", "cpu", "--p", "4", "--d", "8", "--kmc", "4"])
    printed = capsys.readouterr().out
    for line in ("fused on-chip chain (kernel #9)", "engine route",
                 "speedup", "64-sample MC"):
        assert line in printed
    assert out["fused_ms"] > 0 and out["engine_ms"] > 0
    assert out["mc_disagreement"] < ak.MC_AGREEMENT_BAR


def test_monte_carlo_agreement_with_the_jax_route(bench):
    """The microbenchmark's statistical check: the port's 64-sample
    estimate (Philox draws) against the JAX route's (threefry draws) on the
    same scores. Independent estimates of the same mean differ by ~0.08 of
    its size here (d = 8-32, repeated seeds); one 30% off fails. (At these
    scores R is nearly symmetric, so the transpose is pinned exactly by
    ``test_gradient_is_the_transposed_chain`` instead.)"""
    d, p = 12, 16
    s = (0.5 * np.random.default_rng(4).normal(size=(p, d, d))
         ).astype(np.float32)
    ours = ak.fused_acyclic_grad(torch.from_numpy(s), 7, 0.2, n_vars=d,
                                 kmc=64)
    ref = torch.from_numpy(np.asarray(bench.xla_grad(
        jnp.asarray(s), random.PRNGKey(9), 0.2, n_vars=d, kmc=64)))
    assert ak.mc_disagreement(ours, ref) < ak.MC_AGREEMENT_BAR
    assert ak.mc_disagreement(0.7 * ours, ref) > ak.MC_AGREEMENT_BAR


@pytest.mark.parametrize("d, want", [
    (1, ("quad", 4, 64, 4 * 3 * 4 * 64)),
    (5, ("quad", 4, 64, 4 * 3 * 8 * 64)),
    (64, ("quad", 4, 64, 4 * 3 * 64 * 64)),
    (65, ("quad", 8, 128, 4 * 3 * 68 * 128)),
    (128, ("quad", 8, 128, 196_608)),
    (129, ("strided", 9, 129, 4 * 3 * 129 * 129)),
    (139, ("strided", 9, 139, 231_852)),
])
def test_plan_picks_the_tier_stride_and_bytes(d, want):
    """The quad tier's tile and stride (16 threads a side times 4 or 8
    outputs; rows rounded up to a multiple of 4) up to d = 128, the strided
    first design (9 x 9 outputs a thread, stride d | 1) past it."""
    assert tuple(gk.acyclic_grad_plan(d)) == want


def test_plan_fits_shared_memory_at_every_d():
    for d in range(1, gk.ACYCLIC_GRAD_MAX_D + 1):
        plan = gk.acyclic_grad_plan(d)
        assert plan.smem_bytes <= 232_448, d
        assert plan.tier == ("quad" if d <= 128 else "strided"), d
        # a thread grid of 16 x 16 covers d with its tile
        assert d <= 16 * plan.tile and d <= plan.stride
        if plan.tier == "quad":
            # rows of the grid's width, whose column quads the swizzle
            # permutes in eights
            assert plan.stride == 16 * plan.tile and plan.stride % 32 == 0
    with pytest.raises(ValueError, match="d <= 139"):
        gk.acyclic_grad_plan(gk.ACYCLIC_GRAD_MAX_D + 1)
    with pytest.raises(ValueError, match="d <= 139"):
        gk.acyclic_grad(torch.zeros(1, 140, 140), 0, 0.2, 1)
