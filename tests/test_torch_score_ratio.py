"""The REINFORCE ratio by linearity (kernel #10's route): the ``score``
estimator forms ``R = alpha (sum_m w_m G_m - (sum_m w_m) p)`` in one pass
over the hard graphs and chains it to ``Z``, where the per-sample route
made ``grad_Z log p(G_m | Z)`` for every sample and took their signed
logsumexp. Both are held to each other, on the CPU, through the engine's
estimator (marginal hook, a fleet of two datasets) and through the plain
twin (``gpu_kernels.score_ratio_plain``) summed over ``"mc"`` blocks, at
``1e-5 max(1, max|ref|)``; an empty denominator gives 0, and a baseline
200 nats above the samples is non-finite on exactly the particles where
the per-sample route is.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_score_ratio.py -q
"""
import math

import numpy as np
import pytest
import torch

from dibs_tpu_torch import profiling
from dibs_tpu_torch.inference.estimators import (
    EstimatorConfig,
    _ratio_log_weights,
    _ratio_weights,
    _scores_to_z,
    make_estimators,
    stable_ratio_grad,
)
from dibs_tpu_torch.ops.edges import (
    edge_probs,
    edge_scores,
    grad_latent_log_prob_batch,
)
from dibs_tpu_torch.ops.gpu_kernels import score_ratio_plain
from dibs_tpu_torch.ops.soft_graphs import sample_hard_graphs
from dibs_tpu_torch.utils.func import expand_by

torch.set_num_threads(1)

K_LAT, N, T = 5, 6, 3
ALPHA_LINEAR = 0.4


def per_sample_route(zs, baselines, g, logprobs, alpha, c):
    """The ratio as the per-sample route computed it: every sample's
    ``grad_Z log p(G_m | Z)``, then ``stable_ratio_grad`` with the same
    centring and signed EMA baseline."""
    grad_z = grad_latent_log_prob_batch(g, zs, alpha)
    log_w, sign_w, centred = _ratio_log_weights(logprobs, baselines, c)
    return stable_ratio_grad(log_w, centred, expand_by(sign_w, 3) * grad_z)


def problem(seed, p, m, d, datasets=1, scale=3.0):
    """Particles, injected noise and a per-node hook whose scores depend on
    each graph (a fixed random weight a possible edge, ``scale`` nats)."""
    rng = np.random.default_rng(seed)
    zs = torch.from_numpy(rng.normal(size=(datasets * p, d, K_LAT, 2))
                          .astype(np.float32))
    u = rng.uniform(1e-6, 1 - 1e-6, size=(datasets * p, m, d, d))
    eps = torch.from_numpy((np.log(u) - np.log1p(-u)).astype(np.float32))
    weight = torch.from_numpy((scale * rng.normal(size=(d, d)))
                              .astype(np.float32))

    def hook(gs, theta, x, mask, rng_):
        return (gs * weight).sum(-2)

    shape = (datasets, N, d) if datasets > 1 else (N, d)
    x = torch.zeros(shape)
    return zs, eps, hook, x


def run_estimator(zs, eps, hook, x, m, c, baselines):
    est = make_estimators(
        cfg=EstimatorConfig(alpha_linear=ALPHA_LINEAR, n_grad_mc_samples=m,
                            grad_estimator_z="score",
                            score_function_baseline=c),
        log_graph_prior=lambda soft_g: soft_g.sum((-1, -2)), x=x,
        interv_mask=torch.zeros_like(x), batched_node_log_joint_prob=hook)
    return est.eltwise_grad_z_likelihood(zs, None, baselines, T, 0, 0,
                                         eps=eps)[0]


CASES = {
    # name: (c, d, M, P, datasets, "mc" blocks, what the log-probs are)
    "c0_d8_m7": (0.0, 8, 7, 3, 1, 1, "graphs"),
    "c05_d8_m7": (0.5, 8, 7, 3, 1, 1, "graphs"),
    "c0_d20_m64": (0.0, 20, 64, 3, 1, 1, "graphs"),
    "c05_d20_m64": (0.5, 20, 64, 3, 1, 1, "graphs"),
    "c0_d130_m7": (0.0, 130, 7, 3, 1, 1, "graphs"),
    "c05_d130_m64": (0.5, 130, 64, 3, 1, 1, "graphs"),
    "fleet2_c0_d8_m7": (0.0, 8, 7, 3, 2, 1, "graphs"),
    "fleet2_c05_d20_m64": (0.5, 20, 64, 3, 2, 1, "graphs"),
    "mc2_c0_d20_m64": (0.0, 20, 64, 3, 1, 2, "graphs"),
    "mc4_c05_d8_m64": (0.5, 8, 64, 3, 1, 4, "graphs"),
    "empty_denominator_c0": (0.0, 8, 7, 3, 1, 1, "-inf"),
    "far_above_c05": (0.5, 20, 64, 3, 1, 1, "200 below the baseline"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ratio_by_linearity_matches_the_per_sample_route(name):
    c, d, m, p, datasets, blocks, kind = CASES[name]
    seed = sorted(CASES).index(name)
    zs, eps, hook, x = problem(seed, p, m, d, datasets)
    alpha = ALPHA_LINEAR * T
    g = sample_hard_graphs(edge_scores(zs), 0, 0, alpha, m, eps=eps)
    logprobs = hook(g, None, None, None, None).double().sum(-1).float()
    baselines = logprobs.mean(1) - 1.0
    if kind == "-inf":
        hook = lambda gs, *a: torch.full(gs.shape[:-1], -math.inf)  # noqa
        logprobs = torch.full_like(logprobs, -math.inf)
    elif kind == "200 below the baseline":
        baselines = logprobs.max(1).values + 200.0
    want = per_sample_route(zs, baselines, g, logprobs, alpha, c)

    if blocks == 1:
        got = run_estimator(zs, eps, hook, x, m, c, baselines)
    else:
        # a "mc" rank's block of the samples, with its slice of the
        # weights; the blocks' products summed, as over the "mc" group
        w = _ratio_weights(logprobs, baselines, c)
        prob, n = edge_probs(zs, alpha), m // blocks
        got = sum(_scores_to_z(score_ratio_plain(
            g[:, j * n:(j + 1) * n].contiguous(),
            w[:, j * n:(j + 1) * n].contiguous(), prob, alpha), zs)
            for j in range(blocks))

    if kind == "-inf":
        assert torch.equal(want, torch.zeros_like(want))
        assert torch.equal(got, torch.zeros_like(got))
    elif kind == "200 below the baseline":
        finite = torch.isfinite(want).flatten(1).all(1)
        assert not finite.any()
        assert torch.equal(torch.isfinite(got).flatten(1).all(1), finite)
    else:
        assert torch.isfinite(want).all() and want.abs().max() > 0
        err = float((got - want).abs().max())
        assert err <= 1e-5 * max(1.0, float(want.abs().max())), err


def test_plain_twin_is_the_float64_formula_with_a_zero_diagonal():
    rng = np.random.default_rng(0)
    p, m, d = 2, 9, 7
    g = torch.from_numpy((rng.uniform(size=(p, m, d, d)) < 0.4)
                         .astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(p, m)).astype(np.float32))
    prob = torch.from_numpy(rng.uniform(size=(p, d, d)).astype(np.float32))
    got = score_ratio_plain(g, w, prob, 0.7)
    want = 0.7 * (torch.einsum("pmij,pm->pij", g.double(), w.double())
                  - w.double().sum(1)[:, None, None] * prob.double())
    want = want * (1 - torch.eye(d, dtype=torch.float64))
    assert got.dtype == torch.float32
    assert torch.equal(got, want.float())
    with pytest.raises(ValueError, match="w must be"):
        score_ratio_plain(g, w[:, 1:], prob, 0.7)
    with pytest.raises(ValueError, match="prob must be"):
        score_ratio_plain(g, w, prob[:, 1:], 0.7)
    with pytest.raises(ValueError, match="g must be"):
        score_ratio_plain(g[..., 1:], w, prob, 0.7)


def test_the_route_counts_one_call_a_ratio_under_a_profiler():
    zs, eps, hook, x = problem(0, 2, 4, 6)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            run_estimator(zs, eps, hook, x, 4, 0.0,
                          torch.zeros(zs.shape[0]))
    assert profiling.counters().get("score_ratio.calls") == 3
