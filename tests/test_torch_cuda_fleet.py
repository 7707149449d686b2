"""The fleet's batched kernels and step on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. Imports no JAX, so it runs on a machine that has only torch::

    python -m pytest tests/test_torch_cuda_fleet.py -m cuda -q --noconftest

Kernels #1-#4 with a leading dataset axis against their plain twins with
the axis (#1 hard exact off ties and soft within 1e-5, #2 bitwise, #3 atol
1e-5, #4 within 1e-4 max(1, max|ref|)) and against their unbatched launches
on each dataset (#1-#3 bitwise, #4 within its bar), at ``B = 1``, ``B`` not
a power of two and the fleet sizes, #2 on both sides of d = 32 and of every
block frame; the fused joint kernels #5-#8 with the axis against their
plain versions and their unbatched launches (within 1e-4 max(1,
max|ref|)), #8 also at every gate edge with ``B = 1`` and ``3`` and in
each of its 16 instantiations (``chip_smoke.FLEET_NL_CASES``), the wide
passes at d = 75 and 128 (``chip_smoke.FLEET_WIDE_CASES``); the fleet
step's launches against one dataset's step, its
``phi`` against single engines and against the plain versions on the CPU,
marginal and joint.
"""
import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dibs_tpu_torch.fleet import (  # noqa: E402
    fleet_init_state,
    fleet_sample,
    fleet_seeds,
)
from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS  # noqa: E402
from dibs_tpu_torch.inference import fused_linear as fl  # noqa: E402
from dibs_tpu_torch.inference import fused_nonlinear as fnl  # noqa: E402
from dibs_tpu_torch.models import (  # noqa: E402
    BGe,
    DenseNonlinearGaussian,
    ErdosReniDAGDistribution,
    LinearGaussian,
)
from dibs_tpu_torch.ops import gpu_kernels as gk  # noqa: E402
from dibs_tpu_torch.ops import transport_kernel as tk  # noqa: E402
from dibs_tpu_torch.ops.bge_kernel import (  # noqa: E402
    bge_logdet_pairs,
    bge_logdet_pairs_plain,
)
from dibs_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    gk.build()
    return torch.device("cuda:0")


def _rand(rng, shape, dev, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape))
                            .astype(np.float32)).to(dev)


@pytest.mark.parametrize("n_ds", [1, 3, 8])
@pytest.mark.parametrize("d", [5, 20])
def test_sampler_takes_a_key_a_dataset(cuda, n_ds, d):
    rng = np.random.default_rng(n_ds * 100 + d)
    p = 6
    keys = fleet_seeds(d, n_ds).to(cuda)
    scores = _rand(rng, (n_ds * p, d, d), cuda, 2.0)
    for hard, m in ((True, 16), (False, 8)):
        out = gk.gumbel_graphs(scores, keys, 5, 1.3, 1.0, m, hard)
        ref = gk.gumbel_graphs_plain(scores, keys, 5, 1.3, 1.0, m, hard)
        if hard:
            u = gk.philox_uniform((n_ds * p, m, d, d), keys, 5, cuda)
            logit = torch.log(u) - torch.log1p(-u) + 1.3 * scores[:, None]
            assert int((((out - ref).abs() > 0)
                        & (logit.abs() >= 1e-5)).sum()) == 0
        else:
            assert float((out - ref).abs().max()) <= 1e-5
        for i, seed in enumerate(keys.tolist()):
            one = gk.gumbel_graphs(scores[i * p:(i + 1) * p], seed, 5, 1.3,
                                   1.0, m, hard)
            assert torch.equal(one, out[i * p:(i + 1) * p])


def test_sampler_rejects_bad_keys(cuda):
    scores = torch.zeros((6, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="split"):
        gk.gumbel_graphs(scores, torch.zeros(4, dtype=torch.int64,
                                             device=cuda), 0, 1.0, 1.0, 2,
                         True)
    with pytest.raises(ValueError, match="int64"):
        gk.gumbel_graphs(scores, torch.zeros(3, dtype=torch.int32,
                                             device=cuda), 0, 1.0, 1.0, 2,
                         True)


def _k_edge_graph(rng, d, edges=(0, 1, 15, 16, 31, 32, 33, 47, 48, 63, 64,
                                 95, 96, 127)):
    g = np.zeros((d, d), np.float32)
    for j in range(d):
        k = min(edges[j % len(edges)], d - 1)
        others = np.delete(np.arange(d), j)
        g[rng.choice(others, size=k, replace=False), j] = 1.0
    return g


@pytest.mark.parametrize("n_ds", [1, 3])
@pytest.mark.parametrize("d", [2, 20, 32, 33, 48, 64, 65, 96, 97, 128])
def test_bge_pairs_read_each_datasets_matrices(cuda, n_ds, d):
    rng = np.random.default_rng(d + 1000 * n_ds)
    n_g = 12 if d <= 64 else 4
    x = _rand(rng, (n_ds, 60, d), cuda)
    r_mats, _ = BGe(n_vars=d, device=cuda)._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    r_mats = r_mats.contiguous()
    gs = (rng.uniform(size=(n_ds * n_g, d, d)) < 0.3).astype(np.float32)
    gs[:, np.arange(d), np.arange(d)] = 0.0
    for i in range(n_ds):
        gs[i * n_g] = _k_edge_graph(rng, d)
        gs[i * n_g + 1] = 1.0 - np.eye(d, dtype=np.float32)
    gs_t = torch.from_numpy(gs).to(cuda)
    pa, full = bge_logdet_pairs(r_mats, gs_t)
    pa_p, full_p = bge_logdet_pairs_plain(r_mats, gs_t)
    assert torch.equal(pa, pa_p) and torch.equal(full, full_p)
    for i in range(n_ds):
        sl = slice(i * n_g, (i + 1) * n_g)
        one = bge_logdet_pairs(r_mats[i], gs_t[sl])
        assert torch.equal(one[0], pa[sl]) and torch.equal(one[1], full[sl])


@pytest.mark.parametrize("n_ds", [1, 3, 8])
@pytest.mark.parametrize("p,n", [(30, 800), (100, 32768), (130, 260),
                                 (7, 13)])
def test_se_matrix_one_matrix_a_dataset(cuda, n_ds, p, n):
    rng = np.random.default_rng(p + n + n_ds)
    z = _rand(rng, (n_ds, p, n), cuda, 0.05)
    k_mat = gk.se_matrix(z, z, 5.0, 1.0)
    assert float((k_mat - gk.se_matrix_plain(z, z, 5.0, 1.0)).abs().max()) \
        <= 1e-5
    for i in range(n_ds):
        zi = z[i].contiguous()
        assert torch.equal(gk.se_matrix(zi, zi, 5.0, 1.0), k_mat[i])
    y = _rand(rng, (n_ds, p + 3, n), cuda, 0.05)  # not symmetric
    k_xy = gk.se_matrix(z, y, 5.0, 0.7)
    for i in range(n_ds):
        assert torch.equal(gk.se_matrix(z[i], y[i], 5.0, 0.7), k_xy[i])


@pytest.mark.parametrize("n_ds", [1, 3, 8])
@pytest.mark.parametrize("p,n,joint", [(30, 800, False), (32, 256, True),
                                       (7, 130, True), (130, 64, False)])
def test_transport_one_family_a_dataset(cuda, n_ds, p, n, joint):
    gen = torch.Generator(device=cuda).manual_seed(p + n)

    def kmat():
        x = torch.randn(n_ds, p, 8, generator=gen, device=cuda) / 4.0
        return torch.exp(-torch.cdist(x, x).square())

    k_own = kmat()
    k_other = kmat() if joint else None
    g = torch.randn(n_ds, p, n, generator=gen, device=cuda)
    v = 3.0 + torch.randn(n_ds, p, n, generator=gen, device=cuda)
    mu = v.mean(dim=1, keepdim=True)
    got = tk.transport_phi(k_own, k_other, g, v, c=-0.4, mu=mu)
    want = tk.transport_phi_plain(k_own, k_other, g, v, c=-0.4, mu=mu)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    for i in range(n_ds):
        one = tk.transport_phi(k_own[i], None if k_other is None
                               else k_other[i], g[i], v[i], c=-0.4, mu=mu[i])
        assert float((one - got[i]).abs().max()) <= tol


def _engines(dev, n_ds, estimator, d=8, n_obs=15):
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.normal(size=(n_ds, n_obs, d))
                          .astype(np.float32))

    def make(x, device):
        return MarginalDiBS(
            x=x, graph_model=ErdosReniDAGDistribution(d, n_edges_per_node=1),
            likelihood_model=BGe(n_vars=d, device=device),
            grad_estimator_z=estimator, n_grad_mc_samples=16,
            n_acyclicity_mc_samples=8, device=device)

    return xs, make


@pytest.mark.parametrize("estimator", ["score", "score_rb"])
def test_fleet_step_launches_and_matches_single_engines(cuda, estimator):
    n_ds, p = 3, 4
    xs, make = _engines(cuda, n_ds, estimator)
    fleet = make(xs[0], cuda)
    std = fleet._resolve_latent_std(8)
    masks = torch.zeros(xs.shape, dtype=torch.int32, device=cuda)
    phi_fleet = fleet._make_fleet_phi(xs.to(cuda), masks, std)
    step = fleet._make_step(std, phi_fn=phi_fleet)
    seeds = fleet_seeds(11, n_ds)
    singles = [make(x, cuda) for x in xs]
    state = fleet_init_state(fleet, seeds, p)
    for t in range(4):
        for name in gk.LAUNCHES:
            gk.LAUNCHES[name] = 0
        with torch.no_grad():
            got, _ = phi_fleet(state)
        fleet_launches = dict(gk.LAUNCHES)
        for i, single in enumerate(singles):
            for name in gk.LAUNCHES:
                gk.LAUNCHES[name] = 0
            one = state._replace(seed=int(seeds[i]), z=state.z[i],
                                 sf_baseline=state.sf_baseline[i])
            with torch.no_grad():
                want, _ = single._make_phi(std)(one)
            assert dict(gk.LAUNCHES) == fleet_launches
            tol = 1e-4 * float(want.abs().max())
            assert float((got[i] - want).abs().max()) <= tol, (t, i)
        state = step(state)
    assert fleet_launches["bge_pairs"] == 1


def test_fleet_on_card_matches_plain_versions_on_cpu(cuda):
    n_ds, p, d = 3, 4, 8
    xs, make = _engines(cuda, n_ds, "score")
    card, cpu = make(xs[0], cuda), make(xs[0], "cpu")
    std = card._resolve_latent_std(d)
    masks = torch.zeros(xs.shape, dtype=torch.int32)
    phi_card = card._make_fleet_phi(xs.to(cuda), masks.to(cuda), std)
    phi_cpu = cpu._make_fleet_phi(xs, masks, std)
    step = card._make_step(std, phi_fn=phi_card)
    state = fleet_init_state(card, fleet_seeds(2, n_ds), p)
    rng = np.random.default_rng(9)
    for _ in range(3):
        noise = tuple(torch.from_numpy(rng.logistic(size=s).astype(
            np.float32)) for s in ((n_ds, p, 16, d, d), (n_ds, p, 8, d, d)))
        on_cpu = state._replace(seed=state.seed.cpu(), z=state.z.cpu(),
                                sf_baseline=state.sf_baseline.cpu())
        with torch.no_grad():
            a, _ = phi_card(state, tuple(e.to(cuda) for e in noise))
            b, _ = phi_cpu(on_cpu, noise)
        for i in range(n_ds):
            tol = 1e-4 * float(b[i].abs().max())
            assert float((a[i].cpu() - b[i]).abs().max()) <= tol
        state = step(state, tuple(e.to(cuda) for e in noise))
    gs = fleet_sample(card, xs=xs, seed=2, n_particles=p, steps=3)
    assert gs.shape == (n_ds, p, d, d) and gs.device.type == "cuda"


def _close(got, want):
    for a, b in zip(got, want):
        tol = 1e-4 * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("n_ds", [1, 3, 8])
@pytest.mark.parametrize("name", ["single", "pass1", "pass2", "mlp"])
@pytest.mark.parametrize("d,n_obs", [(20, 100), (7, 130)])
def test_fused_kernels_read_each_datasets_data_and_key(cuda, n_ds, name, d,
                                                       n_obs):
    rng = np.random.default_rng(n_ds + d)
    p, m = 5, 12
    scores = _rand(rng, (n_ds * p, d, d), cuda)
    x = _rand(rng, (n_ds, n_obs, d), cuda)
    w = torch.from_numpy((rng.uniform(size=(n_ds, n_obs, d)) > 0.2)
                         .astype(np.float32)).to(cuda)
    keys = fleet_seeds(d, n_ds).to(cuda)
    if name == "mlp":
        model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(5,))
        lead = (scores, *fnl.kernel_layout(model.sample_parameters(
            generator=torch.Generator().manual_seed(n_ds), n_vars=d,
            n_particles=n_ds * p, device=cuda), model))
        kern, plain = fnl.fused_nonlinear, fnl.fused_nonlinear_plain
    else:
        model = LinearGaussian(n_vars=d)
        lead = (scores, _rand(rng, (n_ds * p, d, d), cuda))
        kern, plain = {"single": (fl.fused_linear_single,
                                  fl.fused_linear_single_plain),
                       "pass1": (fl.fused_linear_pass1,
                                 fl.fused_linear_pass1_plain),
                       "pass2": (fl.fused_linear_pass2,
                                 fl.fused_linear_pass2_plain)}[name]
    extra = ()
    if name == "pass2":
        extra = (tuple(torch.softmax(_rand(rng, (n_ds * p, m), cuda), 1)
                       for _ in range(2)),)
    kw = dict(seed=keys, streams=(3, 4), alpha=1.5, tau=1.0, n_samples=m,
              model=model)
    got = kern(*lead, x, w, *extra, **kw)
    _close(got, plain(*lead, x, w, *extra, **kw))
    for i, seed in enumerate(keys.tolist()):
        sl = slice(i * p, (i + 1) * p)
        one = kern(*(t[sl] for t in lead), x[i], w[i],
                   *(tuple(t[sl] for t in e) for e in extra),
                   **dict(kw, seed=seed))
        _close([a[sl] for a in got], one)


@pytest.mark.parametrize("n_ds,p,d,n,blocks,m", chip_smoke.FLEET_WIDE_CASES)
def test_wide_passes_read_each_datasets_data_and_key(cuda, n_ds, p, d, n,
                                                     blocks, m):
    """Wide passes 1 and 2's fleet builds (``kFleet``) at d = 75, N = 600
    (tiled rows, interventional) and d = 128, N = 100 with B = 1 and 3:
    against their plain versions with the dataset axis and their
    unbatched launches on each dataset, within 1e-4 max(1, max|ref|); two
    calls bitwise equal (:func:`chip_smoke.check_fleet_wide`)."""
    rng = np.random.default_rng(10 * n_ds + d)
    chip_smoke.check_fleet_wide(cuda, rng, n_ds, p, d, n, blocks, m)


@pytest.mark.parametrize("n_ds,p,d,n,h1,blocks,m,activation",
                         chip_smoke.FLEET_NL_CASES)
def test_fused_nonlinear_fleet_gate_edges(cuda, n_ds, p, d, n, h1, blocks, m,
                                          activation):
    """#8's fleet build at the gate's edges with B = 1 and 3 and in each of
    its 16 instantiations (hidden widths 5, 16, 4 and 8 x the four
    activations) against its plain version and its unbatched launch on
    each dataset, within 1e-4 max(1, max|ref|). A kernel fault poisons the
    process's CUDA context, so on a new build run each case in a process
    of its own (its node id)."""
    rng = np.random.default_rng(100 * n_ds + d)
    chip_smoke.check_fleet_nonlinear(cuda, rng, n_ds, p, d, n, h1, blocks, m,
                                     activation)


@pytest.mark.parametrize("model", ["linear", "linear two-pass", "mlp",
                                   "score", "score baseline", "median",
                                   "mlp (3, 3)", "wide"])
def test_joint_fleet_step_launches_and_matches_single_engines(cuda, model):
    """A joint fleet step (the fused routes of both tiers, the generic
    route, joint ``score`` and median bandwidths) launches each kernel as
    often as one dataset's step, and each dataset's ``phi`` is a single
    engine's on its data within 1e-4 max|phi|."""
    n_ds, p = 3, 4
    d = 75 if model == "wide" else 8
    rng = np.random.default_rng(6)
    xs = torch.from_numpy(rng.normal(size=(n_ds, 20, d)).astype(np.float32))
    kw = {"score": dict(grad_estimator_z="score"),
          "score baseline": dict(grad_estimator_z="score",
                                 score_function_baseline=0.5),
          "median": dict(kernel_param=dict(h_latent="median",
                                           h_theta="median")),
          "linear two-pass": dict(fused_single_pass=False)}.get(model, {})

    def make(x):
        lik = (DenseNonlinearGaussian(n_vars=d, hidden_layers=(
                   (3, 3) if model == "mlp (3, 3)" else (5,)))
               if model.startswith("mlp") else LinearGaussian(n_vars=d))
        with warnings.catch_warnings():  # the generic route warns
            warnings.simplefilter("ignore", UserWarning)
            return JointDiBS(
                x=x, graph_model=ErdosReniDAGDistribution(
                    d, n_edges_per_node=1),
                likelihood_model=lik, n_grad_mc_samples=16,
                n_acyclicity_mc_samples=8, device=cuda, **kw)

    fleet = make(xs[0])
    std = fleet._resolve_latent_std(d)
    masks = torch.zeros(xs.shape, dtype=torch.int32, device=cuda)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        transport = fleet._make_fleet_transport(xs.to(cuda), masks, std)
    step = fleet._make_step(std, transport_fn=transport)
    seeds = fleet_seeds(5, n_ds)
    singles = [make(x) for x in xs]
    state = fleet_init_state(fleet, seeds, p)
    for t in range(3):
        for name in gk.LAUNCHES:
            gk.LAUNCHES[name] = 0
        with torch.no_grad():
            phi_z, phi_t, _ = transport(state)
        fleet_launches = dict(gk.LAUNCHES)
        for i, single in enumerate(singles):
            for name in gk.LAUNCHES:
                gk.LAUNCHES[name] = 0
            one = state._replace(seed=int(seeds[i]), z=state.z[i],
                                 theta=tree_map(lambda a: a[i], state.theta),
                                 sf_baseline=state.sf_baseline[i])
            with torch.no_grad():
                want_z, want_t = single._make_phi(std)(one)
            assert dict(gk.LAUNCHES) == fleet_launches
            for a, b in [(phi_z[i], want_z)] + [
                    (a[i], b) for a, b in zip(tree_leaves(phi_t),
                                              tree_leaves(want_t))]:
                fin = torch.isfinite(b)  # joint score's baseline overflows
                assert torch.equal(torch.isfinite(a), fin), (t, i)
                tol = 1e-4 * float(b[fin].abs().max())
                assert float((a - b)[fin].abs().max()) <= tol, (t, i)
        state = step(state)
    fused = {"mlp": "fused_nonlinear", "linear": "fused_linear_single",
             "linear two-pass": "fused_linear_pass2", "median":
             "fused_linear_single", "wide": "fused_linear_wide_pass2"}
    if model in fused:
        assert fleet_launches[fused[model]] == 1
    else:  # joint score and the generic route launch no fused kernel
        assert not any(fleet_launches[k] for k in gk.LAUNCHES
                       if k.startswith("fused"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        gs, thetas = fleet_sample(fleet, xs=xs, seed=5, n_particles=p,
                                  steps=2)
    assert gs.shape == (n_ds, p, d, d)
    assert all(leaf.shape[:2] == (n_ds, p) for leaf in tree_leaves(thetas))


# #8's cluster tier in the fleet build: config 7's shape with B = 1 and 3,
# and the padded hidden widths (16, 4, 8) with the other activations
FLEET_NL_CLUSTER_CASES = ([(nb, 2, 50, 100, 5, 0, 5, "relu") for nb in (1, 3)]
                          + [(3, 2, 41, 30, 16, 0, 5, "sigmoid"),
                             (3, 2, 80, 100, 1, 0, 5, "tanh"),
                             (3, 2, 50, 100, 7, 0, 5, "leakyrelu")])


@pytest.mark.parametrize("n_ds,p,d,n,h1,blocks,m,activation",
                         FLEET_NL_CLUSTER_CASES)
def test_fused_nonlinear_fleet_cluster_tier(cuda, n_ds, p, d, n, h1, blocks,
                                            m, activation):
    """The cluster tier of #8's fleet build against its plain version and
    its unbatched launch on each dataset, within 1e-4 max(1, max|ref|);
    two calls bitwise equal."""
    assert fnl.fused_nonlinear_tile_rows(d, h1, n) is None
    rng = np.random.default_rng(100 * n_ds + d + h1)
    chip_smoke.check_fleet_nonlinear(cuda, rng, n_ds, p, d, n, h1, blocks, m,
                                     activation)
