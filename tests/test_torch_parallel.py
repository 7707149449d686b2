"""The particle-sharded port (``dibs_tpu_torch.parallel``) on the CPU, in
``gloo`` worlds of 2 and 4 processes (``tests/torch_parallel_workers.py``
holds the rank side; each world runs many checks in one spawn).

* the plain versions of #1 and #5-#8 and the estimators: launches over the
  shards of a batch, each with its first particle as ``particle_offset``,
  concatenate bitwise to one launch over the batch;
* the ring transports, marginal and joint, against ``dibs_tpu.parallel.
  ring`` on the conftest's virtual mesh of the same size (``atol=1e-5``, as
  ``tests/test_parallel.py``); their collectives (``world - 1`` rotations of
  each block, no all-gather); a bfloat16 payload within the reference's
  tolerance of float32, and float32 by default; #3's row block;
* sharded ``MarginalDiBS`` (``score``, ``score_rb``) and ``JointDiBS``
  (linear one- and two-pass, the MLP): teacher-forced transports against
  ``dibs_tpu``'s on the same injected noise (``1e-4 max|phi|``), free runs
  against the port's unsharded run (graphs equal, ``z`` within 1e-4), a run
  whose particles the world does not divide (replicated), a one-rank world
  (bitwise the unsharded run);
* ``shard_state`` / ``gather_state``, ``fleet_sample(mesh=)`` against the
  meshless fleet, and the refusals (a mesh without a world, NCCL ranks on
  one card, a fleet's datasets the mesh does not divide, a sharded fleet
  engine); the ``("p", "mc")`` mesh is ``tests/test_torch_parallel_mc.py``.
"""
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import dibs_tpu.parallel as jax_parallel
import torch_parallel_workers as workers
from dibs_tpu.kernel import AdditiveFrobeniusSEKernel as JaxSEKernel
from dibs_tpu.kernel import JointAdditiveFrobeniusSEKernel as JaxJointKernel
from dibs_tpu.models import BGe as JaxBGe
from dibs_tpu.parallel.ring import (
    ring_joint_transport as jax_ring_joint,
    ring_marginal_transport as jax_ring_marginal,
)
from dibs_tpu_torch import config
from dibs_tpu_torch.fleet import fleet_sample
from dibs_tpu_torch.inference.estimators import (
    EstimatorConfig,
    make_estimators,
)
from dibs_tpu_torch.inference.fused_linear import (
    fused_linear_pass1_plain,
    fused_linear_pass2_plain,
    fused_linear_single_plain,
)
from dibs_tpu_torch.inference.fused_nonlinear import fused_nonlinear_plain
from dibs_tpu_torch.inference.transport import (
    joint_transport,
    marginal_transport,
)
from dibs_tpu_torch.kernel import (
    AdditiveFrobeniusSEKernel,
    JointAdditiveFrobeniusSEKernel,
)
from dibs_tpu_torch.models import (
    BGe,
    DenseNonlinearGaussian,
    ErdosReniDAGDistribution,
    LinearGaussian,
)
from dibs_tpu_torch.ops.gpu_kernels import gumbel_graphs_plain
from dibs_tpu_torch.parallel import (
    ParticleSharding,
    make_particle_mesh,
    shard_state,
)
from dibs_tpu_torch.parallel.shard_ops import sharded_gumbel_graphs
from dibs_tpu_torch.utils.tree import tree_leaves
from test_torch_joint import _pair as joint_pair
from test_torch_joint import _reference_run as joint_reference_run
from test_torch_joint import _to_port as joint_to_port
from test_torch_joint_nonlinear import _pair as mlp_pair
from test_torch_joint_nonlinear import _reference_run as mlp_reference_run
from test_torch_joint_nonlinear import _to_port as mlp_to_port
from test_torch_svgd import _pair as marginal_pair
from test_torch_svgd import _reference_run as marginal_reference_run
from test_torch_svgd import _to_port as marginal_to_port

import test_torch_joint as joint_mod
import test_torch_joint_nonlinear as mlp_mod
import test_torch_svgd as marginal_mod

torch.set_num_threads(1)

WORLDS = (2, 4)
FREE_P, FREE_STEPS, FREE_SEED = 8, 10, 5


def _fake_sharding(rank, world):
    """A sharding's rank and world alone: what the per-shard launches and
    ``shard_state`` read (no collective runs)."""
    return ParticleSharding(None, "p", rank, world, None, None,
                            datetime.timedelta(seconds=1))


def _shards(world, n):
    per = n // world
    return [(r, slice(r * per, (r + 1) * per)) for r in range(world)]


# ---------------------------------------------------------------------------
# (a) per-shard launches with offsets are one launch
# ---------------------------------------------------------------------------

# d = 8: a particle's 5 x 64 elements fill whole SIMD vectors, so torch's
# CPU elementwise kernels (whose scalar tail can round a transcendental one
# ulp off their vector body) treat every shard's elements as the whole
# batch's: bitwise. At a ragged d = 7 a few elements move by an ulp, which
# the card's kernels, computing each element alone, do not do
# (tests/test_torch_cuda_parallel.py holds them bitwise at ragged shapes).
P_A, M_A, D_A, N_A = 6, 5, 8, 11
RAGGED_D = 7


def _scores(rng, p=P_A, d=D_A):
    return torch.from_numpy(rng.normal(size=(p, d, d)).astype(np.float32))


def _same(got, want, exact):
    if exact:
        assert torch.equal(got, want)
    else:  # within two float32 ulps of the values' scale
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 2.0 ** -22 * scale


@pytest.mark.parametrize("hard, tau", [(True, 1.0), (False, 1.0),
                                        (False, 0.7)])
@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("d", [D_A, RAGGED_D])
def test_sampler_shards_are_one_launch(hard, tau, world, d):
    scores = _scores(np.random.default_rng(0), d=d)
    whole = gumbel_graphs_plain(scores, 123456789012, 7, 0.8, tau, M_A, hard)
    parts = [gumbel_graphs_plain(scores[rows], 123456789012, 7, 0.8, tau,
                                 M_A, hard, particle_offset=rows.start)
             for _, rows in _shards(world, P_A)]
    _same(torch.cat(parts), whole, d == D_A or hard)
    wrapped = [sharded_gumbel_graphs(scores[rows], 123456789012, 7, 0.8, tau,
                                     M_A, sharding=_fake_sharding(r, world),
                                     hard=hard)
               for r, rows in _shards(world, P_A)]
    assert torch.equal(torch.cat(wrapped), torch.cat(parts))
    assert not torch.equal(parts[1], gumbel_graphs_plain(
        scores[_shards(world, P_A)[1][1]], 123456789012, 7, 0.8, tau, M_A,
        hard))


def _linear_problem(rng, d):
    scores = _scores(rng, d=d)
    thetas = torch.from_numpy(rng.normal(size=(P_A, d, d))
                              .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(N_A, d)).astype(np.float32))
    w = torch.ones(N_A, d)
    return scores, thetas, x, w


@pytest.mark.parametrize("kind", ["single", "pass1", "pass2"])
@pytest.mark.parametrize("streams", [(4, 4), (4, 5)])
@pytest.mark.parametrize("d", [D_A, RAGGED_D])
def test_fused_linear_plain_shards_are_one_launch(kind, streams, d):
    rng = np.random.default_rng(1)
    scores, thetas, x, w = _linear_problem(rng, d)
    model = LinearGaussian(n_vars=d)
    kw = dict(seed=99, streams=streams, alpha=0.6, tau=1.0, n_samples=M_A,
              model=model)
    wts = tuple(torch.softmax(torch.from_numpy(
        rng.normal(size=(P_A, M_A)).astype(np.float32)), dim=1)
        for _ in range(2))
    fn = {"single": fused_linear_single_plain,
          "pass1": fused_linear_pass1_plain,
          "pass2": lambda *a, **k: fused_linear_pass2_plain(*a, wts, **k),
          }[kind]
    whole = fn(scores, thetas, x, w, **kw)
    for world in (2, 3):
        parts = []
        for _, rows in _shards(world, P_A):
            if kind == "pass2":
                part = fused_linear_pass2_plain(
                    scores[rows], thetas[rows], x, w,
                    tuple(t[rows] for t in wts), particle_offset=rows.start,
                    **kw)
            else:
                part = fn(scores[rows], thetas[rows], x, w,
                          particle_offset=rows.start, **kw)
            parts.append(part)
        for got, want in zip(zip(*parts), whole):
            _same(torch.cat(got), want, d == D_A)


@pytest.mark.parametrize("d", [D_A, RAGGED_D])
def test_fused_nonlinear_plain_shards_are_one_launch(d):
    from dibs_tpu_torch.inference.fused_nonlinear import kernel_layout

    rng = np.random.default_rng(2)
    h1 = 3
    model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,))
    thetas = model.sample_parameters(generator=torch.Generator().manual_seed(
        3), n_particles=P_A, n_vars=d, device="cpu")
    layout = kernel_layout(thetas, model)
    scores = _scores(rng, d=d)
    x = torch.from_numpy(rng.normal(size=(N_A, d)).astype(np.float32))
    w = torch.ones(N_A, d)
    kw = dict(seed=7, streams=(2, 2), alpha=0.5, tau=1.0, n_samples=M_A,
              model=model)
    whole = fused_nonlinear_plain(scores, *layout, x, w, **kw)
    for world in (2, 3):
        parts = [fused_nonlinear_plain(scores[rows],
                                       *(t[rows] for t in layout), x, w,
                                       particle_offset=rows.start, **kw)
                 for _, rows in _shards(world, P_A)]
        for got, want in zip(zip(*parts), whole):
            _same(torch.cat(got), want, d == D_A)


@pytest.mark.parametrize("estimator", ["score", "score_rb"])
@pytest.mark.parametrize("d", [D_A, 6])
def test_marginal_estimators_of_a_shard_are_rows_of_the_whole(estimator, d):
    rng = np.random.default_rng(4)
    p, n = 4, 12
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    bge = BGe(n_vars=d, device="cpu")
    cfg = EstimatorConfig(alpha_linear=1.0, n_grad_mc_samples=8,
                          n_acyclicity_mc_samples=4,
                          grad_estimator_z=estimator)
    common = dict(cfg=cfg, x=x, interv_mask=torch.zeros(n, d),
                  log_graph_prior=ErdosReniDAGDistribution(d)
                  .unnormalized_log_prob_soft,
                  batched_node_log_joint_prob=bge
                  .batched_interventional_node_log_marginal_probs)
    z = torch.from_numpy(rng.normal(size=(p, d, d, 2)).astype(np.float32))
    base = torch.zeros(p)
    whole = make_estimators(**common)
    want = (whole.eltwise_grad_z_likelihood(z, None, base, 3, 11, 6)[0],
            whole.eltwise_grad_latent_prior(z, 3, 11, 7, 0.4))
    for r, rows in _shards(2, p):
        est = make_estimators(sharding=_fake_sharding(r, 2), **common)
        got = (est.eltwise_grad_z_likelihood(z[rows], None, base[rows], 3,
                                             11, 6)[0],
               est.eltwise_grad_latent_prior(z[rows], 3, 11, 7, 0.4))
        for a, b in zip(got, want):
            _same(a, b[rows], d == D_A)


# ---------------------------------------------------------------------------
# (d) shard_state's layout, (h) the refusals without a world
# ---------------------------------------------------------------------------


def _joint_engine(d=5):
    from dibs_tpu_torch.inference import JointDiBS
    from dibs_tpu_torch.models import ScaleFreeDAGDistribution

    return JointDiBS(x=torch.zeros(10, d),
                     graph_model=ScaleFreeDAGDistribution(d),
                     likelihood_model=DenseNonlinearGaussian(
                         n_vars=d, hidden_layers=(3,)), device="cpu")


@pytest.mark.parametrize("p, world", [(8, 2), (8, 4), (6, 4), (3, 2)])
def test_shard_state_keeps_the_block_and_replicates_the_rest(p, world):
    state = _joint_engine().init_state(seed=1, n_particles=p)
    leaves = workers._tensors(state)
    splits = p % world == 0
    for r in range(world):
        local = shard_state(state, _fake_sharding(r, world))
        assert local.t == state.t and local.seed == state.seed
        assert local.sf_baseline is state.sf_baseline  # rank 1: replicated
        for got, want in zip(workers._tensors(local), leaves):
            if want.dim() >= 2 and splits:
                n = p // world
                assert torch.equal(got, want[r * n:(r + 1) * n])
            else:
                assert got is want


def test_mc_axis_and_uninitialized_worlds_raise():
    # the ("p", "mc") mesh runs in worlds (tests/test_torch_parallel_mc.py);
    # without a world both meshes raise
    for n_mc in (1, 2):
        with pytest.raises(RuntimeError, match="init_process_group"):
            make_particle_mesh(n_mc=n_mc)


def test_ring_payload_dtype_knob():
    assert config.ring_payload_dtype() is torch.float32
    try:
        config.set_ring_payload_dtype("bfloat16")
        assert config.ring_payload_dtype() is torch.bfloat16
        config.set_ring_payload_dtype(torch.float32)
        assert config.ring_payload_dtype() is torch.float32
        for bad in ("float16", torch.float64):
            with pytest.raises(ValueError, match="bfloat16"):
                config.set_ring_payload_dtype(bad)
    finally:
        config.set_ring_payload_dtype("float32")


# ---------------------------------------------------------------------------
# (b), (e), (f): the ring transports in a world
# ---------------------------------------------------------------------------

P_RING, D_RING, K_RING = 16, 6, 6


@pytest.fixture(scope="module")
def ring_inputs():
    k1, k2, k3, k4 = random.split(random.PRNGKey(11), 4)
    shapes = ((P_RING, D_RING, K_RING, 2), (P_RING, D_RING, K_RING, 2),
              (P_RING, D_RING, D_RING), (P_RING, D_RING, D_RING))
    return tuple(np.array(random.normal(k, s))
                 for k, s in zip((k1, k2, k3, k4), shapes))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ring_world(request, ring_inputs, tmp_path_factory):
    world = request.param
    z, dz, theta, dtheta = (torch.from_numpy(a) for a in ring_inputs)
    out = workers.run_world(workers.ring_checks, world,
                            tmp_path_factory.mktemp("ring"), z, dz, theta,
                            dtheta)
    return world, out


def _jax_ring(world, inputs):
    sharding = jax_parallel.particle_sharding(
        jax_parallel.make_particle_mesh(jax.devices()[:world]))
    z, dz, theta, dtheta = (jax.device_put(jnp.asarray(a), sharding)
                            for a in inputs)
    km = JaxSEKernel(h=5.0)
    kj = JaxJointKernel(h_latent=5.0, h_theta=500.0)
    m = jax.jit(lambda a, b: jax_ring_marginal(km, a, b, sharding))(z, dz)
    jz, jt = jax.jit(lambda a, b, c, e: jax_ring_joint(kj, a, c, b, e,
                                                       sharding))(
        z, dz, theta, dtheta)
    return tuple(np.asarray(a) for a in (m, jz, jt))


def test_ring_transport_matches_reference_ring(ring_world, ring_inputs):
    world, out = ring_world
    want = _jax_ring(world, ring_inputs)
    for rank_out in out:  # every rank holds the gathered transports
        for got, ref in zip(rank_out["f32"], want):
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    z, dz, theta, dtheta = (torch.from_numpy(a) for a in ring_inputs)
    m, jz, jt = out[0]["f32"]
    np.testing.assert_allclose(
        m.numpy(), marginal_transport(AdditiveFrobeniusSEKernel(h=5.0), z,
                                      dz).numpy(), atol=1e-5)
    uz, ut = joint_transport(JointAdditiveFrobeniusSEKernel(
        h_latent=5.0, h_theta=500.0), z, theta, dz, dtheta)
    np.testing.assert_allclose(jz.numpy(), uz.numpy(), atol=1e-5)
    np.testing.assert_allclose(jt.numpy(), ut.numpy(), atol=1e-5)


def test_ring_rotates_each_block_world_minus_one_times(ring_world):
    world, out = ring_world
    n = P_RING // world
    zf, tf = (n, D_RING * K_RING * 2), (n, D_RING * D_RING)
    for rank_out in out:
        sends, gathers, reduces = rank_out["counts"]["marginal"]
        assert sends == [[(zf, "torch.float32")] * 2] * (world - 1)
        assert gathers == [] and reduces == [(1, zf[1])]
        sends, gathers, reduces = rank_out["counts"]["joint"]
        assert sends == [[(zf, "torch.float32")] * 2
                         + [(tf, "torch.float32")] * 2] * (world - 1)
        assert gathers == [] and reduces == [(1, zf[1]), (1, tf[1])]


def test_ring_bf16_payload_is_within_the_reference_tolerance(ring_world):
    world, out = ring_world
    rank0 = out[0]
    for got, ref in zip(rank0["bf16"], rank0["f32"]):
        err = float((got - ref).abs().max())
        assert err < 0.02 * float(ref.abs().max()) + 1e-4, err
    # the joint ring's phi_z moved: the payload was quantized (the marginal
    # kernel at h = 5 is ~1e-13 between these particles, as the reference
    # test's, so only the joint ring shows it)
    assert float((rank0["bf16"][1] - rank0["f32"][1]).abs().max()) > 0.0
    for a, b in zip(rank0["f32_again"], rank0["f32"]):
        assert torch.equal(a, b)  # float32 again: bitwise the first run
    for sends in rank0["bf16_sends"]:
        assert {dtype for _, dtype in sends} == {"torch.bfloat16"}


def test_sharded_se_matrix_rows(ring_world, ring_inputs):
    world, out = ring_world
    flat = torch.from_numpy(ring_inputs[0]).reshape(P_RING, -1)
    whole = AdditiveFrobeniusSEKernel(h=5.0).matrix(flat, flat)
    for r, rows in _shards(world, P_RING):
        got = out[r]["se_rows"]
        assert got.shape == (P_RING // world, P_RING)
        np.testing.assert_allclose(got.numpy(), whole[rows].numpy(),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the sharded engines
# ---------------------------------------------------------------------------


def _marginal_case(name, cfg):
    mod = marginal_mod
    data = mod.jax_data(key=random.PRNGKey(7), n_vars=mod.D,
                        graph_prior_str="er", n_observations=mod.N_OBS)[0]
    x = np.array(data.x)
    ref, _ = marginal_pair(x, cfg)
    std = 1.0 / np.sqrt(mod.K_LAT)
    run, _ = marginal_reference_run(ref, std)
    bge = JaxBGe(n_vars=mod.D)
    spec = ("marginal", dict(x=x, n_vars=mod.D,
                             mean_obs=np.asarray(bge.mean_obs),
                             alpha_mu=bge.alpha_mu,
                             alpha_lambd=bge.alpha_lambd),
            dict(n_grad_mc_samples=mod.M,
                 n_acyclicity_mc_samples=mod.K_ACYC, **cfg))
    return spec, float(std), run, marginal_to_port, mod.K_LAT


def _joint_case(name, single_pass):
    mod = joint_mod
    data, _, lm = mod.jax_data(key=random.PRNGKey(7), n_vars=mod.D,
                               graph_prior_str="sf",
                               n_observations=mod.N_OBS)
    x = np.array(data.x)
    ref, _ = joint_pair(x, lm, "hard")
    std = 1.0 / np.sqrt(mod.K_LAT)
    run, _ = joint_reference_run(ref, std, "hard")
    spec = ("linear", dict(x=x, n_vars=mod.D, obs_noise=lm.obs_noise,
                           mean_edge=lm.mean_edge, sig_edge=lm.sig_edge,
                           min_edge=lm.min_edge),
            dict(n_grad_mc_samples=mod.M, n_acyclicity_mc_samples=mod.K_ACYC,
                 fused_single_pass=single_pass))
    return spec, float(std), run, joint_to_port, mod.K_LAT


def _mlp_case(name):
    mod = mlp_mod
    data, _, lm = mod.jax_data(key=random.PRNGKey(7), n_vars=mod.D,
                               hidden_layers=(mod.H1,),
                               n_observations=mod.N_OBS)
    x = np.array(data.x)
    ref, _ = mlp_pair(x, lm, "hard")
    std = 1.0 / np.sqrt(mod.K_LAT)
    run, _ = mlp_reference_run(ref, std, "hard")
    spec = ("mlp", dict(x=x, n_vars=mod.D, hidden_layers=lm.hidden_layers,
                        obs_noise=lm.obs_noise, sig_param=lm.sig_param,
                        activation=lm.activation, bias=lm.bias),
            dict(n_grad_mc_samples=mod.M,
                 n_acyclicity_mc_samples=mod.K_ACYC))
    return spec, float(std), run, mlp_to_port, mod.K_LAT


CASES = ("score", "score_rb", "linear", "linear_two_pass", "mlp")


@pytest.fixture(scope="module")
def reference_cases():
    built = {
        "score": _marginal_case("score", dict(grad_estimator_z="score")),
        "score_rb": _marginal_case("score_rb",
                                   dict(grad_estimator_z="score_rb")),
        "linear": _joint_case("linear", True),
        "linear_two_pass": _joint_case("linear_two_pass", False),
        "mlp": _mlp_case("mlp"),
    }
    cases, refs = {}, {}
    for name, (spec, std, run, to_port, k_lat) in built.items():
        free = dict(seed=FREE_SEED, n_particles=FREE_P, steps=FREE_STEPS,
                    n_dim_particles=k_lat)
        cases[name] = (spec, std, [to_port(st) for st, _, _ in run],
                       [noise for _, _, noise in run], free)
        refs[name] = [phi for _, phi, _ in run]
    # particles the world does not divide: every rank runs the whole step
    spec, std, _, _, k_lat = built["score"]
    cases["replicated"] = (spec, std, [], [], dict(
        seed=FREE_SEED, n_particles=FREE_P - 1, steps=FREE_STEPS,
        n_dim_particles=k_lat))
    return cases, refs


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def engine_world(request, reference_cases, tmp_path_factory):
    cases, _ = reference_cases
    out = workers.run_world(workers.engine_checks, request.param,
                            tmp_path_factory.mktemp("engines"), cases)
    return request.param, out


@pytest.mark.parametrize("name", CASES)
def test_sharded_teacher_forced_phi_matches_reference(engine_world,
                                                      reference_cases, name):
    world, out = engine_world
    _, refs = reference_cases
    for t, (got, want) in enumerate(zip(out[0][name]["phi"], refs[name])):
        got = ([got] if name.startswith("score")
               else [got[0]] + tree_leaves(got[1]))
        want = [want] if name.startswith("score") else list(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            tol = 1e-4 * np.abs(b).max()
            err = np.abs(a.numpy() - b).max()
            assert err <= tol, (name, world, t, err, tol)


def _unsharded(spec):
    return workers._engine(spec, None)


@pytest.mark.parametrize("name", CASES + ("replicated",))
def test_sharded_free_run_matches_unsharded_port(engine_world,
                                                 reference_cases, name):
    world, out = engine_world
    cases, _ = reference_cases
    spec, _, _, _, free = cases[name]
    run = _unsharded(spec).sample(**free, return_state=True)
    for rank_out in out:
        got = rank_out[name]
        assert torch.equal(got["g"], run[0]), (name, world)
        err = float((got["state"].z - run[-1].z).abs().max())
        assert err <= 1e-4, (name, world, err)
        assert got["state"].z.shape == run[-1].z.shape
        assert got["state"].sf_baseline.shape == (free["n_particles"],)
    if name != "replicated":
        assert out[0][name]["round_trip"]
        assert out[0][name]["local_z"][0] == 4 // world  # P = 4 TF states


def test_one_rank_world_is_the_unsharded_run(reference_cases, tmp_path):
    cases, _ = reference_cases
    spec, std, states, noises, free = cases["score"]
    one = {"score": (spec, std, states[:2], noises[:2], free)}
    out = workers.run_world(workers.engine_checks, 1, tmp_path, one)
    run = _unsharded(spec).sample(**free, return_state=True)
    assert torch.equal(out[0]["score"]["g"], run[0])
    assert torch.equal(out[0]["score"]["state"].z, run[-1].z)


# ---------------------------------------------------------------------------
# (d) in a world, (g) the fleet's datasets axis, (h) the refusals
# ---------------------------------------------------------------------------


def test_shard_and_gather_state_and_nccl_refusals(tmp_path):
    state = _joint_engine().init_state(seed=2, n_particles=8)
    out = workers.run_world(workers.layout_and_refusal_checks, 2, tmp_path,
                            state)
    for rank_out in out:
        assert rank_out["same"]
        assert rank_out["local"][0] == (4, 5, 5, 2)
        dup, not_cuda = rank_out["errors"]
        assert "share a card" in dup and "cuda:0" in dup
        assert "needs CUDA devices" in not_cuda


@pytest.fixture(scope="module")
def fleet_case():
    mod = marginal_mod
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(4, mod.N_OBS, 6)).astype(np.float32)
    bge = JaxBGe(n_vars=6)
    spec = ("marginal", dict(x=xs[0], n_vars=6,
                             mean_obs=np.asarray(bge.mean_obs),
                             alpha_mu=bge.alpha_mu,
                             alpha_lambd=bge.alpha_lambd),
            dict(n_grad_mc_samples=8, n_acyclicity_mc_samples=4))
    return spec, xs, dict(seed=3, n_particles=4, steps=5)


def test_fleet_over_a_datasets_mesh_matches_the_meshless_fleet(fleet_case,
                                                               tmp_path):
    spec, xs, free = fleet_case
    out = workers.run_world(workers.fleet_checks, 2, tmp_path, spec,
                            torch.from_numpy(xs), free,
                            torch.from_numpy(xs[:3]))
    gs, state = fleet_sample(_unsharded(spec), xs=xs, return_states=True,
                             **free)
    for rank_out in out:
        assert torch.equal(rank_out["gs"], gs)
        assert torch.equal(rank_out["state"].z, state.z)
        assert torch.equal(rank_out["state"].seed, state.seed)
        assert torch.equal(rank_out["state"].sf_baseline, state.sf_baseline)
        odd, sharded = rank_out["errors"]
        assert "B=3 must divide the 'datasets' mesh axis (2)" in odd
        assert "without a particle sharding" in sharded
