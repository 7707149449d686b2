"""The ``("p", "mc")`` mesh of the port (``dibs_tpu_torch.parallel`` with
``n_mc > 1``) on the CPU, in ``gloo`` worlds of 2 (mesh ``1 x 2``) and 4
(mesh ``2 x 2``) processes; ``tests/torch_parallel_workers.py`` holds the
rank side, and each world runs every check in one spawn.

* (a) the plain sampler at ``sample_offset``: the ``"mc"`` blocks of a
  launch concatenate bitwise to one launch (hard, soft at tau = 1 and
  tau != 1, a ragged d, particle and sample offsets at once);
* (b) each rank's estimator rows against the unsharded estimators'
  (``1e-4 max|ref|``; the baseline bitwise): marginal ``score`` with
  ``c`` = 0 and 0.5, ``score_rb``, joint ``score``, the generic
  reparameterization route with the Theta likelihood (a two-hidden-layer
  MLP, which the fused kernel declines) and its shared-noise variant, and
  the ``'sampled'`` latent prior in every case;
* (c) teacher-forced transports of the sharded engines against
  ``dibs_tpu``'s on ``make_particle_mesh(devices[:n], n_mc=2)`` over the
  conftest's virtual devices, on the same injected noise (``1e-4
  max|phi|``);
* (d) free runs against the port's unsharded run (graphs equal, ``z``
  within 1e-4, as the reference's ``test_mc_axis_sharded_run_matches_
  unsharded``), every rank's final state bitwise the others';
* (e) every sampler call of a step draws ``[P / p, M / n_mc, d, d]``;
* (f) an ``M`` that ``n_mc`` does not divide runs replicated and matches;
  an ``n_mc`` that does not divide the world raises ``ValueError``.
"""
import datetime

import jax
import numpy as np
import pytest
import torch
from jax import random

import dibs_tpu.parallel as jax_parallel
import test_torch_joint as joint_mod
import test_torch_joint_nonlinear as mlp_mod
import test_torch_joint_score as score_mod
import test_torch_svgd as marginal_mod
import torch_parallel_workers as workers
from dibs_tpu.inference import JointDiBS as JaxJointDiBS
from dibs_tpu.inference import MarginalDiBS as JaxMarginalDiBS
from dibs_tpu.models import BGe as JaxBGe
from dibs_tpu.models import ErdosReniDAGDistribution as JaxER
from dibs_tpu.models import ScaleFreeDAGDistribution as JaxSF
from dibs_tpu_torch.ops.gpu_kernels import gumbel_graphs_plain
from dibs_tpu_torch.parallel import (
    ParticleSharding,
    constrain_mc,
    mc_shard_size,
)
from dibs_tpu_torch.parallel.shard_ops import mc_block, sharded_gumbel_graphs
from dibs_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

N_MC = 2
WORLDS = (2, 4)
TF_STEPS = 4  # teacher-forced steps of each reference run
EST_P, FREE_P, FREE_STEPS, FREE_SEED = 4, 8, 10, 5
MLP_HIDDEN = (mlp_mod.H1, mlp_mod.H1)  # declined by the fused kernel #8
# the MLP's d: 8, so that the CPU plain versions round alike on every
# particle shard (see tests/test_torch_parallel.py). At the MLP harness's
# d = 6 the particle shards of a ``"p"`` axis round some elements an ulp
# apart, and the generic route's free run turns that into 6.8e-3 in z and
# one edge after 10 steps, on a ``"p"``-only mesh as well (ROADMAP.md
# queue 3).
MLP_D = 8


def _fake(p_rank, p_size, mc_rank, mc_size):
    """A sharding's ranks and sizes alone (no collective runs)."""
    return ParticleSharding(None, "p", p_rank, p_size, None, None,
                            datetime.timedelta(seconds=1), mc_rank=mc_rank,
                            mc_size=mc_size)


def _same(got, want, exact):
    if exact:
        assert torch.equal(got, want)
    else:  # within two float32 ulps of the values' scale
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 2.0 ** -22 * scale


# ---------------------------------------------------------------------------
# (a) the sampler at a sample offset
# ---------------------------------------------------------------------------

P_A, M_A = 6, 8


@pytest.mark.parametrize("hard, tau", [(True, 1.0), (False, 1.0),
                                        (False, 0.7)])
@pytest.mark.parametrize("n_mc", [2, 4])
@pytest.mark.parametrize("d", [8, 7])
def test_sampler_sample_blocks_are_one_launch(hard, tau, n_mc, d):
    rng = np.random.default_rng(20)
    scores = torch.from_numpy(rng.normal(size=(P_A, d, d))
                              .astype(np.float32))
    args = (123456789012, 7, 0.8, tau)
    whole = gumbel_graphs_plain(scores, *args, M_A, hard)
    n = M_A // n_mc
    parts = [gumbel_graphs_plain(scores, *args, n, hard, sample_offset=j * n)
             for j in range(n_mc)]
    # d = 8: a sample's 64 elements fill whole SIMD vectors (see
    # tests/test_torch_parallel.py); at d = 7 soft values may move an ulp
    _same(torch.cat(parts, dim=1), whole, d == 8 or hard)
    assert not torch.equal(parts[1], gumbel_graphs_plain(scores, *args, n,
                                                         hard))
    # both offsets at once, through the wrapper, against the plain slices
    p = P_A // 2
    for p_rank in range(2):
        rows = slice(p_rank * p, (p_rank + 1) * p)
        for j in range(n_mc):
            got = sharded_gumbel_graphs(scores[rows], *args, M_A,
                                        sharding=_fake(p_rank, 2, j, n_mc),
                                        hard=hard)
            want = gumbel_graphs_plain(scores[rows], *args, n, hard,
                                       particle_offset=rows.start,
                                       sample_offset=j * n)
            assert torch.equal(got, want)
            _same(got, whole[rows, j * n:(j + 1) * n], d == 8 or hard)


def test_sampler_blocks_of_injected_noise_and_odd_counts():
    rng = np.random.default_rng(21)
    scores = torch.from_numpy(rng.normal(size=(4, 8, 8)).astype(np.float32))
    eps = torch.from_numpy(rng.logistic(size=(4, M_A, 8, 8))
                           .astype(np.float32))
    whole = gumbel_graphs_plain(scores, 3, 1, 0.5, 1.0, M_A, False, eps=eps)
    for j in range(2):
        got = sharded_gumbel_graphs(scores, 3, 1, 0.5, 1.0, M_A,
                                    sharding=_fake(0, 1, j, 2), eps=eps)
        assert torch.equal(got, whole[:, j * 4:(j + 1) * 4])
    # 2 does not divide 5 samples: every "mc" rank draws all of them
    odd = [sharded_gumbel_graphs(scores, 3, 1, 0.5, 1.0, 5,
                                 sharding=_fake(0, 1, j, 2), hard=True)
           for j in range(2)]
    assert torch.equal(odd[0], odd[1])
    assert torch.equal(odd[0], gumbel_graphs_plain(scores, 3, 1, 0.5, 1.0, 5,
                                                   True))
    assert mc_block(_fake(0, 1, 1, 2), 5) == (0, 5)
    assert mc_block(_fake(0, 1, 1, 2), 8) == (4, 4)
    assert mc_block(None, 8) == (0, 8)


def test_sample_offsets_past_32_bits_and_with_a_fleet_raise():
    scores = torch.zeros(2, 3, 3)
    with pytest.raises(ValueError, match="32 bits"):
        gumbel_graphs_plain(scores, 1, 0, 1.0, 1.0, 4, True,
                            sample_offset=2 ** 32 - 2)
    with pytest.raises(ValueError, match="sample_offset"):
        gumbel_graphs_plain(scores, torch.tensor([1, 2]), 0, 1.0, 1.0, 4,
                            True, sample_offset=4)
    with pytest.raises(ValueError, match="sample_offset"):
        gumbel_graphs_plain(scores, 1, 0, 1.0, 1.0, 4, True,
                            sample_offset=-4)


def test_constrain_mc_keeps_the_block_of_divisible_leaves():
    tree = (torch.arange(2 * 8 * 3.0).view(2, 8, 3), torch.ones(2, 5, 3),
            torch.ones(7))
    got = constrain_mc(tree, _fake(0, 1, 1, 2))
    assert torch.equal(got[0], tree[0][:, 4:])
    assert got[1] is tree[1] and got[2] is tree[2]
    assert constrain_mc(tree, _fake(0, 2, 0, 1)) is tree
    assert mc_shard_size(_fake(0, 1, 1, 2)) == 2
    assert mc_shard_size(_fake(0, 2, 0, 1)) == 1
    assert mc_shard_size(None) == 1


# ---------------------------------------------------------------------------
# the cases of the worlds
# ---------------------------------------------------------------------------


def _marginal_spec(cfg, m=marginal_mod.M):
    mod = marginal_mod
    data = mod.jax_data(key=random.PRNGKey(7), n_vars=mod.D,
                        graph_prior_str="er", n_observations=mod.N_OBS)[0]
    bge = JaxBGe(n_vars=mod.D)
    spec = ("marginal", dict(x=np.array(data.x), n_vars=mod.D,
                             mean_obs=np.asarray(bge.mean_obs),
                             alpha_mu=bge.alpha_mu,
                             alpha_lambd=bge.alpha_lambd),
            dict(n_grad_mc_samples=m, n_acyclicity_mc_samples=mod.K_ACYC,
                 **cfg))
    return spec, bge


def _linear_spec(cfg):
    mod = joint_mod
    data, _, lm = mod.jax_data(key=random.PRNGKey(7), n_vars=mod.D,
                               graph_prior_str="sf",
                               n_observations=mod.N_OBS)
    spec = ("linear", dict(x=np.array(data.x), n_vars=mod.D,
                           obs_noise=lm.obs_noise, mean_edge=lm.mean_edge,
                           sig_edge=lm.sig_edge, min_edge=lm.min_edge),
            dict(n_grad_mc_samples=mod.M, n_acyclicity_mc_samples=mod.K_ACYC,
                 **cfg))
    return spec, lm


def _mlp_spec(cfg):
    mod = mlp_mod
    data, _, lm = mod.jax_data(key=random.PRNGKey(7), n_vars=MLP_D,
                               hidden_layers=MLP_HIDDEN,
                               n_observations=mod.N_OBS)
    spec = ("mlp", dict(x=np.array(data.x), n_vars=MLP_D,
                        hidden_layers=lm.hidden_layers,
                        obs_noise=lm.obs_noise, sig_param=lm.sig_param,
                        activation=lm.activation, bias=lm.bias),
            dict(n_grad_mc_samples=mod.M, n_acyclicity_mc_samples=mod.K_ACYC,
                 **cfg))
    return spec, lm


def _k_lat(spec):
    return {"marginal": marginal_mod.K_LAT, "linear": joint_mod.K_LAT,
            "mlp": mlp_mod.K_LAT}[spec[0]]


def _estimator_state(spec):
    """The unsharded port's state after two free steps (a finite
    baseline where ``c > 0``)."""
    dibs = workers._engine(spec, None)
    k = _k_lat(spec)
    state = dibs.init_state(seed=9, n_particles=EST_P, n_dim_particles=k)
    step = dibs._make_step(dibs._resolve_latent_std(k))
    return step(step(state))


def _estimator_cases():
    specs = {
        "score": _marginal_spec(dict(grad_estimator_z="score"))[0],
        "score_c": _marginal_spec(dict(grad_estimator_z="score",
                                       score_function_baseline=0.5))[0],
        "score_rb": _marginal_spec(dict(grad_estimator_z="score_rb"))[0],
        "joint_score": _linear_spec(dict(grad_estimator_z="score",
                                         score_function_baseline=0.5))[0],
        "reparam": _mlp_spec(dict(fused_sample_sharing=None))[0],
        "reparam_shared": _mlp_spec(dict(fused_sample_sharing="hard"))[0],
    }
    return {name: (spec, _estimator_state(spec), 6, (None,) * 3)
            for name, spec in specs.items()}


def _jax_sharding(world):
    return jax_parallel.particle_sharding(jax_parallel.make_particle_mesh(
        jax.devices()[:world], n_mc=N_MC))


def _reference(kind, spec, model, sharding):
    cfg, d = dict(spec[2]), spec[1]["n_vars"]
    x = jax.numpy.asarray(spec[1]["x"])
    if kind == "marginal":
        return JaxMarginalDiBS(x=x, graph_model=JaxER(d),
                               likelihood_model=model, sharding=sharding,
                               **cfg)
    return JaxJointDiBS(x=x, graph_model=JaxSF(d), likelihood_model=model,
                        sharding=sharding, **cfg)


def _marginal_reference_run(ref, std):
    """``test_torch_svgd._reference_run`` for a reference built with a
    sharding: its marginal estimators then skip the batched hook and draw
    each particle's hard graphs as ``bernoulli(k_g, p)``, ``k_g =
    split(split(k_lik, P)[p])[1]``, which the port reproduces from the same
    uniforms (``l = log(1 - u) - log(u)``, as
    ``tests/test_torch_joint_score.py``)."""
    mod = marginal_mod
    p, m, d, k_acyc = mod.P, mod.M, mod.D, mod.K_ACYC
    step = jax.jit(ref._make_step(std))

    @jax.jit
    def phi_and_noise(st):
        _, k_lik, k_prior = random.split(st.key, 3)
        keys_lik = random.split(k_lik, p)
        keys_prior = random.split(k_prior, p)
        dz_lik, _ = ref.est.eltwise_grad_z_likelihood(
            st.z, None, st.sf_baseline, st.t, keys_lik, x=ref.x,
            interv_mask=ref.interv_mask)
        dz_prior = ref.est.eltwise_grad_latent_prior(st.z, keys_prior, st.t,
                                                     std)
        phi = mod.jax_transport(ref.kernel, st.z, dz_prior + dz_lik)
        k_g = jax.vmap(lambda k: random.split(k)[1])(keys_lik)
        u = jax.vmap(lambda k: random.uniform(k, (m, d, d)))(k_g)
        noise = (jax.numpy.log(1.0 - u) - jax.numpy.log(u),
                 random.logistic(keys_prior[0], (p, k_acyc, d, d)))
        return phi, noise

    state = ref.init_state(key=random.PRNGKey(3), n_particles=p,
                           n_dim_particles=mod.K_LAT)
    out = []
    for _ in range(TF_STEPS):
        phi, noise = phi_and_noise(state)
        out.append((state, np.asarray(phi),
                    tuple(torch.from_numpy(np.array(e)) for e in noise)))
        state = step(state)
    return out


def _teacher_forced(world):
    """``name -> (spec, std, port states, noise, free, reference phis)``
    from ``TF_STEPS`` steps of the reference on the ``("p", "mc")`` mesh
    of ``world`` virtual devices."""
    sharding = _jax_sharding(world)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (joint_mod, mlp_mod, score_mod):
            mp.setattr(mod, "STEPS", TF_STEPS)
        for name, cfg in (("score", dict(grad_estimator_z="score")),
                          ("score_rb", dict(grad_estimator_z="score_rb"))):
            spec, bge = _marginal_spec(cfg)
            ref = _reference("marginal", spec, bge, sharding)
            std = 1.0 / np.sqrt(marginal_mod.K_LAT)
            run = _marginal_reference_run(ref, std)
            out[name] = (spec, float(std),
                         [marginal_mod._to_port(st) for st, _, _ in run],
                         [noise for _, _, noise in run],
                         [[phi] for _, phi, _ in run])
        std = 1.0 / np.sqrt(joint_mod.K_LAT)
        spec, lm = _linear_spec(dict(grad_estimator_z="score"))
        run, _ = score_mod._reference_run(
            _reference("linear", spec, lm, sharding), std)
        out["joint_score"] = (spec, float(std),
                              [joint_mod._to_port(r[0]) for r in run],
                              [r[-1] for r in run],
                              [list(r[1]) for r in run])
        spec, lm = _linear_spec(dict(fused_sample_sharing="hard"))
        run, _ = joint_mod._reference_run(
            _reference("linear", spec, lm, sharding), std, "hard")
        out["linear"] = (spec, float(std),
                         [joint_mod._to_port(st) for st, _, _ in run],
                         [noise for _, _, noise in run],
                         [list(phi) for _, phi, _ in run])
        spec, lm = _mlp_spec(dict(fused_sample_sharing=None))
        std = 1.0 / np.sqrt(mlp_mod.K_LAT)
        run, _ = mlp_mod._reference_run(
            _reference("mlp", spec, lm, sharding), std, None, d=MLP_D)
        out["reparam"] = (spec, float(std),
                          [mlp_mod._to_port(st) for st, _, _ in run],
                          [noise for _, _, noise in run],
                          [phi for _, phi, _ in run])
    return out


ENGINES = ("score", "score_rb", "joint_score", "linear", "reparam")


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def mc_world(request, tmp_path_factory):
    world = request.param
    tf = _teacher_forced(world)
    engine_cases = {}
    for name, (spec, std, states, noises, _) in tf.items():
        free = dict(seed=FREE_SEED, n_particles=FREE_P, steps=FREE_STEPS,
                    n_dim_particles=_k_lat(spec))
        engine_cases[name] = (spec, std, states, noises, free)
    odd_spec, _ = _marginal_spec(dict(grad_estimator_z="score"),
                                 m=marginal_mod.M - 1)
    odd = (odd_spec, dict(seed=FREE_SEED, n_particles=FREE_P,
                          steps=FREE_STEPS,
                          n_dim_particles=marginal_mod.K_LAT))
    est_cases = _estimator_cases()
    out = workers.run_world(workers.mc_checks, world,
                            tmp_path_factory.mktemp("mc"), N_MC, est_cases,
                            engine_cases, odd)
    return world, out, dict(est=est_cases, engines=engine_cases, tf=tf,
                            odd=odd)


def test_the_mesh_is_row_major(mc_world):
    world, out, _ = mc_world
    for rank, rank_out in enumerate(out):
        assert rank_out["names"] == ("p", "mc")
        assert rank_out["mesh"] == (world // N_MC, N_MC)
        assert (rank_out["p_rank"], rank_out["mc_rank"]) == divmod(rank,
                                                                   N_MC)
        assert rank_out["p_size"] == world // N_MC
        assert rank_out["mc_size"] == N_MC


EST_NAMES = ("score", "score_c", "score_rb", "joint_score", "reparam",
             "reparam_shared")


@pytest.mark.parametrize("name", EST_NAMES)
def test_estimator_rows_match_the_unsharded_estimators(mc_world, name):
    world, out, cases = mc_world
    spec, state, stream, noise = cases["est"][name]
    want = workers._estimator_outputs(workers._engine(spec, None).est, state,
                                      stream, noise)
    p = world // N_MC
    n = EST_P // p
    for rank_out in out:
        got = rank_out[("est", name)]
        rows = slice(rank_out["p_rank"] * n, (rank_out["p_rank"] + 1) * n)
        assert set(got) == set(want)
        for key in want:
            parts = want[key]
            if key == "z":  # (dz, baseline): the baseline bitwise
                assert torch.equal(got[key][1], parts[1][rows]), name
                parts, mine = parts[0], got[key][0]
            else:
                mine = got[key]
            for a, b in zip(tree_leaves(mine), tree_leaves(parts)):
                b = b[rows]
                err = float((a - b).abs().max())
                assert err <= 1e-4 * float(b.abs().max()), (name, key, err)


@pytest.mark.parametrize("name", ENGINES)
def test_teacher_forced_phi_matches_the_reference_on_its_mc_mesh(mc_world,
                                                                  name):
    world, out, cases = mc_world
    refs = cases["tf"][name][4]
    for rank_out in out:
        phis = rank_out[("engine", name)]["phi"]
        assert len(phis) == len(refs) == TF_STEPS
        for t, (got, want) in enumerate(zip(phis, refs)):
            got = tree_leaves(got if isinstance(got, tuple) else [got])
            assert len(got) == len(want)
            for a, b in zip(got, want):
                tol = 1e-4 * np.abs(b).max()
                err = np.abs(a.numpy() - b).max()
                assert err <= tol, (name, world, t, err, tol)


def _state_leaves(state):
    return [leaf for leaf in tree_leaves(list(state)[2:])
            if isinstance(leaf, torch.Tensor)]


@pytest.mark.parametrize("name", ENGINES)
def test_free_run_matches_the_unsharded_port_and_ranks_agree(mc_world, name):
    world, out, cases = mc_world
    spec, _, _, _, free = cases["engines"][name]
    run = workers._engine(spec, None).sample(**free, return_state=True)
    first = out[0][("engine", name)]
    for rank_out in out:
        got = rank_out[("engine", name)]
        assert torch.equal(got["g"], run[0]), (name, world)
        err = float((got["state"].z - run[-1].z).abs().max())
        assert err <= 1e-4, (name, world, err)
        for a, b in zip(_state_leaves(got["state"]),
                        _state_leaves(first["state"])):
            assert torch.equal(a, b), (name, world)


@pytest.mark.parametrize("name", ENGINES)
def test_sample_tensors_are_split_over_both_axes(mc_world, name):
    world, out, cases = mc_world
    spec = cases["engines"][name][0]
    p_local = 4 // (world // N_MC)  # the reference runs' P = 4
    m, k = spec[2]["n_grad_mc_samples"], spec[2]["n_acyclicity_mc_samples"]
    for rank_out in out:
        shapes = rank_out[("engine", name)]["shapes"]
        assert shapes, name
        for shape in shapes:
            assert shape[0] == p_local, (name, shape)
            assert shape[1] in (m // N_MC, k // N_MC), (name, shape)


def test_odd_sample_count_runs_replicated_and_bad_n_mc_raises(mc_world):
    world, out, cases = mc_world
    spec, free = cases["odd"]
    run = workers._engine(spec, None).sample(**free, return_state=True)
    for rank_out in out:
        assert torch.equal(rank_out["odd"]["g"], run[0])
        err = float((rank_out["odd"]["state"].z - run[-1].z).abs().max())
        assert err <= 1e-4, err
        assert "not divisible by n_mc=3" in rank_out["refusal"]
