"""Joint fleets off the fused kernels, against ``dibs_tpu.fleet`` and
against single port runs, on the CPU: joint ``grad_estimator_z='score'``
(linear and MLP, baselines 0 and 0.5) and the generic reparameterization
route (MLPs that kernel #8 declines: two hidden layers, ``bias=False``;
``fused_sample_sharing`` ``'hard'`` and ``None``). Both score each
particle's samples with ``log_joint_prob`` on its own dataset's data, one
call for the whole ``[B P]`` batch.

The reference fleet vmaps ``JointDiBS``'s step over the datasets with one
key a dataset; each dataset's noise is rebuilt from its key schedule: per
step ``split(state.key, 4)`` gives ``(key, k_theta, k_lik, k_prior)``.
Joint ``score`` (``tests/test_torch_joint_score.py``): the Z estimator's
hard graphs are ``uniform(k_g) < p`` with ``k_g = split(split(k_lik,
P)[p])[1]``, injected into the port as ``l = log(1 - u) - log(u)``; the
Theta estimator's noise is ``logistic(split(k_theta, P)[0], [P, M, d,
d])``. The generic route (``tests/test_torch_fleet_joint.py``): with
``'hard'`` one ``logistic(k_lik, [P, M, d, d])`` serves both gradients,
with ``None`` the soft noise comes from ``split(k_lik, P)[0]`` and the hard
noise from ``split(k_theta, P)[0]``. The acyclicity noise is
``logistic(split(k_prior, P)[0], [P, K, d, d])``.

Bars: teacher-forced ``phi_z`` and every ``phi_theta`` leaf of every
dataset within ``1e-4 max|phi|``, the score baseline within 1e-5
relative; a free run on the reference's noise ends where
``dibs_tpu.fleet.fleet_sample`` ends (``z`` by the fraction rule of
``tests/test_torch_joint.py``, graphs equal). N=10 (linear) and N=8
(MLP), as the joint parity tests: the reference's uncentred float32
log-likelihood stays inside the bar there.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random, vmap

from dibs_tpu.fleet import fleet_sample as jax_fleet_sample
from dibs_tpu.inference import JointDiBS as JaxJointDiBS
from dibs_tpu.inference.transport import joint_transport as jax_transport
from dibs_tpu.models import DenseNonlinearGaussian as JaxMLP
from dibs_tpu.models import ScaleFreeDAGDistribution as JaxSF
from dibs_tpu.target import make_linear_gaussian_model as jax_linear
from dibs_tpu.target import make_nonlinear_gaussian_model as jax_nonlinear
from dibs_tpu_torch.fleet import fleet_init_state, fleet_sample, fleet_seeds
from dibs_tpu_torch.inference import JointDiBS
from dibs_tpu_torch.interop import (
    fleet_state_from_reference,
    linear_gaussian_from_reference,
    nonlinear_gaussian_from_reference,
)
from dibs_tpu_torch.models import ScaleFreeDAGDistribution
from dibs_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

B, D, P, M, K_ACYC, STEPS, FREE = 3, 6, 4, 8, 4, 20, 6
SIZES = dict(B=B, D=D, P=P, M=M, K=K_ACYC, N=10, STEPS=STEPS, FREE=FREE)

# case: (model, hidden layers, bias, estimator, baseline, sharing)
CASES = {
    "score linear": ("linear", None, True, "score", 0.0, "hard"),
    "score linear baseline": ("linear", None, True, "score", 0.5, "hard"),
    "score mlp": ("mlp", (3,), True, "score", 0.0, "hard"),
    "score mlp baseline": ("mlp", (3,), True, "score", 0.5, "hard"),
    "generic (3, 3) shared": ("mlp", (3, 3), True, "reparam", 0.0, "hard"),
    "generic (3, 3) separate": ("mlp", (3, 3), True, "reparam", 0.0, None),
    "generic no bias shared": ("mlp", (3,), False, "reparam", 0.0, "hard"),
    "generic no bias separate": ("mlp", (3,), False, "reparam", 0.0, None),
}


def spec(model="linear", hidden=None, bias=True, estimator="reparam",
         baseline=0.0, sharing="hard", kernel=None, **sizes):
    """A joint fleet case: the likelihood, the estimator, the SVGD kernel
    (``None``: the engine's default; a dict: its ``kernel_param``;
    otherwise a kernel instance that both packages take) and the sizes
    (``SIZES``, with ``sizes`` replacing any of them; ``N`` is the linear
    model's, the MLP's is 8)."""
    return dict(model=model, hidden=hidden, bias=bias, estimator=estimator,
                baseline=baseline, sharing=sharing, kernel=kernel,
                **dict(SIZES, **sizes))


def datasets(sp):
    """``B`` datasets from the reference's factory seeded ``0..B-1`` and
    the reference's likelihood model."""
    d = sp["D"]
    if sp["model"] == "linear":
        out = [jax_linear(key=random.PRNGKey(b), n_vars=d,
                          n_observations=sp["N"]) for b in range(sp["B"])]
        lm = out[0][2]
    else:
        out = [jax_nonlinear(key=random.PRNGKey(b), n_vars=d,
                             n_observations=8, hidden_layers=sp["hidden"])
               for b in range(sp["B"])]
        lm = JaxMLP(n_vars=d, hidden_layers=sp["hidden"], bias=sp["bias"])
    return np.stack([np.array(data.x) for data, _, _ in out]), lm


def engines(sp, lm):
    """The reference engine and a maker of port engines for ``sp``."""
    d = sp["D"]
    kw = dict(n_grad_mc_samples=sp["M"], n_acyclicity_mc_samples=sp["K"],
              grad_estimator_z=sp["estimator"],
              score_function_baseline=sp["baseline"],
              fused_sample_sharing=sp["sharing"])
    if isinstance(sp["kernel"], dict):
        kw["kernel_param"] = sp["kernel"]
    elif sp["kernel"] is not None:
        kw["kernel"] = sp["kernel"]

    def reference(x):
        return JaxJointDiBS(x=jnp.asarray(x), graph_model=JaxSF(d),
                            likelihood_model=lm, **kw)

    if sp["model"] == "linear":
        lik = linear_gaussian_from_reference(
            n_vars=d, obs_noise=lm.obs_noise, mean_edge=lm.mean_edge,
            sig_edge=lm.sig_edge, min_edge=lm.min_edge)
    else:
        lik = nonlinear_gaussian_from_reference(
            n_vars=d, hidden_layers=lm.hidden_layers, obs_noise=lm.obs_noise,
            sig_param=lm.sig_param, activation=lm.activation, bias=lm.bias)

    def port(x):
        with warnings.catch_warnings():  # "fused ... kernel disabled"
            warnings.simplefilter("ignore", UserWarning)
            return JointDiBS(x=torch.as_tensor(x),
                             graph_model=ScaleFreeDAGDistribution(d),
                             likelihood_model=lik, device="cpu", **kw)

    return reference, port


def assert_at_bar(ours, theirs, what):
    """``|ours - theirs| <= 1e-4 max|theirs|`` over the finite elements of
    ``theirs``, and ``ours`` non-finite exactly where ``theirs`` is: joint
    ``score`` with the signed baseline overflows where the baseline lies
    far above every sample's log-probability (the reference's formula,
    ``ROADMAP.md`` queue 3, PR 17), and the port must overflow with it."""
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    finite = np.isfinite(theirs)
    assert np.array_equal(np.isfinite(ours), finite), what
    if finite.any():
        err = np.abs(ours[finite] - theirs[finite]).max()
        tol = 1e-4 * np.abs(theirs[finite]).max()
        assert err <= tol, (*what, err, tol)


def port_grads(est, z, theta, baseline, t, noise, shared):
    """``[dZ, dTheta leaves...]`` of the port's likelihood estimators
    ``est`` on one dataset, with the injected ``noise = (eps_soft,
    eps_hard)`` (one batch where ``shared``), in float64."""
    if shared:
        dz, dth = est.fused_grad_both(z, theta, t, 0, (0, 0), eps=noise)
    else:
        dth = est.eltwise_grad_theta_likelihood(z, theta, t, 0, 0,
                                                eps=noise[1])
        dz, _ = est.eltwise_grad_z_likelihood(z, theta, baseline, t, 0, 0,
                                              eps=noise[0])
    return [g.detach().double().numpy() for g in [dz] + tree_leaves(dth)]


def reference_grads(ref, st, x, shared):
    """The same for the reference engine on its state ``st`` of one dataset
    ``x`` (its keys draw the noise the port was given)."""
    _, k_theta, k_lik, _ = random.split(st.key, 4)
    p = st.z.shape[0]
    data = dict(x=jnp.asarray(x), interv_mask=jnp.zeros(x.shape, jnp.int32))
    if shared:
        dz, dth = ref.est.fused_grad_both(st.z, st.theta, st.t, k_lik, **data)
    else:
        dth = ref.est.eltwise_grad_theta_likelihood(
            st.z, st.theta, st.t, random.split(k_theta, p), **data)
        dz, _ = ref.est.eltwise_grad_z_likelihood(
            st.z, st.theta, st.sf_baseline, st.t, random.split(k_lik, p),
            **data)
    return [np.asarray(g, np.float64)
            for g in [dz] + jax.tree_util.tree_leaves(dth)]


def arbitrate(ref, make_port, xs, st, state, noise, phis, b):
    """Where the fleet's ``phi`` misses the bar against the reference at
    dataset ``b``: (1) the fleet's ``phi`` of dataset ``b`` is a single
    port engine's on ``xs[b]`` (same state and noise) within the bar, so
    the batching did not move it; (2) each likelihood gradient of the port
    (``dZ`` and every ``dTheta`` leaf, same noise) is no farther from a
    float64 evaluation of the same estimator (the port's, in float64) than
    the reference's is, plus one bar (``1e-4 max|reference|``): the miss
    is float32 rounding, the reference's uncentred scoring at a near-tie
    or joint ``score``'s baseline weights near overflow. Returns ``(t, b,
    [(port error, reference error, bar) a gradient])``."""
    from dibs_tpu_torch.inference.estimators import make_estimators

    take = lambda a: a[b]  # noqa: E731
    single = make_port(xs[b])
    one = state._replace(seed=0, z=state.z[b],
                         theta=tree_map(take, state.theta),
                         sf_baseline=state.sf_baseline[b])
    eps = tuple(e[b] for e in noise)
    with torch.no_grad():
        want = single._make_transport(single._resolve_latent_std(
            single.n_vars))(one, eps)
    for ours, w in zip([phis[0]] + tree_leaves(phis[1]),
                       [want[0]] + tree_leaves(want[1])):
        assert_at_bar(ours[b].numpy(), w.numpy(), (b, int(state.t)))

    shared = single.est.fused_grad_both is not None
    x64 = single.x.double()
    kw = {k: v for k, v in single._est_kwargs.items()
          if k not in ("fused_linear_model", "fused_nonlinear_model")}
    est64 = make_estimators(cfg=single.cfg, x=x64,
                            interv_mask=torch.zeros_like(x64), **kw)
    dbl = lambda a: a.double()  # noqa: E731
    exact = port_grads(est64, dbl(one.z), tree_map(dbl, one.theta),
                       dbl(one.sf_baseline), state.t,
                       tuple(map(dbl, eps[:2])), shared)
    ours = port_grads(single.est, one.z, one.theta, one.sf_baseline,
                      state.t, eps[:2], shared)
    theirs = reference_grads(ref, jax.tree_util.tree_map(take, st), xs[b],
                             shared)
    errs = []
    for o, r, e in zip(ours, theirs, exact):
        errs.append((float(np.abs(o - e).max()), float(np.abs(r - e).max()),
                     1e-4 * float(np.abs(r).max())))
        assert errs[-1][0] <= errs[-1][1] + errs[-1][2], (int(state.t), b,
                                                          errs[-1])
    return int(state.t), b, errs


def reference_fleet_run(ref, xs, sp, key):
    """The reference fleet stepped as ``fleet_sample`` steps it; per step
    the stacked state, each dataset's transports and baselines, and the
    noise ``(eps_soft, eps_hard, eps_acyc)`` its samplers drew."""
    n_ds, d, p, m, k = (sp[n] for n in "BDPMK")
    std = ref._resolve_latent_std(d)
    bstep = jax.jit(vmap(ref._make_step(std), in_axes=(0, 0, 0)))
    shared = sp["estimator"] == "reparam" and sp["sharing"] == "hard"

    def phi_and_noise(st, x, interv):
        _, k_theta, k_lik, k_prior = random.split(st.key, 4)
        keys_theta = random.split(k_theta, p)
        keys_lik = random.split(k_lik, p)
        keys_prior = random.split(k_prior, p)
        baseline = st.sf_baseline
        if shared:
            dz_lik, dtheta = ref.est.fused_grad_both(
                st.z, st.theta, st.t, k_lik, x=x, interv_mask=interv)
            eps_soft = eps_hard = random.logistic(k_lik, (p, m, d, d))
        else:
            dtheta = ref.est.eltwise_grad_theta_likelihood(
                st.z, st.theta, st.t, keys_theta, x=x, interv_mask=interv)
            dz_lik, baseline = ref.est.eltwise_grad_z_likelihood(
                st.z, st.theta, st.sf_baseline, st.t, keys_lik, x=x,
                interv_mask=interv)
            if sp["estimator"] == "score":
                # the reference's per-particle draw: key, k_g = split(key)
                k_g = vmap(lambda k: random.split(k)[1])(keys_lik)
                u = vmap(lambda k: random.uniform(k, (m, d, d)))(k_g)
                eps_soft = jnp.log(1.0 - u) - jnp.log(u)
            else:
                eps_soft = random.logistic(keys_lik[0], (p, m, d, d))
            eps_hard = random.logistic(keys_theta[0], (p, m, d, d))
        dz_prior = ref.est.eltwise_grad_latent_prior(st.z, keys_prior, st.t,
                                                     std)
        phi = jax_transport(ref.kernel, st.z, st.theta, dz_prior + dz_lik,
                            dtheta)
        return phi, baseline, (eps_soft, eps_hard, random.logistic(
            keys_prior[0], (p, k, d, d)))

    bphi = jax.jit(vmap(phi_and_noise))
    x_b = jnp.asarray(xs)
    interv = jnp.zeros(x_b.shape, jnp.int32)
    states = vmap(lambda kk: ref.init_state(key=kk, n_particles=p))(
        random.split(key, n_ds))
    out = []
    for _ in range(sp["STEPS"]):
        phi, baseline, noise = bphi(states, x_b, interv)
        out.append((jax.device_get(states), jax.device_get(phi),
                    np.asarray(baseline),
                    tuple(torch.from_numpy(np.array(e)) for e in noise)))
        states = bstep(states, x_b, interv)
    return out


def fleet_transport(port, xs):
    """The port fleet's transport and step on ``xs``."""
    x_t = torch.as_tensor(xs)
    std = port._resolve_latent_std(port.n_vars)
    transport = port._make_fleet_transport(
        x_t, torch.zeros(x_t.shape, dtype=torch.int32), std)
    return transport, port._make_step(std, transport_fn=transport)


def check_reference_fleet(sp):
    """Teacher-forced ``phi`` of every dataset within 1e-4 max|phi| of the
    reference fleet's over ``STEPS`` steps (the score baseline within 1e-5
    relative), then a free run on the reference's noise that ends where
    ``dibs_tpu.fleet.fleet_sample`` ends. Returns the port engine."""
    xs, lm = datasets(sp)
    reference, make_port = engines(sp, lm)
    ref, port = reference(xs[0]), make_port(xs[0])
    key = random.PRNGKey(5)
    run = reference_fleet_run(ref, xs, sp, key)
    transport, step = fleet_transport(port, xs)
    seeds = [0] * sp["B"]  # the noise is injected: the keys draw nothing
    arbitrated = []
    for st, (phi_z_ref, phi_t_ref), baseline_ref, noise in run:
        state = fleet_state_from_reference(st, seeds=seeds, device="cpu")
        with torch.no_grad():
            phi_z, phi_t, baseline = transport(state, noise)
        pairs = [(phi_z, phi_z_ref)] + list(zip(
            tree_leaves(phi_t), jax.tree_util.tree_leaves(phi_t_ref)))
        for b in range(sp["B"]):
            try:
                for ours, theirs in pairs:
                    assert_at_bar(ours[b].numpy(), theirs[b],
                                  (b, int(state.t)))
            except AssertionError:
                arbitrated.append(arbitrate(ref, make_port, xs, st, state,
                                            noise, (phi_z, phi_t), b))
        np.testing.assert_allclose(baseline.numpy(), baseline_ref, rtol=1e-5)

    state = fleet_state_from_reference(run[0][0], seeds=seeds, device="cpu")
    for *_, noise in run[:sp["FREE"]]:
        state = step(state, noise)
    gs_ref, _, st_ref = jax_fleet_sample(
        ref, xs=jnp.asarray(xs), key=key, n_particles=sp["P"],
        steps=sp["FREE"], return_states=True)
    z_ref = np.asarray(st_ref.z)
    assert np.array_equal(np.isfinite(state.z.numpy()), np.isfinite(z_ref))
    diff = np.abs(np.nan_to_num(state.z.numpy()) - np.nan_to_num(z_ref))
    assert float((diff > 5e-5).mean()) < 5e-3 and diff.max() < 5e-3
    np.testing.assert_array_equal(port.particle_to_g_lim(state.z).numpy(),
                                  np.asarray(gs_ref))
    np.testing.assert_allclose(state.sf_baseline.numpy(),
                               np.asarray(st_ref.sf_baseline), rtol=1e-4)
    return port, arbitrated


def check_single_port_runs(sp, steps=4):
    """Dataset b of the fleet is a single engine on ``xs[b]`` seeded
    ``fleet_seeds(seed, B)[b]``: the same initial state, the same
    transports every step (Philox noise), the same final state."""
    xs, lm = datasets(sp)
    _, make_port = engines(sp, lm)
    port = make_port(xs[0])
    transport, step = fleet_transport(port, xs)
    n_ds, p = sp["B"], sp["P"]
    seeds = fleet_seeds(4, n_ds)
    singles = [make_port(x) for x in xs]
    state = fleet_init_state(port, seeds, p)
    ones = [e.init_state(seed=int(s), n_particles=p)
            for e, s in zip(singles, seeds.tolist())]
    std = port._resolve_latent_std(sp["D"])
    for _ in range(steps):
        with torch.no_grad():
            phi_z, phi_t, baseline = transport(state)
        for b, (e, one) in enumerate(zip(singles, ones)):
            with torch.no_grad():
                want_z, want_t, want_b = e._make_transport(std)(one)
            for ours, want in [(phi_z[b], want_z)] + [
                    (o[b], w) for o, w in zip(tree_leaves(phi_t),
                                              tree_leaves(want_t))]:
                assert_at_bar(ours.numpy(), want.numpy(), (b, int(state.t)))
            torch.testing.assert_close(baseline[b], want_b, rtol=1e-5,
                                       atol=0.0, equal_nan=True)
            ones[b] = e._make_step(std)(one)
        state = step(state)
    gs, thetas, final = fleet_sample(port, xs=xs, seed=4, n_particles=p,
                                     steps=steps, return_states=True)
    assert final.t == steps
    for b, (e, one) in enumerate(zip(singles, ones)):
        assert torch.equal(gs[b], e.particle_to_g_lim(one.z))
        for ours, want in zip(tree_leaves(thetas), tree_leaves(one.theta)):
            torch.testing.assert_close(ours[b], want, rtol=1e-5, atol=1e-6,
                                       equal_nan=True)
        torch.testing.assert_close(final.sf_baseline[b], one.sf_baseline,
                                   rtol=1e-5, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_matches_reference_fleet(case):
    """Teacher-forced ``phi`` and baselines, then a free run, against the
    reference fleet (:func:`check_reference_fleet`). At most one (step,
    dataset) pair a case passes the bar (``ROADMAP.md`` queue 3): joint
    ``score`` with the baseline where its weights near overflow (linear: t
    = 11, dataset 2, 2.44x, at |phi| ~ 2.5e38; MLP: t = 7, dataset 0,
    1.05x) and the generic route without biases, separate noise (t = 3,
    dataset 1, 2.04x: the reference's ``dZ`` 0.0111 from float64, the
    port's 1.9e-4); there :func:`arbitrate` holds the fleet to a single
    port engine and both packages to a float64 evaluation."""
    port, arbitrated = check_reference_fleet(spec(*CASES[case]))
    assert len(arbitrated) <= 1, arbitrated
    # the route under test: no fused kernel (the shared-noise generic
    # estimators where sharing is 'hard' and the estimator reparam)
    fused = port.est.fused_grad_both
    assert fused is None or fused.__name__ == "fused_shared", case


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_matches_single_port_runs(case):
    check_single_port_runs(spec(*CASES[case]))


def test_generic_fleet_scores_each_particle_on_its_datasets_data():
    """``log_joint_prob`` of a fleet: one call over ``[B P, M]`` samples
    equals each dataset's call on its own data, linear and MLP."""
    from dibs_tpu_torch.inference.estimators import make_estimators

    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.normal(size=(B, 8, D)).astype(np.float32))
    masks = torch.from_numpy((rng.uniform(size=(B, 8, D)) < 0.2)
                             .astype(np.int32))
    eps = torch.from_numpy(rng.logistic(size=(B * P, M, D, D))
                           .astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(B * P, D, D, 2))
                         .astype(np.float32))
    for sp in (spec(estimator="score"), spec("mlp", (3, 3), False)):
        _, lm = datasets(sp)
        _, make_port = engines(sp, lm)
        port = make_port(xs[0].numpy())
        theta = port.likelihood_model.sample_parameters(
            generator=torch.Generator().manual_seed(3), n_particles=B * P,
            n_vars=D, device="cpu")
        kw = dict(cfg=port.cfg, log_graph_prior=port.log_graph_prior,
                  log_joint_prob=port.log_joint_prob)
        fleet = make_estimators(x=xs, interv_mask=masks, **kw)
        got = fleet.eltwise_grad_theta_likelihood(z, theta, 3, 0, 0,
                                                  eps=eps)
        for b in range(B):
            rows = slice(b * P, (b + 1) * P)
            one = make_estimators(x=xs[b], interv_mask=masks[b], **kw)
            want = one.eltwise_grad_theta_likelihood(
                z[rows], tree_map(lambda a: a[rows], theta), 3, 0, 0,
                eps=eps[rows])
            for a, w in zip(tree_leaves(got), tree_leaves(want)):
                torch.testing.assert_close(a[rows], w, rtol=1e-5, atol=1e-5)


def test_single_mlp_log_likelihood_is_unchanged():
    """``DenseNonlinearGaussian.log_likelihood`` on one dataset's ``x [N,
    d]`` is bitwise the form it had before data could carry leading dims
    (``x @ (g^T[..., None] * W1)``, then the layers), for the estimators'
    ``[P, M]`` broadcast and one graph; with ``x [B, 1, 1, N, d]`` it
    equals each dataset's call."""
    from dibs_tpu_torch.models import DenseNonlinearGaussian
    from dibs_tpu_torch.models.linear_gaussian import _normal_logpdf

    rng = np.random.default_rng(8)
    for bias in (True, False):
        mlp = DenseNonlinearGaussian(n_vars=D, hidden_layers=(3, 2),
                                     bias=bias)
        theta = mlp.sample_parameters(
            generator=torch.Generator().manual_seed(1), n_particles=P,
            n_vars=D, device="cpu")
        x = torch.from_numpy(rng.normal(size=(9, D)).astype(np.float32))
        mask = torch.zeros_like(x)
        g = torch.from_numpy((rng.uniform(size=(P, M, D, D)) < 0.4)
                             .astype(np.float32))
        th = tree_map(lambda leaf: leaf[:, None], theta)

        def before(th, g):
            h = x @ (g.transpose(-1, -2)[..., None] * th[0][0])
            if bias:
                h = h + th[0][1][..., None, :]
            for layer in th[1:]:
                h = torch.relu(h) @ layer[0]
                if bias:
                    h = h + layer[1][..., None, :]
            means = h[..., 0].transpose(-1, -2)
            logpdf = _normal_logpdf(x, means, mlp.obs_noise ** 0.5)
            return torch.where(mask.bool(), torch.zeros_like(logpdf),
                               logpdf).sum((-2, -1))

        got = mlp.log_likelihood(x=x, theta=th, g=g, interv_targets=mask)
        assert torch.equal(got, before(th, g))
        one = tree_map(lambda leaf: leaf[0], theta)
        assert torch.equal(mlp.log_likelihood(x=x, theta=one, g=g[0, 0],
                                              interv_targets=mask),
                           before(one, g[0, 0]))
        xs = torch.from_numpy(rng.normal(size=(B, 9, D)).astype(np.float32))
        gb = g[None].expand(B, *g.shape)
        thb = tree_map(lambda leaf: leaf[None, :, None], theta)
        fleet = mlp.log_likelihood(x=xs[:, None, None],
                                   theta=thb, g=gb,
                                   interv_targets=torch.zeros_like(
                                       xs[:, None, None]))
        for b in range(B):
            torch.testing.assert_close(fleet[b], mlp.log_likelihood(
                x=xs[b], theta=th, g=g, interv_targets=torch.zeros_like(
                    xs[b])), rtol=1e-6, atol=1e-4)
