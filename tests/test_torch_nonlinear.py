"""Port parity for the MLP model and the parameter-tree engine pieces:
DenseNonlinearGaussian, the nonlinear factory, tree rmsprop, the joint SE
kernel and the joint transport over parameter trees, and the generic
estimators with tree Theta, against dibs_tpu on the CPU.

Parameters are drawn by the reference and carried across with
``interop.params_from_reference``; data and graphs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu.inference.optimizers import rmsprop as jax_rmsprop
from dibs_tpu.inference.transport import joint_transport as jax_joint_transport
from dibs_tpu.kernel import JointAdditiveFrobeniusSEKernel as JaxJointKernel
from dibs_tpu.models import DenseNonlinearGaussian as JaxMLP
from dibs_tpu.utils.func import pytree_sq_norm_matrix as jax_sq_norm_matrix
from dibs_tpu_torch.inference import JointDiBS
from dibs_tpu_torch.inference.optimizers import GradientDescent, RMSProp
from dibs_tpu_torch.inference.transport import joint_transport
from dibs_tpu_torch.interop import (
    nonlinear_gaussian_from_reference,
    params_from_reference,
    target_from_reference,
)
from dibs_tpu_torch.kernel import JointAdditiveFrobeniusSEKernel
from dibs_tpu_torch.models import DenseNonlinearGaussian, ScaleFreeDAGDistribution
from dibs_tpu_torch.ops.acyclic import acyclic_constr
from dibs_tpu_torch.target import make_nonlinear_gaussian_model
from dibs_tpu_torch.utils.func import pytree_sq_norm_matrix
from dibs_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_rows,
    tree_unflatten,
)

torch.set_num_threads(1)

D, P, N_OBS = 6, 3, 15


def _leaves_np(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _models(activation, bias, hidden):
    kw = dict(n_vars=D, hidden_layers=hidden, obs_noise=0.2, sig_param=1.3,
              activation=activation, bias=bias)
    return JaxMLP(**kw), nonlinear_gaussian_from_reference(**kw)


def _data(seed=0, b=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_OBS, D)).astype(np.float32)
    interv = (rng.uniform(size=(N_OBS, D)) < 0.2).astype(np.int32)
    gs = (rng.uniform(size=(b, D, D)) < 0.4).astype(np.float32)
    gs *= 1.0 - np.eye(D, dtype=np.float32)
    soft = rng.uniform(size=(b, D, D)).astype(np.float32)
    return x, interv, gs, soft


# ---------------------------------------------------------------------------
# (a) the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden", [(5,), (4, 3)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid",
                                        "leakyrelu"])
def test_model_matches_reference(activation, bias, hidden):
    """Means, parameter prior and joint log-prob, single and broadcast
    ``[P, M]`` shapes, rtol 2e-6 (float32 sums in another order)."""
    ref, ours = _models(activation, bias, hidden)
    x, interv, gs, soft = _data()
    theta = ref.sample_parameters(key=random.PRNGKey(3), n_vars=D,
                                  n_particles=P)
    th = params_from_reference(jax.tree_util.tree_map(np.asarray, theta),
                               device="cpu")
    x_t, i_t = torch.from_numpy(x), torch.from_numpy(interv)
    # broadcast: [P, M] graphs against [P, 1, ...] leaves, as the estimators
    g_pm = torch.from_numpy(np.stack([gs, soft, gs[::-1]])[:P])  # [P, 4, d, d]
    lp_pm = ours.interventional_log_joint_prob(
        g_pm, tree_map(lambda leaf: leaf[:, None], th), x_t, i_t, None)
    assert lp_pm.shape == (P, 4)
    for pi in range(P):
        th_p = jax.tree_util.tree_map(lambda a: a[pi], theta)
        th_t = tree_map(lambda leaf: leaf[pi], th)
        for mi in range(4):
            g = g_pm[pi, mi]
            g_j = jnp.asarray(g.numpy())
            want = ref.interventional_log_joint_prob(
                g_j, th_p, jnp.asarray(x), jnp.asarray(interv), None)
            got = ours.interventional_log_joint_prob(g, th_t, x_t, i_t, None)
            np.testing.assert_allclose(got.item(), want, rtol=2e-6)
            np.testing.assert_allclose(lp_pm[pi, mi].item(), want, rtol=2e-6)
        np.testing.assert_allclose(
            ours.all_node_means(th_t, x_t, torch.from_numpy(soft[0])).numpy(),
            ref.all_node_means(th_p, jnp.asarray(x), jnp.asarray(soft[0])),
            rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            ours.log_prob_parameters(theta=th_t,
                                     g=torch.from_numpy(soft[1])).item(),
            ref.log_prob_parameters(theta=th_p, g=jnp.asarray(soft[1])),
            rtol=2e-6)
    # the mixture's shape: [P, d, d] graphs with [P, ...] leaves
    lp_p = ours.interventional_log_joint_prob(g_pm[:, 0], th, x_t, i_t, None)
    np.testing.assert_allclose(lp_p.numpy(), lp_pm[:, 0].numpy(), rtol=1e-6)
    shapes = ours.get_theta_shape(n_vars=D)
    assert [tuple(s) for layer in shapes for s in layer] == [
        tuple(a.shape[1:]) for a in tree_leaves(th)]


def test_sample_parameters_layout_and_device_rule():
    model = DenseNonlinearGaussian(n_vars=D, hidden_layers=(5,))
    gen = torch.Generator().manual_seed(0)
    th = model.sample_parameters(generator=gen, n_vars=D, n_particles=P,
                                 device="cpu")
    assert [tuple(a.shape) for a in tree_leaves(th)] == [
        (P, D, D, 5), (P, D, 5), (P, D, 5, 1), (P, D, 1)]
    assert isinstance(th, list) and isinstance(th[0], tuple)
    single = model.sample_parameters(generator=gen, n_vars=D, device="cpu")
    assert tuple(single[0][0].shape) == (D, D, 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.sample_parameters(generator=gen, n_vars=D)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_nonlinear_gaussian_model(generator=gen, n_vars=D)
    with pytest.raises(KeyError):
        DenseNonlinearGaussian(n_vars=D, hidden_layers=(5,), activation="elu")


def test_sample_obs_matches_reference_semantics():
    """Parentless nodes are pure noise; intervened nodes are clamped; the
    port's ancestral sampler gives the reference's means at zero noise."""
    ref, ours = _models("relu", True, (5,))
    theta = ref.sample_parameters(key=random.PRNGKey(2), n_vars=D)
    th = params_from_reference(jax.tree_util.tree_map(np.asarray, theta),
                               device="cpu")
    g = np.triu(np.ones((D, D), np.int32), 1)
    g[:, 3] = 0  # node 3 has no parents
    gen = torch.Generator().manual_seed(0)
    ours.obs_noise = 0.0
    x = ours.sample_obs(generator=gen, n_samples=5, g=torch.from_numpy(g),
                        theta=th, interv={1: 2.5})
    assert torch.all(x[:, 1] == 2.5) and torch.all(x[:, 3] == 0.0)
    means = ref.all_node_means(theta, jnp.asarray(x.numpy()),
                               jnp.asarray(g.astype(np.float32)))
    has_pa = g.sum(0) > 0
    has_pa[1] = False
    np.testing.assert_allclose(x.numpy()[:, has_pa],
                               np.asarray(means)[:, has_pa], rtol=1e-5,
                               atol=1e-5)


def test_nonlinear_factory_builds_a_valid_problem():
    gen = torch.Generator().manual_seed(4)
    data, gm, lm = make_nonlinear_gaussian_model(
        generator=gen, n_vars=8, n_observations=30, n_ho_observations=20,
        device="cpu")
    assert isinstance(gm, ScaleFreeDAGDistribution)
    assert isinstance(lm, DenseNonlinearGaussian)
    assert (lm.hidden_layers, lm.obs_noise, lm.sig_param) == ((5,), 0.1, 1.0)
    assert data.x.shape == (30, 8) and data.x_ho.shape == (20, 8)
    assert float(acyclic_constr(data.g.float())) == 0.0
    assert torch.isfinite(data.x).all()
    assert [tuple(a.shape) for a in tree_leaves(data.theta)] == [
        (8, 8, 5), (8, 5), (8, 5, 1), (8, 1)]
    ref_theta = JaxMLP(n_vars=8, hidden_layers=(5,)).sample_parameters(
        key=random.PRNGKey(0), n_vars=8)
    g_t, th_t = target_from_reference(
        g=data.g.numpy(), theta=jax.tree_util.tree_map(np.asarray, ref_theta),
        device="cpu")
    assert g_t.dtype == torch.int32
    assert [a.dtype for a in tree_leaves(th_t)] == [torch.float32] * 4


# ---------------------------------------------------------------------------
# (e) trees through the optimizer, the kernel and the transport
# ---------------------------------------------------------------------------


def _tree_pair(seed, p=P):
    theta = JaxMLP(n_vars=D, hidden_layers=(5,)).sample_parameters(
        key=random.PRNGKey(seed), n_vars=D, n_particles=p)
    return theta, params_from_reference(
        jax.tree_util.tree_map(np.asarray, theta), device="cpu")


def test_tree_toolkit_round_trips():
    _, th = _tree_pair(0)
    leaves = tree_leaves(th)
    assert len(leaves) == 4
    back = tree_unflatten(th, [a * 2 for a in leaves])
    assert isinstance(back, list) and isinstance(back[1], tuple)
    assert torch.equal(back[1][0], 2 * th[1][0])
    rows = tree_rows(th)
    assert rows.shape == (P, D * D * 5 + D * 5 + D * 5 + D)
    assert tree_leaves(th[0][0]) == [th[0][0]]
    with pytest.raises(ValueError):
        tree_unflatten(th, leaves + leaves)


def test_tree_rmsprop_and_gd_match_reference():
    """20 rmsprop updates of a parameter tree, rtol 1e-5."""
    theta, th = _tree_pair(1)
    rng = np.random.default_rng(5)
    opt_ref, opt = jax_rmsprop(0.005), RMSProp(0.005)
    st_ref, st = opt_ref.init(theta), opt.init(th)
    params_ref, params = theta, th
    for _ in range(20):
        grads_np = [rng.normal(size=a.shape).astype(np.float32)
                    for a in tree_leaves(th)]
        g_ref = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(theta),
            [jnp.asarray(a) for a in grads_np])
        upd_ref, st_ref = opt_ref.update(g_ref, st_ref)
        params_ref = jax.tree_util.tree_map(jnp.add, params_ref, upd_ref)
        upd, st = opt.update(tree_unflatten(th, [torch.from_numpy(a)
                                                 for a in grads_np]), st)
        params = tree_map(torch.add, params, upd)
    for got, want in zip(tree_leaves(params), _leaves_np(params_ref)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for got, want in zip(tree_leaves(st[0].nu),
                         _leaves_np(st_ref[0].nu)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-9)
    upd, _ = GradientDescent(0.1).update(th, ())
    assert torch.equal(upd[0][1], -0.1 * th[0][1])


def test_tree_distances_and_joint_kernel_match_reference():
    theta, th = _tree_pair(2, p=5)
    other, oth = _tree_pair(3, p=4)
    np.testing.assert_allclose(
        pytree_sq_norm_matrix(th, oth).numpy(),
        jax_sq_norm_matrix(theta, other), rtol=1e-5)
    self_sq = pytree_sq_norm_matrix(th, th)
    assert torch.all(torch.diagonal(self_sq) == 0.0)
    rng = np.random.default_rng(6)
    z = (rng.normal(size=(5, D, 4, 2)) / 2).astype(np.float32)
    for h in (dict(h_latent=5.0, h_theta=500.0),
              dict(h_latent="median", h_theta="median")):
        got = JointAdditiveFrobeniusSEKernel(**h).component_matrices_and_factors(
            torch.from_numpy(z), th, torch.from_numpy(z), th)
        want = JaxJointKernel(**h).component_matrices_and_factors(
            jnp.asarray(z), theta, jnp.asarray(z), theta)
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)
    kern = JointAdditiveFrobeniusSEKernel(h_latent=5.0, h_theta=50.0)
    one = tree_map(lambda leaf: leaf[0], th)
    two = tree_map(lambda leaf: leaf[1], th)
    np.testing.assert_allclose(
        kern.eval(x_latent=torch.from_numpy(z[0]), x_theta=one,
                  y_latent=torch.from_numpy(z[1]), y_theta=two).item(),
        JaxJointKernel(h_latent=5.0, h_theta=50.0).eval(
            x_latent=jnp.asarray(z[0]),
            x_theta=jax.tree_util.tree_map(lambda a: a[0], theta),
            y_latent=jnp.asarray(z[1]),
            y_theta=jax.tree_util.tree_map(lambda a: a[1], theta)),
        rtol=1e-5)


class _EvalOnlyTreeJoint:
    """A joint kernel with only the reference ``eval`` signature, over
    parameter trees."""

    def eval(self, *, x_latent, x_theta, y_latent, y_theta):
        if torch.is_tensor(x_latent):
            lib, leaves = torch, tree_leaves
        else:
            lib, leaves = jnp, jax.tree_util.tree_leaves
        sq = sum(lib.sum((a - b) ** 2)
                 for a, b in zip(leaves(x_theta), leaves(y_theta)))
        return (lib.exp(-lib.sum((x_latent - y_latent) ** 2) / 5.0)
                + lib.exp(-sq / 50.0))


@pytest.mark.parametrize("kind", ["fixed", "median", "eval_only"])
def test_tree_joint_transport_matches_reference(kind):
    """Driver and centred repulsion per leaf (and the autodiff path), atol
    and rtol 1e-5."""
    theta, th = _tree_pair(4)
    rng = np.random.default_rng(7)
    z = (rng.normal(size=(P, D, 4, 2)) / 2).astype(np.float32)
    dz = rng.normal(size=z.shape).astype(np.float32)
    dth_np = [rng.normal(size=a.shape).astype(np.float32)
              for a in tree_leaves(th)]
    dtheta = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(theta), [jnp.asarray(a) for a in dth_np])
    if kind == "eval_only":
        ours_k = ref_k = _EvalOnlyTreeJoint()
    else:
        h = dict(h_latent=5.0, h_theta=50.0) if kind == "fixed" else dict(
            h_latent="median", h_theta="median")
        ours_k, ref_k = JointAdditiveFrobeniusSEKernel(**h), JaxJointKernel(**h)
    phi_z, phi_t = joint_transport(
        ours_k, torch.from_numpy(z), th, torch.from_numpy(dz),
        tree_unflatten(th, [torch.from_numpy(a) for a in dth_np]))
    ref_z, ref_t = jax_joint_transport(ref_k, jnp.asarray(z), theta,
                                       jnp.asarray(dz), dtheta)
    np.testing.assert_allclose(phi_z.numpy(), ref_z, atol=1e-5, rtol=1e-5)
    assert isinstance(phi_t, list) and isinstance(phi_t[0], tuple)
    for got, want in zip(tree_leaves(phi_t), _leaves_np(ref_t)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (g) a multi-layer MLP through the generic estimators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sharing", [None, "hard"])
def test_two_hidden_layers_run_through_the_generic_estimators(sharing):
    gen = torch.Generator().manual_seed(1)
    data, gm, lm = make_nonlinear_gaussian_model(
        generator=gen, n_vars=D, hidden_layers=(4, 3), n_observations=12,
        device="cpu")
    with pytest.warns(UserWarning, match="one hidden layer"):
        dibs = JointDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                         n_grad_mc_samples=6, n_acyclicity_mc_samples=3,
                         fused_sample_sharing=sharing, device="cpu")
    assert (dibs.est.fused_grad_both is None) == (sharing is None)
    g, theta, state = dibs.sample(seed=2, n_particles=3, steps=4,
                                  n_dim_particles=4, return_state=True)
    assert g.shape == (3, D, D) and state.t == 4
    assert [tuple(a.shape) for a in tree_leaves(theta)] == [
        (3, D, D, 4), (3, D, 4), (3, D, 4, 3), (3, D, 3), (3, D, 3, 1),
        (3, D, 1)]
    assert all(torch.isfinite(a).all() for a in tree_leaves(theta))
    assert all(torch.isfinite(a).all()
               for a in tree_leaves(state.opt_state_theta[0].nu))
    mix = dibs.get_mixture(g, theta)
    assert mix.logp.shape == (3,) and torch.isfinite(mix.logp).all()
    ll = dibs.eltwise_log_likelihood_observ(g.float(), theta, data.x_ho)
    assert ll.shape == (3,) and torch.isfinite(ll).all()
