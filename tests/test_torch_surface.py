"""The public names the JAX package has beside its engine, in the port,
against dibs_tpu on the CPU: the joint kernel's matrices and factors, the
graph priors' hard-graph log-probabilities, BGe's refusals, the
``utils.func`` helpers, the log-determinant with its closed-form backward,
``matrix_power`` and the acyclicity ``precision`` argument, the tree
helpers, the optimizer constructors and the packages' exports. Each gap is
one parametrised test; each name also has the reference's keyword names
(a ``torch.Generator`` takes the place of a JAX key).

Tolerances, as ``tests/test_torch_helpers.py``: graphs, shapes and trees
exactly; values and gradients within 1e-5 relative (float32, summed in
another order; 1e-4 for log-determinants, whose two packages eliminate in
different orders).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import dibs_tpu.ops as jax_ops
import dibs_tpu.utils as jax_utils
import dibs_tpu_torch.ops as port_ops
import dibs_tpu_torch.utils as port_utils
from dibs_tpu.inference import optimizers as jax_opt
from dibs_tpu.kernel import JointAdditiveFrobeniusSEKernel as JaxJointKernel
from dibs_tpu.models import BGe as JaxBGe
from dibs_tpu.models import ErdosReniDAGDistribution as JaxER
from dibs_tpu.models import ScaleFreeDAGDistribution as JaxSF
from dibs_tpu.models.graph import UniformDAGDistributionRejection as JaxUniform
from dibs_tpu.ops import acyclic as jax_acyclic
from dibs_tpu.ops import logdet as jax_logdet
from dibs_tpu.utils import func as jax_func
from dibs_tpu.utils import tree as jax_tree
from dibs_tpu_torch.inference import optimizers as port_opt
from dibs_tpu_torch.kernel import JointAdditiveFrobeniusSEKernel
from dibs_tpu_torch.models import (
    BGe,
    ErdosReniDAGDistribution,
    ScaleFreeDAGDistribution,
    UniformDAGDistributionRejection,
)
from dibs_tpu_torch.ops import acyclic as port_acyclic
from dibs_tpu_torch.ops import logdet as port_logdet
from dibs_tpu_torch.utils import func as port_func
from dibs_tpu_torch.utils import tree as port_tree

torch.set_num_threads(1)

D = 6
_JAX_PRECISION = {"default": jax.lax.Precision.DEFAULT,
                  "high": jax.lax.Precision.HIGH,
                  "highest": jax.lax.Precision.HIGHEST}


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    bar = rel * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bar


def _names(fn, key_to_generator=False):
    names = list(inspect.signature(fn).parameters)
    if key_to_generator:
        names = ["generator" if n == "key" else n for n in names]
    return names


def _same_names(port_fn, ref_fn, key_to_generator=False):
    assert _names(port_fn) == _names(ref_fn, key_to_generator), (
        port_fn, _names(port_fn), _names(ref_fn))


def _pd(rng, d, batch=()):
    a = rng.normal(size=batch + (d, d))
    return (a @ np.swapaxes(a, -1, -2) / d + np.eye(d)).astype(np.float32)


# ---------------------------------------------------------------------------
# the joint kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", [(5.0, 50.0), ("median", "median")])
def test_joint_kernel_matrices_and_factors(h):
    rng = np.random.default_rng(0)
    z = (rng.normal(size=(5, D, 3, 2)) / 2).astype(np.float32)
    th = rng.normal(size=(5, D, D)).astype(np.float32)
    kw = dict(h_latent=h[0], h_theta=h[1], scale_latent=0.7, scale_theta=1.3)
    port, ref = JointAdditiveFrobeniusSEKernel(**kw), JaxJointKernel(**kw)
    zt, tt = torch.from_numpy(z), torch.from_numpy(th)
    for name in ("matrix", "component_matrices", "grad_factor_z",
                 "grad_factor_theta"):
        _same_names(getattr(port, name), getattr(ref, name))
    got = port.component_matrices(zt, tt, zt, tt)
    want = ref.component_matrices(jnp.asarray(z), jnp.asarray(th),
                                  jnp.asarray(z), jnp.asarray(th))
    for a, b in zip(got, want):
        _close(a, b)
    _close(port.matrix(zt, tt, zt, tt),
           ref.matrix(jnp.asarray(z), jnp.asarray(th), jnp.asarray(z),
                      jnp.asarray(th)))
    if h[0] != "median":
        assert port.grad_factor_z() == ref.grad_factor_z()
        assert port.grad_factor_theta() == ref.grad_factor_theta()


# ---------------------------------------------------------------------------
# graph priors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("port_cls, ref_cls, d", [
    (ErdosReniDAGDistribution, JaxER, 8),
    (ScaleFreeDAGDistribution, JaxSF, 8),
    (UniformDAGDistributionRejection, JaxUniform, 4)])
def test_graph_prior_hard_log_probs(port_cls, ref_cls, d):
    port, ref = port_cls(d), ref_cls(d)
    for name in ("unnormalized_log_prob", "unnormalized_log_prob_single"):
        _same_names(getattr(port, name), getattr(ref, name))
    rng = np.random.default_rng(1)
    gs = np.tril((rng.uniform(size=(3, d, d)) < 0.4).astype(np.int32), -1)
    batched = port.unnormalized_log_prob(g=torch.from_numpy(gs))
    assert batched.shape == (3,)
    for k in range(3):
        want = ref.unnormalized_log_prob(g=jnp.asarray(gs[k]))
        _close(port.unnormalized_log_prob(g=torch.from_numpy(gs[k])), want)
        _close(batched[k], want)
        for j in range(d):
            _close(port.unnormalized_log_prob_single(
                g=torch.from_numpy(gs[k]), j=j),
                ref.unnormalized_log_prob_single(g=jnp.asarray(gs[k]), j=j))


# ---------------------------------------------------------------------------
# BGe's refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, kwargs", [
    ("get_theta_shape", dict(n_vars=D)),
    ("sample_parameters", dict(n_vars=D, n_particles=2))])
def test_bge_refuses_parameters(name, kwargs):
    port, ref = BGe(n_vars=D, device="cpu"), JaxBGe(n_vars=D)
    _same_names(getattr(port, name), getattr(ref, name),
                key_to_generator=True)
    with pytest.raises(NotImplementedError, match="LinearGaussian"):
        getattr(ref, name)(**kwargs, **(
            dict(key=random.PRNGKey(0)) if name == "sample_parameters"
            else {}))
    with pytest.raises(NotImplementedError, match="LinearGaussian"):
        getattr(port, name)(**kwargs, **(
            dict(generator=torch.Generator()) if name == "sample_parameters"
            else {}))


# ---------------------------------------------------------------------------
# utils.func
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["squared_norm_pytree", "masked_logdet_pd",
                                  "masked_slogdet", "standardize"])
def test_func_helpers_match_reference(name):
    rng = np.random.default_rng(2)
    _same_names(getattr(port_func, name), getattr(jax_func, name))
    if name == "squared_norm_pytree":
        x = [rng.normal(size=(3, 4)).astype(np.float32),
             (rng.normal(size=5).astype(np.float32),)]
        y = [rng.normal(size=(3, 4)).astype(np.float32),
             (rng.normal(size=5).astype(np.float32),)]
        got = port_func.squared_norm_pytree(
            [torch.from_numpy(x[0]), (torch.from_numpy(x[1][0]),)],
            [torch.from_numpy(y[0]), (torch.from_numpy(y[1][0]),)])
        _close(got, jax_func.squared_norm_pytree(x, y))
    elif name in ("masked_logdet_pd", "masked_slogdet"):
        m = _pd(rng, D)
        for mask in (rng.uniform(size=D).astype(np.float32),
                     (rng.uniform(size=D) < 0.5).astype(np.float32)):
            _close(getattr(port_func, name)(torch.from_numpy(m),
                                            torch.from_numpy(mask)),
                   getattr(jax_func, name)(jnp.asarray(m), jnp.asarray(mask)),
                   rel=1e-4)
    else:
        x = (3.0 * rng.normal(size=(20, D)) + 1.0).astype(np.float32)
        x[:, 2] = 4.0  # a constant column: the std's floor
        got, (mu, sd) = port_func.standardize(torch.from_numpy(x),
                                              return_stats=True)
        want, (mu_r, sd_r) = jax_func.standardize(jnp.asarray(x),
                                                  return_stats=True)
        for a, b in ((got, want), (mu, mu_r), (sd, sd_r)):
            _close(a, b)
        _close(port_func.standardize(torch.from_numpy(x)), want)


# ---------------------------------------------------------------------------
# ops.logdet with its closed-form backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [6, 70])
def test_masked_logdet_pd_and_its_backward(d):
    """Forward and gradient against ``jax.grad`` of the reference's
    ``custom_vjp``; d = 70 takes both packages' Cholesky tier."""
    rng = np.random.default_rng(3)
    m = _pd(rng, d)
    masks = rng.uniform(size=(4, d)).astype(np.float32)
    masks[1] = (masks[1] < 0.5)
    _same_names(port_logdet.masked_logdet_pd, jax_logdet.masked_logdet_pd)
    _same_names(port_logdet.batched_masked_logdet_pd,
                jax_logdet.batched_masked_logdet_pd)
    w = rng.normal(size=4).astype(np.float32)

    def ref_loss(m_, masks_):
        return jnp.sum(jnp.asarray(w) * jax_logdet.batched_masked_logdet_pd(
            m_, masks_))

    want = jax_logdet.batched_masked_logdet_pd(jnp.asarray(m),
                                               jnp.asarray(masks))
    want_dm, want_dmask = jax.grad(ref_loss, (0, 1))(jnp.asarray(m),
                                                     jnp.asarray(masks))
    mt = torch.from_numpy(m).requires_grad_(True)
    maskt = torch.from_numpy(masks).requires_grad_(True)
    got = port_logdet.batched_masked_logdet_pd(mt, maskt)
    _close(got, want, rel=1e-4)
    dm, dmask = torch.autograd.grad((torch.from_numpy(w) * got).sum(),
                                    (mt, maskt))
    _close(dm, want_dm, rel=1e-4)
    _close(dmask, want_dmask, rel=1e-4)
    # one graph's mask, unbatched, as the reference's masked_logdet_pd
    m1 = torch.from_numpy(m).requires_grad_(True)
    one = port_logdet.masked_logdet_pd(m1, torch.from_numpy(masks[0]))
    _close(one, jax_logdet.masked_logdet_pd(jnp.asarray(m),
                                            jnp.asarray(masks[0])), rel=1e-4)
    (g1,) = torch.autograd.grad(one, m1)
    _close(g1, jax.grad(jax_logdet.masked_logdet_pd)(
        jnp.asarray(m), jnp.asarray(masks[0])), rel=1e-4)


# ---------------------------------------------------------------------------
# ops.acyclic: matrix_power and the precision argument
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_matrix_power_and_acyclic_precision(precision):
    rng = np.random.default_rng(4)
    m = (rng.uniform(size=(D, D)) / D + np.eye(D)).astype(np.float32)
    g = (rng.uniform(size=(D, D)) * (1 - np.eye(D))).astype(np.float32)
    jp = _JAX_PRECISION[precision]
    _same_names(port_acyclic.matrix_power, jax_acyclic.matrix_power)
    _same_names(port_acyclic.acyclic_constr, jax_acyclic.acyclic_constr)
    _same_names(port_acyclic.acyclic_constr_spectral,
                jax_acyclic.acyclic_constr_spectral)
    for n in (0, 1, 5, 8):
        _close(port_acyclic.matrix_power(torch.from_numpy(m), n, precision),
               jax_acyclic.matrix_power(jnp.asarray(m), n, jp))
    with pytest.raises(ValueError):
        port_acyclic.matrix_power(torch.from_numpy(m), -1)
    for port_fn, ref_fn, args in (
            (port_acyclic.acyclic_constr, jax_acyclic.acyclic_constr, (D,)),
            (port_acyclic.acyclic_constr_spectral,
             jax_acyclic.acyclic_constr_spectral, (24,))):
        gt = torch.from_numpy(g).requires_grad_(True)
        h = port_fn(gt, *args, precision=precision)
        (grad,) = torch.autograd.grad(h, gt)
        h_ref, grad_ref = jax.value_and_grad(
            lambda x: ref_fn(x, *args, jp))(jnp.asarray(g))
        _close(h, h_ref)
        _close(grad, grad_ref)
    with pytest.raises(ValueError):
        port_acyclic.acyclic_constr(torch.from_numpy(g), precision="fast")


# ---------------------------------------------------------------------------
# utils.tree
# ---------------------------------------------------------------------------


def _trees(rng):
    leaves = [rng.normal(size=(3, 2, 4)).astype(np.float32),
              rng.normal(size=(3, 5)).astype(np.float32),
              rng.normal(size=(3,)).astype(np.float32)]
    ref = [(jnp.asarray(leaves[0]), jnp.asarray(leaves[1])),
           (jnp.asarray(leaves[2]),)]
    port = [(torch.from_numpy(leaves[0]), torch.from_numpy(leaves[1])),
            (torch.from_numpy(leaves[2]),)]
    return port, ref


@pytest.mark.parametrize("name", ["tree_index", "tree_select", "tree_mul",
                                  "tree_shapes", "tree_expand_leading_by",
                                  "tree_key_split", "tree_zeros_like"])
def test_tree_helpers_match_reference(name):
    port_fn, ref_fn = getattr(port_tree, name), getattr(jax_tree, name)
    _same_names(port_fn, ref_fn, key_to_generator=True)
    port, ref = _trees(np.random.default_rng(5))
    mask = np.array([True, False, True])
    if name == "tree_key_split":
        got = port_fn(torch.Generator().manual_seed(0), port)
        want = ref_fn(random.PRNGKey(0), ref)
        assert len(port_tree.tree_leaves(got)) == len(
            jax.tree_util.tree_leaves(want)) == 3
        assert all(isinstance(g, torch.Generator)
                   for g in port_tree.tree_leaves(got))
        seeds = [g.initial_seed() for g in port_tree.tree_leaves(got)]
        assert len(set(seeds)) == 3
        assert seeds == [g.initial_seed() for g in port_tree.tree_leaves(
            port_fn(torch.Generator().manual_seed(0), port))]
        return
    args = {"tree_index": (1,), "tree_select": (mask,),
            "tree_mul": (2.5,), "tree_shapes": (),
            "tree_expand_leading_by": (2,), "tree_zeros_like": ()}[name]
    port_args = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray)
                      else a for a in args)
    got = port_tree.tree_leaves(port_fn(port, *port_args))
    want = jax.tree_util.tree_leaves(ref_fn(ref, *args))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the reference's keyword names
    if name == "tree_select":
        port_fn(pytree=port, bool_mask=port_args[0])
    if name == "tree_mul":
        port_fn(pytree=port, c=2.0)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, kwargs", [
    ("rmsprop", dict(stepsize=0.01)),
    ("rmsprop", dict(stepsize=0.005, gamma=0.8, eps=1e-6)),
    ("sgd", dict(stepsize=0.1))])
def test_optimizer_constructors_match_reference(name, kwargs):
    _same_names(getattr(port_opt, name), getattr(jax_opt, name))
    port, ref = getattr(port_opt, name)(**kwargs), getattr(jax_opt, name)(
        **kwargs)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    s_port, s_ref = port.init(torch.from_numpy(x)), ref.init(jnp.asarray(x))
    for _ in range(3):
        g = rng.normal(size=(3, 4)).astype(np.float32)
        up, s_port = port.update(torch.from_numpy(g), s_port)
        up_ref, s_ref = ref.update(jnp.asarray(g), s_ref, jnp.asarray(x))
        _close(up, up_ref)


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("port_mod, ref_mod", [(port_ops, jax_ops),
                                                (port_utils, jax_utils)])
def test_package_exports_match_reference(port_mod, ref_mod):
    assert sorted(port_mod.__all__) == sorted(ref_mod.__all__)
    for name in port_mod.__all__:
        assert callable(getattr(port_mod, name))
        _same_names(getattr(port_mod, name), getattr(ref_mod, name),
                    key_to_generator=True)


# the particle-sharded package: the reference's names, and its keyword
# names wherever the port's functions take the same arguments (the
# per-shard launches take the port's seed and stream instead of a key)
SAME_SIGNATURE = {
    "parallel": ("make_particle_mesh", "particle_sharding", "shard_state",
                 "make_constraint"),
    "parallel.shard_ops": ("particle_axis_name",),
    "parallel.ring": ("ring_available", "ring_marginal_transport",
                      "ring_joint_transport"),
}


@pytest.mark.parametrize("name", sorted(SAME_SIGNATURE))
def test_parallel_exports_match_reference(name):
    import importlib

    port = importlib.import_module(f"dibs_tpu_torch.{name}")
    ref = importlib.import_module(f"dibs_tpu.{name}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    for fn in SAME_SIGNATURE[name]:
        _same_names(getattr(port, fn), getattr(ref, fn))
    for fn in port.__all__:
        assert hasattr(port, fn)


def test_ring_payload_knob_has_the_reference_names():
    from dibs_tpu import config as ref_config
    from dibs_tpu_torch import config as port_config

    for fn in ("set_ring_payload_dtype", "ring_payload_dtype"):
        _same_names(getattr(port_config, fn), getattr(ref_config, fn))
    import dibs_tpu
    import dibs_tpu.inference as ref_inference
    import dibs_tpu_torch
    import dibs_tpu_torch.inference as port_inference

    assert sorted(dibs_tpu_torch.__all__) == sorted(dibs_tpu.__all__)
    assert sorted(port_inference.__all__) == sorted(ref_inference.__all__)
