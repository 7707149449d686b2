"""Port parity for the fused SVGD transport (kernel #4's plain version and the
transports that dispatch to it) against dibs_tpu on the CPU.

The JAX package's ``transport_phi`` has no interpret switch, so the
reference is its XLA path: ``dibs_tpu.inference.transport.marginal_transport``
/ ``joint_transport`` at ``jax_default_matmul_precision="highest"``
(``tests/conftest.py``). The same numpy inputs go through
``transport_phi_plain`` (fed the port's own kernel matrices) and through the
port's ``marginal_transport`` / ``joint_transport``, which on the CPU send
every family with a float factor to ``transport_phi_plain``. Tolerance:
``|diff| <= 1e-4 max|phi|`` per component.

Shapes: P=8, n=256 (the TPU kernel's shape class), P=7, n=130 (a shape the
TPU gate refused and the port serves) and a clustered case (particles within
1e-3 of each other) that exercises the centring.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dibs_tpu.inference.transport import joint_transport as jax_joint
from dibs_tpu.inference.transport import marginal_transport as jax_marginal
from dibs_tpu.kernel import AdditiveFrobeniusSEKernel as JaxKernel
from dibs_tpu.kernel import JointAdditiveFrobeniusSEKernel as JaxJointKernel
from dibs_tpu_torch.inference import transport
from dibs_tpu_torch.kernel import (
    AdditiveFrobeniusSEKernel,
    JointAdditiveFrobeniusSEKernel,
)
from dibs_tpu_torch.ops.transport_kernel import (
    transport_phi,
    transport_phi_aligned,
    transport_phi_available,
    transport_phi_plain,
)
from dibs_tpu_torch.utils.tree import tree_leaves, tree_rows

torch.set_num_threads(1)

# (P, d, k): Z is [P, d, k, 2], so n = 2 d k
SHAPES = {"p8_n256": (8, 8, 16), "p7_n130": (7, 5, 13),
          "clustered": (8, 8, 16)}
H1 = 5  # hidden units of the MLP tree


def _particles(rng, shape, clustered, scale):
    if clustered:
        base = rng.normal(size=shape[1:]) * scale
        return (base + 1e-3 * rng.normal(size=shape)).astype(np.float32)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _inputs(case, theta_kind):
    p, d, k = SHAPES[case]
    clustered = case == "clustered"
    rng = np.random.default_rng(sum(map(ord, case + theta_kind)))
    z = _particles(rng, (p, d, k, 2), clustered, 0.3)
    # clustered: scores as small as the spread, so the repulsion, whose
    # rounding the centring keeps relative to the differences, is visible
    dz = (rng.normal(size=z.shape) * (1e-3 if clustered else 1.0)).astype(
        np.float32)
    if theta_kind == "array":
        shapes = [(p, d, d)]
    else:  # the MLP tree [(W1, b1), (W2, b2)]
        shapes = [(p, d, d, H1), (p, d, H1), (p, d, H1, 1), (p, d, 1)]
    theta = [_particles(rng, s, clustered, 1.0) for s in shapes]
    dtheta = [(rng.normal(size=s) * (1e-3 if clustered else 1.0)).astype(
        np.float32) for s in shapes]
    return z, dz, theta, dtheta


def _tree(leaves, lib):
    """``leaves`` as the parameter tree of the array or the MLP model."""
    if len(leaves) == 1:
        return lib(leaves[0])
    w1, b1, w2, b2 = (lib(a) for a in leaves)
    return [(w1, b1), (w2, b2)]


def _assert_close(got, want):
    want = np.asarray(want)
    tol = 1e-4 * np.abs(want).max()
    assert np.abs(np.asarray(got) - want).max() <= tol


def _flat(a):
    return a.reshape(a.shape[0], -1)


@pytest.mark.parametrize("case", list(SHAPES))
def test_marginal_transport_matches_reference(case):
    z, dz, _, _ = _inputs(case, "array")
    want = jax_marginal(JaxKernel(h=5.0), jnp.asarray(z), jnp.asarray(dz))
    ours_k = AdditiveFrobeniusSEKernel(h=5.0)
    z_t, dz_t = torch.from_numpy(z), torch.from_numpy(dz)
    _assert_close(transport.marginal_transport(ours_k, z_t, dz_t), want)
    # the plain version of kernel #4 itself, fed the port's kernel matrix
    k_mat, c = ours_k.matrix_and_grad_factor(z_t, z_t)
    vf = _flat(z_t)
    phi = transport_phi_plain(k_mat, None, _flat(dz_t), vf, c=c,
                              mu=vf.mean(dim=0, keepdim=True))
    _assert_close(phi.reshape(z.shape), want)


@pytest.mark.parametrize("theta_kind", ["array", "mlp_tree"])
@pytest.mark.parametrize("case", list(SHAPES))
def test_joint_transport_matches_reference(case, theta_kind):
    z, dz, theta, dtheta = _inputs(case, theta_kind)
    ref_k = JaxJointKernel(h_latent=5.0, h_theta=500.0)
    want_z, want_t = jax_joint(ref_k, jnp.asarray(z), _tree(theta, jnp.asarray),
                               jnp.asarray(dz), _tree(dtheta, jnp.asarray))
    want_t = [np.asarray(a) for a in jax.tree_util.tree_leaves(want_t)]
    ours_k = JointAdditiveFrobeniusSEKernel(h_latent=5.0, h_theta=500.0)
    z_t, dz_t = torch.from_numpy(z), torch.from_numpy(dz)
    th_t = _tree(theta, torch.from_numpy)
    dth_t = _tree(dtheta, torch.from_numpy)
    phi_z, phi_t = transport.joint_transport(ours_k, z_t, th_t, dz_t, dth_t)
    _assert_close(phi_z, want_z)
    assert len(tree_leaves(phi_t)) == len(want_t)
    for got, want in zip(tree_leaves(phi_t), want_t):
        assert tuple(got.shape) == want.shape
        _assert_close(got, want)
    # the plain version of kernel #4 on both families, the Theta tree
    # flattened into one [P, n] block
    k_z, k_t, c_z, c_t = ours_k.component_matrices_and_factors(
        z_t, th_t, z_t, th_t)
    vz, vt = _flat(z_t), tree_rows(th_t)
    pz = transport_phi_plain(k_z, k_t, _flat(dz_t), vz, c=c_z,
                             mu=vz.mean(dim=0, keepdim=True))
    pt = transport_phi_plain(k_t, k_z, tree_rows(dth_t), vt, c=c_t,
                             mu=vt.mean(dim=0, keepdim=True))
    _assert_close(pz.reshape(z.shape), want_z)
    offset = 0
    for want in want_t:
        size = int(np.prod(want.shape[1:]))
        _assert_close(pt[:, offset:offset + size].reshape(want.shape), want)
        offset += size


@pytest.mark.parametrize("joint", [False, True])
def test_centring_keeps_clustered_far_particles_accurate(joint):
    """Particles 1e-3 apart at a common offset of 10: the float32 transport
    (kernel #4's plain version, centred) against the same maths in float64.
    The reference's Gram-form kernel matrix cancels at this offset, so the
    float64 evaluation is the yardstick here; without the centring the
    float32 repulsion misses the bar."""
    rng = np.random.default_rng(5)
    p, d, k = SHAPES["p8_n256"]
    z = 10.0 + rng.normal(size=(d, k, 2)) + 1e-3 * rng.normal(
        size=(p, d, k, 2))
    dz = 1e-3 * rng.normal(size=z.shape)
    theta = 10.0 + rng.normal(size=(d, d)) + 1e-3 * rng.normal(size=(p, d, d))
    dtheta = 1e-3 * rng.normal(size=theta.shape)
    outs = {}
    for dtype in (torch.float32, torch.float64):
        # the same float32 inputs in both evaluations
        z_t, dz_t, th_t, dth_t = (torch.from_numpy(a).float().to(dtype)
                                  for a in (z, dz, theta, dtheta))
        if joint:
            outs[dtype] = transport.joint_transport(
                JointAdditiveFrobeniusSEKernel(h_latent=5.0, h_theta=5.0),
                z_t, th_t, dz_t, dth_t)
        else:
            outs[dtype] = (transport.marginal_transport(
                AdditiveFrobeniusSEKernel(h=5.0), z_t, dz_t),)
    for got, want in zip(outs[torch.float32], outs[torch.float64]):
        _assert_close(got.double(), want)


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("h", [5.0, "median"])
def test_dispatch_sends_float_factors_to_the_kernel(monkeypatch, h, joint):
    """A float factor sends every family to ``transport_phi`` (1 call
    marginal, 2 joint); ``h="median"`` takes the two-matmul route, and both
    match the reference."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[3].shape)
        return transport_phi(*args, **kwargs)

    monkeypatch.setattr(transport, "transport_phi", counted)
    z, dz, theta, dtheta = _inputs("p7_n130", "array")
    z_t, dz_t = torch.from_numpy(z), torch.from_numpy(dz)
    if joint:
        kw = dict(h_latent=h, h_theta=h if h == "median" else 500.0)
        got = transport.joint_transport(
            JointAdditiveFrobeniusSEKernel(**kw), z_t,
            torch.from_numpy(theta[0]), dz_t, torch.from_numpy(dtheta[0]))
        want = jax_joint(JaxJointKernel(**kw), jnp.asarray(z),
                         jnp.asarray(theta[0]), jnp.asarray(dz),
                         jnp.asarray(dtheta[0]))
    else:
        got = (transport.marginal_transport(AdditiveFrobeniusSEKernel(h=h),
                                            z_t, dz_t),)
        want = (jax_marginal(JaxKernel(h=h), jnp.asarray(z),
                             jnp.asarray(dz)),)
    for a, b in zip(got, want):
        _assert_close(a, b)
    if h == "median":
        assert calls == []
    else:
        assert len(calls) == (2 if joint else 1)
        assert calls[0] == (7, 130)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_splits_trees():
    rng = np.random.default_rng(3)
    k_own = torch.rand(5, 5)
    k_other = torch.rand(5, 5)
    g, v = (torch.from_numpy(rng.normal(size=(5, 9)).astype(np.float32))
            for _ in range(2))
    mu = v.mean(dim=0, keepdim=True)
    for other in (None, k_other):
        assert torch.equal(transport_phi(k_own, other, g, v, c=-0.4, mu=mu),
                           transport_phi_plain(k_own, other, g, v, c=-0.4,
                                               mu=mu))
    assert transport_phi_available(7, 130) and transport_phi_available(1001, 1)
    assert not transport_phi_available(0, 4)
    # a tree family comes back in the leaves' shapes and nesting
    tree = [(torch.randn(5, 2, 3), torch.randn(5, 2)), (torch.randn(5, 4),)]
    out = transport._fused_phi_or_none(k_own, k_other, -0.4, tree, tree)
    assert [tuple(a.shape) for a in tree_leaves(out)] == [
        (5, 2, 3), (5, 2), (5, 4)]
    assert isinstance(out, list) and isinstance(out[1], tuple)
    flat = transport_phi_plain(k_own, k_other, tree_rows(tree),
                               tree_rows(tree), c=-0.4,
                               mu=tree_rows(tree).mean(dim=0, keepdim=True))
    assert torch.equal(tree_rows(out), flat)
    assert transport._fused_phi_or_none(
        k_own, None, torch.tensor(-0.4), tree, tree) is None


def test_aligned_instantiation_is_chosen_from_shapes_and_pointers():
    """The aligned (16-byte load) instantiation takes config 5's families;
    P or n not a multiple of 4, or an operand off 16 bytes, take the
    scalar one."""
    def ops(p, n, offset=0):
        flat = torch.zeros(p * n + offset)
        return torch.zeros(p, p), flat[offset:].view(p, n), torch.zeros(p, n)

    assert transport_phi_aligned(1000, 32768, *ops(1000, 32768))
    assert transport_phi_aligned(1000, 16384, *ops(1000, 16384))
    assert not transport_phi_aligned(30, 800, *ops(30, 800))  # d=20, P=30
    assert not transport_phi_aligned(7, 130, *ops(7, 130))
    assert not transport_phi_aligned(8, 130, *ops(8, 130))
    assert not transport_phi_aligned(8, 256, *ops(8, 256, offset=1))
    assert transport_phi_aligned(8, 256, *ops(8, 256, offset=4))
