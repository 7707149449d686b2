"""Port parity: edges, acyclicity, optimizers, tensor utilities and the
self-normalized ratio, each against its dibs_tpu counterpart on the CPU.

Inputs come from a numpy seed and go through both packages as numpy arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dibs_tpu.inference.estimators import stable_ratio_grad as jax_ratio
from dibs_tpu.inference.optimizers import rmsprop as jax_rmsprop
from dibs_tpu.ops import acyclic as jax_acyclic
from dibs_tpu.ops import edges as jax_edges
from dibs_tpu.utils import func as jax_func
from dibs_tpu_torch.inference.estimators import stable_ratio_grad
from dibs_tpu_torch.inference.optimizers import get_optimizer
from dibs_tpu_torch.ops import acyclic, edges
from dibs_tpu_torch.utils import func

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)


def _close(a, b, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol)


@pytest.fixture
def z_batch():
    return np.random.default_rng(0).normal(size=(3, 6, 5, 2)).astype(np.float32)


def test_edge_maps_match_reference(z_batch):
    alpha = 0.7
    _close(edges.edge_scores(_t(z_batch)), jax_edges.edge_scores(z_batch))
    _close(edges.edge_probs(_t(z_batch), alpha),
           jax_edges.edge_probs(z_batch, alpha))
    for a, b in zip(edges.edge_log_probs(_t(z_batch), alpha),
                    jax_edges.edge_log_probs(z_batch, alpha)):
        _close(a, b)
    g = edges.particle_to_g_lim(_t(z_batch))
    assert g.dtype == torch.int32
    np.testing.assert_array_equal(_np(g), jax_edges.particle_to_g_lim(z_batch))


def test_grad_latent_log_prob_batch_matches_reference(z_batch):
    rng = np.random.default_rng(1)
    d, alpha = z_batch.shape[1], 1.3
    gs = (rng.uniform(size=(3, 7, d, d)) < 0.4).astype(np.float32)
    gs *= 1.0 - np.eye(d, dtype=np.float32)
    ours = edges.grad_latent_log_prob_batch(_t(gs), _t(z_batch), alpha)
    assert ours.shape == (3, 7, d, 5, 2)
    for p in range(3):
        ref = jax_edges.grad_latent_log_prob_batch(gs[p], z_batch[p], alpha)
        _close(ours[p], ref)


@pytest.mark.parametrize("d", [5, 12, 160])
def test_acyclic_constr_value_and_backward(d):
    rng = np.random.default_rng(d)
    g = rng.uniform(size=(2, d, d)).astype(np.float32)
    g *= 1.0 - np.eye(d, dtype=np.float32)
    cot = rng.normal(size=(2,)).astype(np.float32)

    g_t = _t(g).requires_grad_(True)
    h = acyclic.acyclic_constr(g_t)
    (grad,) = torch.autograd.grad(h, g_t, _t(cot))

    h_ref, vjp = jax.vjp(
        jax.vmap(lambda x: jax_acyclic.acyclic_constr(x, d)), jnp.asarray(g))
    (grad_ref,) = vjp(jnp.asarray(cot))
    assert np.isfinite(_np(h)).all()
    np.testing.assert_allclose(_np(h), h_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(grad), grad_ref, rtol=1e-5, atol=1e-6)


def test_acyclic_constr_is_zero_on_dags():
    d = 9
    dag = np.tril(np.ones((d, d), np.float32), k=-1)
    perm = np.random.default_rng(2).permutation(d)
    dag = dag[perm][:, perm]
    h = acyclic.elwise_acyclic_constr(_t(dag)[None], d)
    assert float(h[0]) == 0.0
    cyc = dag + dag.T
    assert float(acyclic.elwise_acyclic_constr(_t(cyc)[None], d)[0]) > 0


def test_rmsprop_matches_reference_over_five_updates():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 6, 5, 2)).astype(np.float32)
    grads = [rng.normal(size=x.shape).astype(np.float32) * 10.0 ** (i - 2)
             for i in range(5)]
    opt = get_optimizer("rmsprop", {"stepsize": 0.005})
    ref_opt = jax_rmsprop(0.005)
    xs, st = _t(x), opt.init(_t(x))
    xr, str_ = jnp.asarray(x), ref_opt.init(jnp.asarray(x))
    for g in grads:
        upd, st = opt.update(_t(g), st)
        xs = xs + upd
        upd_r, str_ = ref_opt.update(jnp.asarray(g), str_, xr)
        xr = xr + upd_r
        _close(xs, xr, atol=1e-7)
        _close(st[0].nu, str_[0].nu, atol=1e-7, rtol=1e-6)


def test_gd_and_unknown_optimizer():
    opt = get_optimizer("gd", {"stepsize": 0.1})
    upd, st = opt.update(torch.ones(3), opt.init(torch.ones(3)))
    _close(upd, np.full(3, -0.1, np.float32), atol=0)
    with pytest.raises(ValueError):
        get_optimizer("adam", {})


def test_zero_diagonal_and_expand_by():
    a = np.random.default_rng(4).normal(size=(2, 3, 4, 4)).astype(np.float32)
    _close(func.zero_diagonal(_t(a)), jax_func.zero_diagonal(a), atol=0)
    assert func.expand_by(_t(a[0, 0]), 3).shape == (4, 4, 1, 1, 1)
    assert func.expand_by(_t(a), 0).shape == a.shape


def test_pytree_sq_norm_matrix_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5, 3, 4, 2)).astype(np.float32)
    y = rng.normal(size=(7, 3, 4, 2)).astype(np.float32)
    _close(func.pytree_sq_norm_matrix(_t(x), _t(y)),
           jax_func.pytree_sq_norm_matrix(x, y), atol=1e-4)
    xt = _t(x)
    self_sq = func.pytree_sq_norm_matrix(xt, xt)
    assert (torch.diagonal(self_sq) == 0).all()
    assert (self_sq >= 0).all()
    xj = jnp.asarray(x)
    _close(self_sq, jax_func.pytree_sq_norm_matrix(xj, xj), atol=1e-4)


def test_stable_ratio_grad_matches_reference():
    rng = np.random.default_rng(6)
    log_num = rng.normal(size=(3, 9)).astype(np.float32) * 30
    log_den = rng.normal(size=(3, 9)).astype(np.float32) * 30
    grads = rng.normal(size=(3, 9, 4, 2, 2)).astype(np.float32)
    ours = stable_ratio_grad(_t(log_num), _t(log_den), _t(grads))
    for p in range(3):
        ref = jax_ratio(log_num[p], log_den[p], grads[p])
        _close(ours[p], ref, atol=1e-5, rtol=1e-5)


def test_stable_ratio_grad_empty_numerator_is_zero():
    log_num = torch.full((2, 4), -float("inf"))
    grads = torch.ones((2, 4, 3))
    out = stable_ratio_grad(log_num, log_num, grads)
    assert torch.equal(out, torch.zeros((2, 3)))
