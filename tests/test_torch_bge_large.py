"""BGe past the determinant kernel's range (d > 128), against dibs_tpu on
the CPU.

There the reference computes the determinant pairs with
``masked_logdet_pd_pair`` over every (graph, node), in graph chunks of at
most ``_BGE_CHUNK_ELEMS`` masked floats past d = 64
(``dibs_tpu/models/linear_gaussian.py:209-246``); the port does the same.
Tolerance ``rtol = atol = 1e-4``: float32 Cholesky factors of ~40 x 40
parent blocks, summed as logs in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dibs_tpu.models.linear_gaussian import BGe as JaxBGe
from dibs_tpu_torch.inference import MarginalDiBS
from dibs_tpu_torch.models import linear_gaussian
from dibs_tpu_torch.models.linear_gaussian import BGe
from dibs_tpu_torch.target import make_linear_gaussian_equivalent_model

torch.set_num_threads(1)

D = 130


def _case(d, n, b, interventional, seed):
    """Data ``[n, d]``, interventions ``[n, d]`` and ``b`` graphs of edge
    density 0.3 with a zero diagonal, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    interv = ((rng.uniform(size=x.shape) < 0.1) if interventional
              else np.zeros(x.shape, bool)).astype(np.int32)
    gs = (rng.uniform(size=(b, d, d)) < 0.3).astype(np.float32)
    gs *= 1.0 - np.eye(d, dtype=np.float32)
    return x, interv, gs


@pytest.mark.parametrize("interventional", [False, True])
def test_scores_past_the_kernel_range_match_reference(interventional):
    x, interv, gs = _case(D, 60, 20, interventional, seed=11)
    ours = BGe(n_vars=D, device="cpu").batched_node_log_marginal_likelihoods(
        gs=torch.from_numpy(gs), x=torch.from_numpy(x),
        interv_targets=torch.from_numpy(interv))
    ref = JaxBGe(n_vars=D).batched_node_log_marginal_likelihoods(
        gs=jnp.asarray(gs), x=jnp.asarray(x),
        interv_targets=jnp.asarray(interv))
    assert ours.shape == (20, D) and torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_graph_chunks_give_the_numbers_of_one_chunk(monkeypatch):
    x, interv, gs = _case(D, 60, 20, False, seed=12)
    model = BGe(n_vars=D, device="cpu")
    args = dict(gs=torch.from_numpy(gs), x=torch.from_numpy(x),
                interv_targets=torch.from_numpy(interv))
    whole = model.batched_node_log_marginal_likelihoods(**args)
    assert linear_gaussian._BGE_CHUNK_ELEMS // D ** 3 >= 20  # one chunk
    # 3 graphs a chunk: 7 chunks, the last of 2 graphs
    monkeypatch.setattr(linear_gaussian, "_BGE_CHUNK_ELEMS", 3 * D ** 3)
    chunked = model.batched_node_log_marginal_likelihoods(**args)
    assert torch.equal(chunked, whole)


def test_one_graph_variable_scores_as_the_reference():
    """d = 1, below the kernel's range: a node without parents."""
    x, interv, gs = _case(1, 30, 3, False, seed=13)
    ours = BGe(n_vars=1, device="cpu").batched_node_log_marginal_likelihoods(
        gs=torch.from_numpy(gs), x=torch.from_numpy(x),
        interv_targets=torch.from_numpy(interv))
    ref = JaxBGe(n_vars=1).batched_node_log_marginal_likelihoods(
        gs=jnp.asarray(gs), x=jnp.asarray(x),
        interv_targets=jnp.asarray(interv))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_marginal_dibs_takes_a_finite_step_at_d130():
    data, gm, lm = make_linear_gaussian_equivalent_model(
        generator=torch.Generator().manual_seed(0), n_vars=D,
        graph_prior_str="er", n_observations=40, n_ho_observations=10,
        device="cpu")
    dibs = MarginalDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                        n_grad_mc_samples=2, n_acyclicity_mc_samples=2,
                        device="cpu")
    init = dibs.init_state(seed=1, n_particles=2)
    g, state = dibs.resume(init, steps=1, return_state=True)
    assert state.t == 1 and g.shape == (2, D, D)
    assert torch.isfinite(state.z).all()
    assert torch.isfinite(state.sf_baseline).all()
    assert float((state.z - init.z).abs().max()) > 0.0
