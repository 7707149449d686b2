"""BGe past d = 32, where #2 routes each pair by its parent count (the warp
route for k <= 31, the block route above), against dibs_tpu on the CPU.

On the CPU the port's determinant pairs come from the kernel's plain twin
(the padded bordered sweep) and the reference's from its non-Pallas path
(``masked_logdet_pd_pair``: two eliminations up to d = 64, one Cholesky of
the j-last matrix past it), as the JAX tests run it. Tolerance ``rtol =
atol = 1e-4``: float32 eliminations of up to 127 x 127 parent blocks in two
orders, their log-pivots summed in float64 in the port and in float32 in
the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dibs_tpu.models.linear_gaussian import BGe as JaxBGe
from dibs_tpu_torch.models.linear_gaussian import BGe

torch.set_num_threads(1)


def _case(d, b, density, seed, interventional=False):
    """Data ``[100, d]``, interventions and ``b`` graphs of the given edge
    density with a zero diagonal; graph 0 gives node j min(j, d - 1)
    parents (every route's k edge), from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(100, d)).astype(np.float32)
    interv = ((rng.uniform(size=x.shape) < 0.1) if interventional
              else np.zeros(x.shape, bool)).astype(np.int32)
    gs = (rng.uniform(size=(b, d, d)) < density).astype(np.float32)
    gs[0] = 0.0
    for j in range(d):
        others = np.delete(np.arange(d), j)
        gs[0, rng.choice(others, size=min(j, d - 1), replace=False), j] = 1.0
    gs *= 1.0 - np.eye(d, dtype=np.float32)
    return x, interv, gs


@pytest.mark.parametrize("d,b,density,interventional", [
    (64, 4, 0.5, False), (64, 4, 0.3, True), (128, 3, 0.5, False),
    (128, 2, 0.25, True)])
def test_block_tier_scores_match_reference(d, b, density, interventional):
    x, interv, gs = _case(d, b, density, seed=d + b, interventional=
                          interventional)
    ours = BGe(n_vars=d, device="cpu").batched_node_log_marginal_likelihoods(
        gs=torch.from_numpy(gs), x=torch.from_numpy(x),
        interv_targets=torch.from_numpy(interv))
    ref = JaxBGe(n_vars=d).batched_node_log_marginal_likelihoods(
        gs=jnp.asarray(gs), x=jnp.asarray(x),
        interv_targets=jnp.asarray(interv))
    assert ours.shape == (b, d) and torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
