"""The reference's own calls of four public functions run in the port and
agree with dibs_tpu on the same numpy inputs (CPU):

- ``acyclic_constr(g, n_vars)``, which checks ``n_vars`` against ``g``;
- ``grad_latent_log_prob_batch(gs, single_z=..., alpha=...)``;
- ``sample_obs(..., toporder=None)`` of both joint models (zero observation
  noise, so both samplers are deterministic and comparable);
- ``sample_G(..., return_mat=True)`` of the three graph priors.

Tolerances: 1e-5 relative to ``max(1, max|ref|)`` for float32 results
computed in another order; graphs exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu.models import DenseNonlinearGaussian as JaxMLP
from dibs_tpu.models import ErdosReniDAGDistribution as JaxER
from dibs_tpu.models import LinearGaussian as JaxLinear
from dibs_tpu.models import ScaleFreeDAGDistribution as JaxSF
from dibs_tpu.models.graph import UniformDAGDistributionRejection as JaxUniform
from dibs_tpu.ops import acyclic as jax_acyclic
from dibs_tpu.ops import edges as jax_edges
from dibs_tpu_torch.interop import (
    nonlinear_gaussian_from_reference,
    params_from_reference,
)
from dibs_tpu_torch.models import (
    BGe,
    ErdosReniDAGDistribution,
    LinearGaussian,
    ScaleFreeDAGDistribution,
)
from dibs_tpu_torch.models.graph import UniformDAGDistributionRejection
from dibs_tpu_torch.ops import acyclic, edges

torch.set_num_threads(1)

D = 6


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * max(
        1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("d", [3, 6])
def test_acyclic_constr_takes_n_vars(d):
    rng = np.random.default_rng(d)
    g = rng.uniform(size=(d, d)).astype(np.float32)
    got = acyclic.acyclic_constr(torch.from_numpy(g), d)
    _close(got, jax_acyclic.acyclic_constr(jnp.asarray(g), d))
    with pytest.raises(ValueError, match=f"expected d = {d + 1}"):
        acyclic.acyclic_constr(torch.from_numpy(g), d + 1)


def test_grad_latent_log_prob_batch_names_single_z():
    rng = np.random.default_rng(1)
    gs = (rng.uniform(size=(5, D, D)) < 0.4).astype(np.float32)
    z = rng.normal(size=(D, 4, 2)).astype(np.float32)
    got = edges.grad_latent_log_prob_batch(
        torch.from_numpy(gs), single_z=torch.from_numpy(z), alpha=0.7)
    want = jax_edges.grad_latent_log_prob_batch(
        jnp.asarray(gs), single_z=jnp.asarray(z), alpha=0.7)
    _close(got, want)


def _dag():
    g = np.triu(np.ones((D, D), np.int32), 1)
    g[:, 2] = 0  # node 2 has no parents
    return g


def test_linear_sample_obs_accepts_toporder():
    rng = np.random.default_rng(2)
    theta = rng.normal(size=(D, D)).astype(np.float32)
    g = _dag()
    ref = JaxLinear(n_vars=D, obs_noise=0.0)
    ours = LinearGaussian(n_vars=D, obs_noise=0.0)
    got = ours.sample_obs(generator=torch.Generator().manual_seed(0),
                          n_samples=4, g=torch.from_numpy(g),
                          theta=torch.from_numpy(theta), toporder=None,
                          interv={1: 2.5})
    want = ref.sample_obs(key=random.PRNGKey(0), n_samples=4,
                          g=jnp.asarray(g), theta=jnp.asarray(theta),
                          toporder=None, interv={1: 2.5})
    _close(got, want)
    assert torch.all(got[:, 1] == 2.5)
    with pytest.raises(NotImplementedError):
        BGe(n_vars=D, device="cpu").sample_obs(
            generator=torch.Generator(), n_samples=4, g=torch.from_numpy(g),
            theta=None, toporder=None)


def test_nonlinear_sample_obs_accepts_toporder():
    kw = dict(n_vars=D, hidden_layers=(5,), obs_noise=0.0, sig_param=1.3)
    ref, ours = JaxMLP(**kw), nonlinear_gaussian_from_reference(**kw)
    theta = ref.sample_parameters(key=random.PRNGKey(3), n_vars=D)
    th = params_from_reference(jax.tree_util.tree_map(np.asarray, theta),
                               device="cpu")
    g = _dag()
    got = ours.sample_obs(generator=torch.Generator().manual_seed(0),
                          n_samples=4, g=torch.from_numpy(g), theta=th,
                          toporder=None, interv={1: 2.5})
    want = ref.sample_obs(key=random.PRNGKey(0), n_samples=4,
                          g=jnp.asarray(g), theta=theta, toporder=None,
                          interv={1: 2.5})
    _close(got, want)


@pytest.mark.parametrize("ours,ref", [
    (ErdosReniDAGDistribution(D, 1), JaxER(D, 1)),
    (ScaleFreeDAGDistribution(D), JaxSF(D)),
    (UniformDAGDistributionRejection(4), JaxUniform(4)),
])
def test_sample_g_accepts_return_mat(ours, ref):
    """The reference's call gives what the plain call gives, a matrix like
    the reference's: int32 ``[d, d]``, 0/1, a DAG by the reference's own
    acyclicity measure."""
    got = ours.sample_G(torch.Generator().manual_seed(5), return_mat=True,
                        device="cpu")
    plain = ours.sample_G(torch.Generator().manual_seed(5), device="cpu")
    want = ref.sample_G(random.PRNGKey(5), return_mat=True)
    assert torch.equal(got, plain)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert str(np.asarray(want).dtype) == "int32"
    assert set(np.unique(got.numpy())) <= {0, 1}
    d = ours.n_vars
    h = jax_acyclic.acyclic_constr(jnp.asarray(got.numpy(), jnp.float32), d)
    assert float(h) == 0.0
