"""The port's precision policy and kernel kill switch
(``dibs_tpu_torch/config.py``) against the JAX package's, on the CPU.

* The setters accept and refuse the same names as the reference's.
* Each family applies its precision only around its own matmuls and gives
  the caller's global setting back.
* Every kernel dispatch point asks the one predicate
  ``gpu_kernels.use_kernel`` (recorded by patching it, then driving the
  engines on the CPU), and ``DIBS_DISABLE_PALLAS`` turns it off.
"""
import sys
import types

import numpy as np
import pytest
import torch

import dibs_tpu.config as jax_config
from dibs_tpu_torch import config
from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
from dibs_tpu_torch.inference import fused_linear, fused_nonlinear
from dibs_tpu_torch.inference.transport import marginal_transport
from dibs_tpu_torch.kernel import AdditiveFrobeniusSEKernel
from dibs_tpu_torch.models import (
    BGe,
    DenseNonlinearGaussian,
    LinearGaussian,
    ScaleFreeDAGDistribution,
)
from dibs_tpu_torch.ops import acyclic, acyclic_kernel, bge_kernel
from dibs_tpu_torch.ops import gpu_kernels, transport_kernel

torch.set_num_threads(1)

SETTERS = ["likelihood", "transport"]
# the modules that hold a dispatch point, and the nine points
DISPATCH_MODULES = [gpu_kernels, bge_kernel, transport_kernel, fused_linear,
                    fused_nonlinear]
DISPATCH_POINTS = {"gumbel_graphs", "se_matrix", "acyclic_grad",
                   "bge_logdet_pairs", "transport_phi", "fused_linear_single",
                   "fused_linear_pass1", "fused_linear_pass2",
                   "fused_nonlinear", "score_ratio"}
D, N = 5, 12


@pytest.fixture(autouse=True)
def _restore():
    yield
    for mod in (config, jax_config):
        mod.set_likelihood_matmul_precision("highest")
        mod.set_pallas_enabled(None)
    jax_config.set_transport_matmul_precision("high")
    config.set_transport_matmul_precision("highest")
    torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("family", SETTERS)
def test_setters_accept_and_refuse_what_the_reference_does(family):
    port_set = getattr(config, f"set_{family}_matmul_precision")
    port_get = getattr(config, f"{family}_matmul_precision")
    ref_set = getattr(jax_config, f"set_{family}_matmul_precision")
    for name in ("default", "high", "highest"):
        ref_set(name)
        port_set(name)
        assert port_get() == name
    for name in ("medium", "HIGH", "fast", ""):
        with pytest.raises(KeyError):
            ref_set(name)
        with pytest.raises(ValueError):
            port_set(name)


def test_both_defaults_are_highest():
    """IEEE float32 for both families: the reference's transport default
    is 'high', bf16x3 on a TPU, and TF32 on the card is coarser."""
    assert config.likelihood_matmul_precision() == "highest"
    assert config.transport_matmul_precision() == "highest"
    assert jax_config.transport_matmul_precision() == \
        jax_config._PRECISIONS["high"]


def _recording(monkeypatch):
    seen = []
    original = torch.set_float32_matmul_precision

    def record(p):
        seen.append(p)
        original(p)

    monkeypatch.setattr(torch, "set_float32_matmul_precision", record)
    return seen


def _linear_call():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    g = torch.ones(3, D, D)
    theta = torch.from_numpy(rng.normal(size=(3, D, D)).astype(np.float32))
    LinearGaussian(n_vars=D).interventional_log_joint_prob(
        g, theta, x, torch.zeros_like(x), None)


def _nonlinear_call():
    model = DenseNonlinearGaussian(n_vars=D, hidden_layers=(3,))
    gen = torch.Generator().manual_seed(1)
    theta = model.sample_parameters(generator=gen, n_vars=D, device="cpu")
    x = torch.randn(N, D, generator=gen)
    model.interventional_log_joint_prob(torch.ones(D, D), theta, x,
                                        torch.zeros_like(x), None)


def _transport_call(h):
    gen = torch.Generator().manual_seed(2)
    z = torch.randn(4, D, 3, 2, generator=gen)
    marginal_transport(AdditiveFrobeniusSEKernel(h=h), z, torch.randn(
        z.shape, generator=gen))


@pytest.mark.parametrize("family, call", [
    ("likelihood", _linear_call), ("likelihood", _nonlinear_call),
    ("transport", lambda: _transport_call("median")),
    ("transport", lambda: _transport_call(5.0)),
    ("acyclicity", None)])
def test_each_family_sets_and_restores_the_global_precision(monkeypatch,
                                                            family, call):
    if family == "acyclicity":
        def call():
            g = torch.rand(3, D, D).requires_grad_(True)
            acyclic.acyclic_constr(g, precision="default").sum().backward()
            acyclic.acyclic_constr_spectral(g, precision="high")
    else:
        getattr(config, f"set_{family}_matmul_precision")("default")
    seen = _recording(monkeypatch)
    call()
    assert seen and seen[0] == "high"  # TF32 inside the family's matmuls
    assert seen[-1] == "highest"
    assert torch.get_float32_matmul_precision() == "highest"
    # the caller's own setting comes back too
    seen.clear()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        call()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_the_engine_refuses_a_global_tf32_setting():
    x = torch.randn(N, D)
    dibs = JointDiBS(x=x, graph_model=ScaleFreeDAGDistribution(D),
                     likelihood_model=LinearGaussian(n_vars=D),
                     n_grad_mc_samples=4, n_acyclicity_mc_samples=2,
                     device="cpu")
    config.set_likelihood_matmul_precision("high")
    dibs.sample(seed=0, n_particles=2, steps=1)  # the knob alone is fine
    torch.set_float32_matmul_precision("high")
    with pytest.raises(RuntimeError, match="TF32"):
        dibs.sample(seed=0, n_particles=2, steps=1)


def _drive_every_entry():
    """One step of each engine route on the CPU, and kernel #9's entry."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(N, D, generator=gen)
    kw = dict(n_grad_mc_samples=4, n_acyclicity_mc_samples=2, device="cpu")
    MarginalDiBS(x=x, graph_model=ScaleFreeDAGDistribution(D),
                 likelihood_model=BGe(n_vars=D, device="cpu"), **kw
                 ).sample(seed=0, n_particles=3, steps=1)
    for single in (True, False):
        JointDiBS(x=x, graph_model=ScaleFreeDAGDistribution(D),
                  likelihood_model=LinearGaussian(n_vars=D),
                  fused_single_pass=single, **kw
                  ).sample(seed=0, n_particles=3, steps=1)
    JointDiBS(x=x, graph_model=ScaleFreeDAGDistribution(D),
              likelihood_model=DenseNonlinearGaussian(
                  n_vars=D, hidden_layers=(3,)), **kw
              ).sample(seed=0, n_particles=3, steps=1)
    acyclic_kernel.fused_acyclic_grad(torch.randn(2, D, D, generator=gen), 7,
                                      0.5, n_vars=D, kmc=2)


def test_every_dispatch_point_asks_the_one_predicate(monkeypatch):
    asked = []
    predicate = gpu_kernels.use_kernel

    def record(t):
        asked.append(sys._getframe(1).f_code.co_name)
        return predicate(t)

    for mod in DISPATCH_MODULES:
        assert mod.use_kernel is predicate
        monkeypatch.setattr(mod, "use_kernel", record)
    _drive_every_entry()
    assert set(asked) == DISPATCH_POINTS


def test_the_kill_switch_reads_the_reference_names(monkeypatch):
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    cpu = torch.zeros(1)
    monkeypatch.delenv("DIBS_DISABLE_PALLAS", raising=False)
    assert config.pallas_override() is None
    assert gpu_kernels.use_kernel(card) and not gpu_kernels.use_kernel(cpu)
    config.set_pallas_enabled(False)
    assert config.pallas_override() is False
    assert not gpu_kernels.use_kernel(card)
    config.set_pallas_enabled(None)
    assert gpu_kernels.use_kernel(card)
    for value, off in (("1", True), ("yes", True), ("0", False), ("", False)):
        monkeypatch.setenv("DIBS_DISABLE_PALLAS", value)
        assert (config.pallas_override() is False) == off
        assert (jax_config.pallas_override() is False) == off
        assert gpu_kernels.use_kernel(card) == (not off)
    monkeypatch.setenv("DIBS_DISABLE_PALLAS", "1")
    config.set_pallas_enabled(True)  # the environment wins, as there
    jax_config.set_pallas_enabled(True)
    assert config.pallas_override() is jax_config.pallas_override() is False
