"""``dibs_tpu_torch.warmup``: one step of each model at the shape, a line
per model on stderr, and no trace: the global RNG, the launch counts and
every later run are as without it (bitwise). On the CPU, and (marked
``cuda``, skipped where ``torch.cuda.is_available()`` is false) on the
card::

    python -m pytest tests/test_torch_warmup.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
from dibs_tpu_torch.models import (
    BGe,
    DenseNonlinearGaussian,
    ErdosReniDAGDistribution,
    LinearGaussian,
)
from dibs_tpu_torch.ops import gpu_kernels
from dibs_tpu_torch.utils.tree import tree_leaves
from dibs_tpu_torch.warmup import MODELS, warmup

torch.set_num_threads(1)

D, N, P, M = 6, 10, 4, 8


def runs(dev="cpu"):
    """A short ``sample()`` of each model in a fresh engine on seeded
    data at the warmed shape: the output tensors in a flat list."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(N, D))
                         .astype(np.float32)).to(dev)
    kw = dict(x=x, graph_model=ErdosReniDAGDistribution(D),
              n_grad_mc_samples=M, n_acyclicity_mc_samples=4, device=dev)
    out = []
    for lik in (LinearGaussian(n_vars=D),
                DenseNonlinearGaussian(n_vars=D, hidden_layers=(5,))):
        g, theta = JointDiBS(likelihood_model=lik, **kw).sample(
            seed=1, n_particles=P, steps=3)
        out += [g, *tree_leaves(theta)]
    out.append(MarginalDiBS(likelihood_model=BGe(n_vars=D, device=dev),
                            **kw).sample(seed=1, n_particles=P, steps=3))
    return out


def test_warmup_runs_each_model_and_leaves_no_trace(capsys):
    before = runs()
    gpu_kernels.LAUNCHES["gumbel_graphs"] += 7  # a count it must keep
    launches = dict(gpu_kernels.LAUNCHES)
    rng = torch.get_rng_state()
    try:
        warmup([D], device="cpu", n_obs=N, n_particles=P,
               n_grad_mc_samples=M)
    finally:
        gpu_kernels.LAUNCHES["gumbel_graphs"] -= 7
    assert dict(gpu_kernels.LAUNCHES) == {
        **launches, "gumbel_graphs": launches["gumbel_graphs"] - 7}
    assert torch.equal(torch.get_rng_state(), rng)
    err = capsys.readouterr().err.splitlines()
    for model in MODELS:
        lines = [ln for ln in err if f"{model} d={D}" in ln]
        assert len(lines) == 1 and "first step" in lines[0], err
    assert not any("building" in ln for ln in err)  # nothing built on the CPU
    after = runs()
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_warmup_is_quiet_and_takes_a_list():
    warmup([4, 5], device="cpu", n_obs=N, n_particles=2,
           n_grad_mc_samples=2, models=("marginal_bge",), verbose=False)


@pytest.mark.cuda
def test_warmup_on_the_card_leaves_no_trace(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    before = runs(dev)
    launches = dict(gpu_kernels.LAUNCHES)
    rng, rng_cuda = torch.get_rng_state(), torch.cuda.get_rng_state(dev)
    warmup([D], device=dev, n_obs=N, n_particles=P, n_grad_mc_samples=M)
    assert dict(gpu_kernels.LAUNCHES) == launches
    assert torch.equal(torch.get_rng_state(), rng)
    assert torch.equal(torch.cuda.get_rng_state(dev), rng_cuda)
    err = capsys.readouterr().err
    assert "kernels built and loaded" in err
    assert sum(f"{m} d={D}" in err for m in MODELS) == len(MODELS)
    after = runs(dev)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
