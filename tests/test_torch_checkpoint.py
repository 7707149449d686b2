"""Checkpoint / resume of the port's SVGD runs on the CPU: a run that is
saved, loaded and resumed equals the same run taken straight through,
exactly, for the marginal state and the joint state with a parameter array
and with an MLP parameter tree. The file is read with
``torch.load(weights_only=True)``.
"""
import numpy as np
import pytest
import torch

from dibs_tpu_torch.checkpoint import load_state, save_state
from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
from dibs_tpu_torch.inference.optimizers import ScaleByRmsState
from dibs_tpu_torch.models import BGe, ErdosReniDAGDistribution
from dibs_tpu_torch.target import (
    make_linear_gaussian_model,
    make_nonlinear_gaussian_model,
)
from dibs_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

D, P, K_LAT = 6, 3, 4


def _marginal():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(20, D, generator=gen)
    return MarginalDiBS(x=x, graph_model=ErdosReniDAGDistribution(D),
                        likelihood_model=BGe(n_vars=D, device="cpu"),
                        n_grad_mc_samples=8, n_acyclicity_mc_samples=4,
                        device="cpu")


def _joint(kind):
    factory = {"linear": make_linear_gaussian_model,
               "mlp": make_nonlinear_gaussian_model}[kind]
    kw = dict(hidden_layers=(3,)) if kind == "mlp" else {}
    data, gm, lm = factory(generator=torch.Generator().manual_seed(1),
                           n_vars=D, n_observations=12, device="cpu", **kw)
    return JointDiBS(x=data.x, graph_model=gm, likelihood_model=lm,
                     n_grad_mc_samples=8, n_acyclicity_mc_samples=4,
                     device="cpu")


def _assert_states_equal(a, b):
    assert a.t == b.t and a.seed == b.seed
    for field in ("z", "theta", "opt_state_z", "opt_state_theta",
                  "sf_baseline"):
        la = tree_leaves(getattr(a, field))
        lb = tree_leaves(getattr(b, field))
        assert len(la) == len(lb), field
        for x, y in zip(la, lb):
            if x is None:
                assert y is None
                continue
            assert torch.equal(x, y), field


@pytest.mark.parametrize("kind", ["marginal", "linear", "mlp"])
def test_resume_from_a_checkpoint_equals_a_straight_run(tmp_path, kind):
    dibs = _marginal() if kind == "marginal" else _joint(kind)
    init = dibs.init_state(seed=3, n_particles=P, n_dim_particles=K_LAT)
    straight = dibs.resume(init, steps=8, return_state=True)[-1]

    half = dibs.resume(init, steps=4, return_state=True)[-1]
    path = save_state(half, str(tmp_path / "run"))
    assert path.endswith(".dibs-ckpt.pt")
    loaded = load_state(str(tmp_path / "run"), device="cpu")
    _assert_states_equal(loaded, half)
    assert isinstance(loaded.opt_state_z[0], ScaleByRmsState)
    assert type(loaded.theta) is type(half.theta)
    resumed = dibs.resume(loaded, steps=4, return_state=True)[-1]
    assert resumed.t == 8
    _assert_states_equal(resumed, straight)


def test_checkpoint_loads_without_unpickling(tmp_path):
    dibs = _joint("mlp")
    state = dibs.init_state(seed=1, n_particles=P, n_dim_particles=K_LAT)
    path = save_state(state, str(tmp_path / "s.dibs-ckpt.pt"))
    # the payload is plain tensors, scalars and containers
    payload = torch.load(path, weights_only=True)
    assert payload["t"] == 0 and isinstance(payload["theta"], list)
    # a file of another format is refused
    torch.save({"format": "other"}, str(tmp_path / "x.dibs-ckpt.pt"))
    with pytest.raises(ValueError, match="not a"):
        load_state(str(tmp_path / "x"), device="cpu")


def test_load_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is available")
    state = _marginal().init_state(seed=0, n_particles=P,
                                   n_dim_particles=K_LAT)
    save_state(state, str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_state(str(tmp_path / "m"))
    assert np.isfinite(load_state(str(tmp_path / "m"),
                                  device="cpu").z.numpy()).all()
