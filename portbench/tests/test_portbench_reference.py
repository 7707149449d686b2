"""The plain reference against the port's CPU path at a tiny size, its
noise against the port's, and the data generator."""
import numpy as np
import pytest
import torch

from dibs_tpu_torch.ops.gpu_kernels import philox_uniform
from portbench import compare, datagen, harness, spec
from portbench.reference import common, philox
from portbench.tests.conftest import CELLS, tiny


@pytest.mark.parametrize("seed", [0, 77, 2 ** 31 + 11, 2 ** 40 + 3])
def test_noise_is_the_kernels(seed):
    ours = philox.uniform(3, 5, 7, seed, 2 ** 31 + 9, "cpu", first_particle=4)
    port = philox_uniform((7, 5, 7, 7), seed, 2 ** 31 + 9, "cpu")[4:]
    assert torch.equal(ours, port)


def test_tf32_rounding():
    x = torch.randn(10000, dtype=torch.float32) * 1e3
    r = common._round_tf32(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((r - x).abs() <= x.abs() * 2.0 ** -11)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_data_is_a_dag_from_the_seed(seed):
    """The configuration's data, from its ``fixed_seed``: the same for
    every run, and a DAG."""
    cfg = dict(spec.load_cell(CELLS[0]).config, fixed_seed=seed)
    a, b = datagen.make_data(cfg), datagen.make_data(cfg)
    assert np.array_equal(a.x, b.x) and np.array_equal(a.g, b.g)
    assert a.x.shape == (cfg["n_observations"], cfg["n_vars"])
    assert a.g.sum() == cfg["edges_per_node"] * cfg["n_vars"] - 3
    g = a.g.astype(np.float64)
    power = np.eye(cfg["n_vars"])
    for _ in range(cfg["n_vars"]):
        power = power @ g
    assert not power.any()  # nilpotent: no cycle
    assert np.isfinite(a.x).all()


@pytest.mark.parametrize("name", CELLS)
def test_particles_are_one_set_in_the_seeds_order(name):
    """The port's and the reference's initial particles: the
    configuration's set, in another order for another seed."""
    from portbench.systems import dibs_engine

    cell = tiny(spec.load_cell(name), d=8, p=6)
    cfg = cell.config
    engine = dibs_engine.build(cfg, datagen.make_data(cfg).x, "cpu")
    states = [engine.init_state(s) for s in (3, 2 ** 31 + 4)]
    for st, s in zip(states, (3, 2 ** 31 + 4)):
        z, theta = common.init_particles(cfg, s, common.REFERENCE, "cpu",
                                         st.theta is not None)
        assert torch.equal(st.z.double(), z)
        if theta is not None:
            assert torch.equal(st.theta.double(), theta)
        assert st.seed == s
    a, b = (st.z.reshape(6, -1) for st in states)
    assert not torch.equal(a, b)
    assert torch.equal(a[a[:, 0].argsort()], b[b[:, 0].argsort()])


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 99])
def test_reference_follows_the_port(name, seed):
    """Set-up's start state and a segment's output of the port's CPU path
    lie within 1e-4 of the reference's change (the CPU trials read about
    1e-6)."""
    cell = tiny(spec.load_cell(name), d=20, p=12)
    line, *_ = harness.run_cell(cell, seed, 0.0, False, "cpu")
    values = {k: c["value"] for k, c in line["checks"].items()
              if "_over_" not in k}
    assert line["correct"]
    assert max(values.values()) < 1e-4, values
    assert compare.judge(values, cell.config["limits"])
