"""Shared set-up of the benchmark's tests: the checkout on the module
path, and the cells at a size a CPU test run holds."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("joint_linear_sf128.single", "marginal_bge_sf128.dense")


def tiny(cell, d=16, p=8):
    """``cell`` at d = ``d``, P = ``p``, N = 30, M = 8, K = 4, 2 warm
    steps and segments of 3 (the configuration's limits unchanged)."""
    cfg = dict(cell.config, n_vars=d, latent_dim=d, n_particles=p,
               n_observations=30, n_grad_mc_samples=8,
               n_acyclicity_mc_samples=4, reference_options={})
    if "bge_alpha_lambd" in cfg:
        cfg["bge_alpha_lambd"] = d + 2.0
    return cell._replace(config=cfg, traffic=dict(cell.traffic, warm_steps=2,
                                                  segment_steps=3))


@pytest.fixture
def tiny_cell():
    from portbench import spec

    return lambda name, **kw: tiny(spec.load_cell(name), **kw)
