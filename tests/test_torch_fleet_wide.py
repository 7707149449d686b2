"""The wide fused tier (d > 70) in a fleet, on the CPU: ``JointDiBS`` with
``LinearGaussian`` at d = 75, the kernel table's smallest wide shape (B =
2 datasets, P = 2, M = 4, K = 2, N = 20), through the wide passes' plain
versions with the dataset axis.

Against ``dibs_tpu.fleet``: on the CPU the reference declines its fused
Pallas kernels (they run on a TPU backend only) and takes its generic
shared-noise estimators (``fused_sample_sharing='hard'``: one
``logistic(k_lik, [P, M, d, d])`` a step serves both likelihood
gradients), the same estimand as the port's two wide passes on that
noise. The bar is the joint tests': teacher-forced ``phi`` of every
dataset within ``1e-4 max|phi|`` (3 steps), then a free run (2 steps) on
the reference's noise that ends where ``fleet_sample`` ends. Against
single port runs: dataset b equals a single engine on ``xs[b]`` seeded
``fleet_seeds(seed, B)[b]``.
"""
import numpy as np
import torch
from test_torch_fleet_estimators import (
    check_reference_fleet,
    check_single_port_runs,
    spec,
)

from dibs_tpu_torch.fleet import fleet_seeds
from dibs_tpu_torch.inference import fused_linear as fl
from dibs_tpu_torch.models import LinearGaussian

torch.set_num_threads(1)

WIDE = dict(D=75, B=2, P=2, M=4, K=2, N=20, STEPS=3, FREE=2)


def test_wide_fleet_matches_reference_fleet():
    port, arbitrated = check_reference_fleet(spec(**WIDE))
    # the port's route: the wide tier's two passes
    assert port.est.fused_grad_both.__name__ == "fused_linear"
    assert fl.fused_linear_tile_rows(WIDE["D"], WIDE["N"]) is None
    assert fl.fused_linear_wide_tile_rows(WIDE["D"], WIDE["N"]) is not None
    assert not arbitrated, arbitrated


def test_wide_fleet_matches_single_port_runs():
    check_single_port_runs(spec(**WIDE), steps=3)


def test_wide_plain_passes_per_dataset():
    """The wide passes' plain versions with the dataset axis are, bitwise,
    their unbatched versions on each dataset's slice with its key."""
    rng = np.random.default_rng(5)
    n_ds, p, d, n_obs, m = 2, 2, WIDE["D"], 12, 3
    scores, thetas = (torch.from_numpy(rng.normal(size=(n_ds * p, d, d))
                                       .astype(np.float32))
                      for _ in range(2))
    x = torch.from_numpy(rng.normal(size=(n_ds, n_obs, d)).astype(
        np.float32))
    w = torch.from_numpy((rng.uniform(size=x.shape) > 0.1).astype(
        np.float32))
    keys = fleet_seeds(6, n_ds)
    kw = dict(streams=(6, 6), alpha=1.3, tau=1.0, n_samples=m,
              model=LinearGaussian(n_vars=d))
    lls = fl.fused_linear_pass1_plain(scores, thetas, x, w, seed=keys, **kw)
    weights = tuple(torch.softmax(ll, 1) for ll in lls)
    out = fl.fused_linear_pass2_plain(scores, thetas, x, w, weights,
                                      seed=keys, **kw)
    for i, key in enumerate(keys.tolist()):
        sl = slice(i * p, (i + 1) * p)
        one = fl.fused_linear_pass1_plain(scores[sl], thetas[sl], x[i], w[i],
                                          seed=key, **kw)
        assert all(torch.equal(a[sl], b) for a, b in zip(lls, one))
        one = fl.fused_linear_pass2_plain(
            scores[sl], thetas[sl], x[i], w[i],
            tuple(t[sl] for t in weights), seed=key, **kw)
        assert all(torch.equal(a[sl], b) for a, b in zip(out, one))
