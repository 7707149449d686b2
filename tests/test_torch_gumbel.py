"""The sampler kernel #1 (``csrc/gumbel.cu``) on the CPU: its launch plan,
which the wrapper computes and the kernel takes as given, and the fast soft
form the kernel takes at ``tau == 1`` with in-kernel noise,
``g = u / (u + (1 - u) exp(-alpha s))``, held to the log form of the twin
``gumbel_graphs_plain`` on the same Philox uniforms. No kernel is launched;
the card-side checks are ``chip_smoke.py`` phases 3 and 6 and
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from dibs_tpu_torch.ops import gpu_kernels as gk
from dibs_tpu_torch.utils.func import zero_diagonal

torch.set_num_threads(1)

SMS = 132  # an H100 SXM
TARGET = 2 * SMS * 2048  # two waves of full SMs


def fast_form(scores, u, alpha):
    """The kernel's tau = 1 form in float32, operation for operation."""
    e_neg = torch.exp(-(alpha * scores))[:, None]
    return u / (u + (1.0 - u) * e_neg)


def test_uniforms_stay_bitwise():
    """philox_uniform's contract: word 0 of Philox4x32-10 at counter
    (element, sample, particle, stream), key = the seed; top 24 bits,
    half-ulp offset, clamp at 1 - 2^-23 (pinned values)."""
    u = gk.philox_uniform((2, 2, 2, 2), seed=0x123456789ABCDEF0, stream=3,
                          device="cpu")
    want = ["0x1.63811cp-1", "0x1.9c3d2cp-1", "0x1.c98c7ap-2", "0x1.465380p-1",
            "0x1.97086cp-3", "0x1.edca28p-1", "0x1.2d223ep-2", "0x1.7deda6p-2",
            "0x1.812910p-5", "0x1.14e546p-2", "0x1.fe00c0p-7", "0x1.e26bdap-2",
            "0x1.3c0614p-3", "0x1.677548p-4", "0x1.a8cfaap-2", "0x1.3b3c40p-7"]
    assert u.dtype == torch.float32
    assert [float(x) for x in u.flatten()] == [float.fromhex(w) for w in want]


@pytest.mark.parametrize("d", [5, 20, 128])
def test_fast_form_matches_the_log_form(d):
    """Within the card's 1e-5 bar, at every score range: |alpha s| > 88
    (exp overflows or underflows: exactly 0 below, 1 above) and s below
    -88 / alpha.
    (The form 1 / (1 + (1/u - 1) exp(-alpha s)) misses the bar: 1/u - 1
    cancels for u near 1, 2.3e-5 off at d = 128 here.)"""
    b, m, alpha = 3, 4, 1.7
    rng = np.random.default_rng(d)
    scores = rng.normal(scale=3.0, size=(b, d, d)).astype(np.float32)
    scores[0] *= 40.0  # |alpha s| up to ~700
    scores[1, :, : d // 2] = -60.0  # alpha s = -102 < -88
    scores[1, :, d // 2:] = 60.0
    s = torch.from_numpy(scores)
    u = gk.philox_uniform((b, m, d, d), seed=21, stream=0, device="cpu")
    fast = zero_diagonal(fast_form(s, u, alpha))
    ref = gk.gumbel_graphs_plain(s, 21, 0, alpha, 1.0, m, hard=False)
    assert torch.isfinite(fast).all()
    assert float((fast - ref).abs().max()) <= 1e-5
    # exp(-alpha s) overflows to inf past 88.72: exactly 0 there
    below = (alpha * s < -88.75)[:, None].expand_as(fast)
    assert bool(below.any()) and bool((fast[below] == 0.0).all())
    above = (alpha * s > 88.0)[:, None].expand_as(fast)
    off = ~torch.eye(d, dtype=torch.bool).expand_as(fast)
    assert bool((fast[above & off] == 1.0).all())


def test_plan_at_config5_and_the_marginal_shapes():
    """Config 5's soft [1000, 8, 128, 128]: runs of 4, all 8 samples a
    thread, one group; the marginal step's hard [30, 128, 20, 20] and soft
    [30, 32, 20, 20]: the samples split to one a thread."""
    assert gk.gumbel_plan(1000, 8, 128, True, SMS) == gk.GumbelPlan(
        4, 256, 8, (16000, 1))
    assert gk.gumbel_plan(30, 128, 20, True, SMS) == gk.GumbelPlan(
        4, 256, 1, (12, 128))
    assert gk.gumbel_plan(30, 32, 20, True, SMS) == gk.GumbelPlan(
        4, 256, 1, (12, 32))


@pytest.mark.parametrize("b,m,d,aligned,vec", [
    (4, 8, 5, True, 1),  # d * d % 4 != 0: the scalar path
    (4, 8, 13, True, 1),
    (600, 128, 5, True, 1),  # B * M = 76,800 > 65,535
    (30, 128, 20, False, 1),  # misaligned tensors: the scalar path
    (2, 3, 6, True, 4),  # d % 4 != 0, d * d % 4 == 0: runs cross rows
    (1, 140_000, 2, True, 4),  # more samples than gridDim.y holds
    (3, 1, 1, True, 1),
    (264, 1, 128, True, 4),  # one sample, units exactly fill the target
])
def test_plan_edges(b, m, d, aligned, vec):
    plan = gk.gumbel_plan(b, m, d, aligned, SMS)
    units = b * d * d // plan.vec
    assert plan.vec == vec and plan.threads == 256
    assert plan.grid[0] * plan.threads >= units > (plan.grid[0] - 1) * 256
    # the groups cover every sample once, within gridDim.y's limit
    assert 1 <= plan.grid[1] <= 65535
    assert plan.grid[1] * plan.group >= m > (plan.grid[1] - 1) * plan.group
    # no more groups than reach the target; one sample fewer a thread
    # would need more than the target or than gridDim.y holds
    assert units * (plan.grid[1] - 1) < TARGET
    if plan.group > 1:
        fewer = -(-m // (plan.group - 1))
        assert units * fewer >= TARGET or fewer > 65535


def test_plan_takes_one_group_once_the_elements_fill_the_card():
    for b, m, d in [(1000, 8, 128), (1000, 32, 128), (132, 4, 128)]:
        plan = gk.gumbel_plan(b, m, d, True, SMS)
        assert plan.group == m and plan.grid[1] == 1


def test_plan_of_empty_shapes():
    assert gk.gumbel_plan(1, 0, 4, True, SMS).grid == (1, 0)
    assert gk.gumbel_plan(0, 5, 4, True, SMS).grid == (0, 5)
