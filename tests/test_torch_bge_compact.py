"""The fact that #2's d <= 32 tier (``csrc/bge_pairs.cu``) rests on, on the
CPU: eliminating only the k x k parent block of each (graph, node) and its
border, in increasing parent order with the twin's float32 operations, gives
the same bits as the twin ``bge_logdet_pairs_plain``, which eliminates the
whole identity-padded d x d matrix. Non-parent pivots are exactly 1 (log 0),
their multipliers exactly 0 and their rows and columns stay exactly zero.
No kernel is launched; the card-side checks are ``chip_smoke.py`` phase 3
and ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from dibs_tpu_torch.models.linear_gaussian import BGe
from dibs_tpu_torch.ops.bge_kernel import bge_logdet_pairs_plain

torch.set_num_threads(1)


def parents_only_pairs(r_mats, gs):
    """The kernel's design in plain PyTorch: per (graph, node) with k
    parents, ``C = A[Pa, Pa]`` (the padded matrix's entries), the border
    ``v[Pa]`` and ``s = R_j[j, j]``, swept as the twin sweeps, the
    log-pivots summed in float64; the tasks with the same k batched."""
    b, d, _ = gs.shape
    m = gs.transpose(1, 2).reshape(b * d, d)  # [task, row]: node j's mask
    node = torch.arange(d).repeat(b)
    k_all = (m != 0).sum(1)
    pa = torch.empty(b * d, dtype=torch.float32)
    full = torch.empty(b * d, dtype=torch.float32)
    for k in k_all.unique().tolist():
        t = (k_all == k).nonzero().squeeze(1)
        n, mt, jt = len(t), m[t], node[t]
        # the parents in increasing order: a stable sort of (m == 0)
        par = torch.sort((mt == 0).to(torch.int8), dim=1,
                         stable=True).indices[:, :k]
        mp = torch.gather(mt, 1, par)  # [n, k]
        rows = torch.gather(r_mats[jt], 1, par[:, :, None].expand(-1, -1, d))
        blk = torch.gather(rows, 2, par[:, None, :].expand(-1, k, -1))
        mm = mp[:, :, None] * mp[:, None, :]
        a = blk * mm + torch.eye(k) * (1.0 - mm)
        v = rows[torch.arange(n), :, jt] * mp
        s = r_mats[jt, jt, jt]
        acc = torch.zeros(n, dtype=torch.float64)
        for i in range(k):
            pivot = a[:, i, i]
            inv = 1.0 / pivot
            acc = acc + torch.log(pivot.double())
            vi = v[:, i]
            s = s - vi * vi * inv
            colf = a[:, i + 1:, i] * inv[:, None]
            v[:, i + 1:] -= colf * vi[:, None]
            a[:, i + 1:, i + 1:] -= colf[:, :, None] * a[:, i, None, i + 1:]
        pa[t] = acc.float()
        full[t] = (acc + torch.log(s.double())).float()
    return pa.view(b, d), full.view(b, d)


def r_mats_of(d, seed, collinear=False):
    x = np.random.default_rng(seed).normal(size=(100, d)).astype(np.float32)
    if collinear:  # chip_smoke.py phase 3's collinear case
        x[:, 1] = x[:, 0] + 1e-3 * x[:, 1]
    x = torch.from_numpy(x)
    r, _ = BGe(n_vars=d, device="cpu")._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    return r.contiguous()


def masks(d, kind, b=12, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "empty":
        gs = np.zeros((b, d, d), np.float32)
    elif kind == "full":
        gs = np.ones((b, d, d), np.float32)
    else:
        gs = (rng.uniform(size=(b, d, d)) < float(kind)).astype(np.float32)
    gs[:, np.arange(d), np.arange(d)] = 0.0
    return torch.from_numpy(gs)


@pytest.mark.parametrize("d", [2, 8, 20, 31, 32])
@pytest.mark.parametrize("kind", ["empty", "full", "0.3", "0.7"])
def test_parents_only_elimination_is_bitwise_the_twin(d, kind):
    r_mats, gs = r_mats_of(d, d), masks(d, kind, seed=d)
    pa, full = parents_only_pairs(r_mats, gs)
    pa_t, full_t = bge_logdet_pairs_plain(r_mats, gs)
    assert torch.equal(pa, pa_t) and torch.equal(full, full_t)
    assert torch.isfinite(pa).all() and torch.isfinite(full).all()
    if kind == "empty":
        assert bool((pa == 0).all())


def test_parents_only_elimination_is_bitwise_the_twin_on_collinear_data():
    r_mats, gs = r_mats_of(20, 7, collinear=True), masks(20, "0.3", b=64)
    gs[:, :2, 5] = 1.0  # nodes 0 and 1, collinear, parents of node 5
    pa, full = parents_only_pairs(r_mats, gs)
    pa_t, full_t = bge_logdet_pairs_plain(r_mats, gs)
    assert torch.equal(pa, pa_t) and torch.equal(full, full_t)
