"""The facts that #2 (``csrc/bge_pairs.cu``) rests on, on the CPU.

Eliminating only the k x k parent block of each (graph, node) and its
border, in increasing parent order with the twin's float32 operations, gives
the same bits as the twin ``bge_logdet_pairs_plain``, which eliminates the
whole identity-padded d x d matrix: non-parent pivots are exactly 1 (log
0), their multipliers exactly 0 and their rows and columns stay exactly
zero. That holds from d = 2 to 128, at the routes' parent-count edges (k =
0, 15 | 16, 31 | 32, 33, 63 | 64, 95 | 96, 127). The block route's schedule (the
parent block at the end of a W x W frame, each thread's cyclic tile, the
phases that update only the slots still live, the double-buffered
publication and the tail's float64 sum) is replayed here thread by thread
in PyTorch, with the kernel's index arithmetic, and gives the twin's bits
too. ``gpu_kernels.bge_pairs_plan`` names a route for every k of every d it
serves, within the shared memory a block may use. No kernel is launched;
the card-side checks are ``chip_smoke.py`` phases 3 and 10 and
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from dibs_tpu_torch.models.linear_gaussian import BGe
from dibs_tpu_torch.ops import gpu_kernels as gk
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
    """``b`` masks with a zero diagonal: ``"empty"``, ``"full"`` (k = d -
    1), a density, or ``"k=<n>"`` (every node ``n`` parents, at most d - 1,
    drawn at random)."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        gs = np.zeros((b, d, d), np.float32)
    elif kind == "full":
        gs = np.ones((b, d, d), np.float32)
    elif kind.startswith("k="):
        k = min(int(kind[2:]), d - 1)
        gs = np.zeros((b, d, d), np.float32)
        for g in range(b):
            for j in range(d):
                others = np.delete(np.arange(d), j)
                gs[g, rng.choice(others, size=k, replace=False), j] = 1.0
    else:
        gs = (rng.uniform(size=(b, d, d)) < float(kind)).astype(np.float32)
    gs[:, np.arange(d), np.arange(d)] = 0.0
    return torch.from_numpy(gs)


# the routes' parent-count edges past d = 32
K_EDGES = ["k=0", "k=15", "k=16", "k=31", "k=32", "k=33", "k=63", "k=64",
           "k=95", "k=96", "k=127"]


def _cases(ds, kinds):
    # fewer graphs at d = 128: the twin forms [B, d, d, d]
    return [(d, kind, 12 if d <= 64 else 3) for d in ds for kind in kinds]


@pytest.mark.parametrize("d,kind,b", _cases(
    [2, 8, 20, 31, 32, 33, 64, 128], ["empty", "full", "0.3", "0.7"])
    + _cases([33, 64], ["k=0", "k=15", "k=16", "k=31", "k=32", "k=33"])
    + _cases([128], K_EDGES))
def test_parents_only_elimination_is_bitwise_the_twin(d, kind, b):
    r_mats, gs = r_mats_of(d, d), masks(d, kind, b=b, seed=d)
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


def block_route_pairs(r_mats, gs, grid, tile):
    """The block route of ``csrc/bge_pairs.cu`` replayed in PyTorch for the
    pairs of ``gs`` whose parent count the frame (``grid`` = (TR, TC)
    threads, ``tile`` = (AR, AC) values a thread) serves: the tile loads,
    every pivot step's publication and update of the live slots (garbage in
    the dead ones included), the log-pivots summed in parent order and the
    border's Schur chain. Returns ``(pa, full, served)``; pairs not served
    are NaN."""
    (tr, tc), (ar, ac) = grid, tile
    w = tr * ar
    b, d, _ = gs.shape
    m = gs.transpose(1, 2).reshape(b * d, d)
    node = torch.arange(d).repeat(b)
    k_all = (m != 0).sum(1)
    pa = torch.full((b * d,), float("nan"))
    full = torch.full((b * d,), float("nan"))
    served = torch.zeros(b * d, dtype=torch.bool)
    for k in k_all.unique().tolist():
        if k == 0 or k >= w or gk.bge_pairs_plan(d, k) != gk.BgePairsPlan(
                "block", tr * tc, grid, tile, gk.bge_pairs_plan(d, k)[4]):
            continue
        t_ = (k_all == k).nonzero().squeeze(1)
        n, mt, jt = len(t_), m[t_], node[t_]
        par = torch.sort((mt == 0).to(torch.int8), dim=1,
                         stable=True).indices[:, :k]
        mp = torch.gather(mt, 1, par)
        o = w - (k + 1)
        # the frame: C at rows o .. o + k - 1, columns o .. o + k - 1, the
        # border at column w - 1; zeros elsewhere
        rows = torch.gather(r_mats[jt], 1, par[:, :, None].expand(-1, -1, d))
        blk = torch.gather(rows, 2, par[:, None, :].expand(-1, k, -1))
        mm = mp[:, :, None] * mp[:, None, :]
        frame = torch.zeros((n, w, w))
        frame[:, o:o + k, o:o + k] = blk * mm + torch.eye(k) * (1.0 - mm)
        frame[:, o:o + k, w - 1] = rows[torch.arange(n), :, jt] * mp
        # thread (ty, tx) holds rows ty + TR a, columns tx + TC b
        c = frame.view(n, ar, tr, ac, tc).permute(0, 2, 4, 1, 3).clone()
        piv, ivs, vb = (torch.empty((n, k)) for _ in range(3))
        for t in range(o, w - 1):
            p = t // tr
            bm = p * tr // tc
            ts_r, ts_c = t - p * tr, t - bm * tc
            col = c[:, :, ts_c, :, bm].clone()  # [n, ty, a]
            row = c[:, ts_r, :, p, :].clone()  # [n, tx, b]
            pivot = c[:, ts_r, ts_c, p, bm].clone()
            inv = 1.0 / pivot
            piv[:, t - o], ivs[:, t - o] = pivot, inv
            vb[:, t - o] = c[:, ts_r, tc - 1, p, ac - 1]
            f = col[:, :, p:] * inv[:, None, None]  # [n, ty, a >= p]
            c[:, :, :, p:, bm:] -= (f[:, :, None, :, None]
                                    * row[:, None, :, None, bm:])
        acc = torch.zeros(n, dtype=torch.float64)
        lg = torch.log(piv.double())
        s = r_mats[jt, jt, jt]
        for i in range(k):
            acc = acc + lg[:, i]
            s = s - vb[:, i] * vb[:, i] * ivs[:, i]
        pa[t_] = acc.float()
        full[t_] = (acc + torch.log(s.double())).float()
        served[t_] = True
    return pa.view(b, d), full.view(b, d), served.view(b, d)


@pytest.mark.parametrize("d,kind,b", _cases([33], ["k=16", "k=32", "full"])
                         + _cases([64], ["k=16", "k=31", "k=32", "k=33", "0.7",
                                         "full"])
                         + _cases([100], ["k=63", "k=64", "k=95", "0.6"])
                         + _cases([128], ["k=96", "k=127", "0.5"]))
def test_block_route_schedule_is_bitwise_the_twin(d, kind, b):
    r_mats, gs = r_mats_of(d, d + 1), masks(d, kind, b=b, seed=d + 1)
    pa_t, full_t = bge_logdet_pairs_plain(r_mats, gs)
    done = torch.zeros(gs.shape[0], d, dtype=torch.bool)
    for p in gk.bge_route_plans():
        if p.route != "block":
            continue
        pa, full, served = block_route_pairs(r_mats, gs, p.grid, p.tile)
        assert not (served & done).any()  # one route a pair
        done |= served
        assert torch.equal(pa[served], pa_t[served])
        assert torch.equal(full[served], full_t[served])
    k = (gs != 0).sum(1)
    assert torch.equal(done, k > gk.BGE_WARP_MAX_K) and bool(done.any())


def test_block_route_schedule_on_collinear_data():
    r_mats, gs = r_mats_of(64, 7, collinear=True), masks(64, "k=40", b=4)
    gs[:, :2, 5] = 1.0  # nodes 0 and 1, collinear, parents of node 5
    pa_t, full_t = bge_logdet_pairs_plain(r_mats, gs)
    p = gk.bge_pairs_plan(64, 40)
    pa, full, served = block_route_pairs(r_mats, gs, p.grid, p.tile)
    assert served[:, 5].all()
    assert torch.equal(pa[served], pa_t[served])
    assert torch.equal(full[served], full_t[served])


def test_every_parent_count_has_a_route_within_shared_memory():
    for d in range(2, 129):
        for k in range(d):
            plan = gk.bge_pairs_plan(d, k)
            assert plan.smem_bytes <= 232_448
            if plan.route == "warp":
                assert k <= (31 if d <= 32 else gk.BGE_WARP_MAX_K)
                assert plan.tile[0] >= k
            else:
                (tr, tc), (ar, ac) = plan.grid, plan.tile
                assert d > 32 and k > gk.BGE_WARP_MAX_K
                assert plan.threads == tr * tc <= 1024
                assert tr * ar == tc * ac >= k + 1  # C's k columns, v
                assert tc % tr == 0 and ar % 4 == 0
    for d, k in ((32, 32), (128, 128), (64, 65), (2, -1), (129, 3)):
        with pytest.raises(ValueError):
            gk.bge_pairs_plan(d, k)
    assert gk.bge_pairs_plan(64, 64).route == "block"  # a self-loop on j
