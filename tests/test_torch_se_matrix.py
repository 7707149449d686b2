"""Host-side logic of the SE-matrix kernel #3 (``csrc/se_matrix.cu``) on the
CPU: the tiles a call launches, the feature split, and the symmetric calls
the SVGD kernels make.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here: the tile enumeration covers every ``(a, b)`` of an
``A x B`` output exactly once, counting the mirrored writes of a symmetric
call; ``se_tile_of`` (the kernel's closed form, in Python) gives the same
order; the split fills the card's waves as its docstring says; and
``AdditiveFrobeniusSEKernel`` / ``JointAdditiveFrobeniusSEKernel`` reach
``se_matrix`` with ``x is y`` exactly when the caller passed the same
particles twice. Sizes are exact integers: no tolerance.
"""
import numpy as np
import pytest
import torch

from dibs_tpu_torch import kernel as port_kernel
from dibs_tpu_torch.ops import gpu_kernels as gk

torch.set_num_threads(1)

SIZES = [1, 7, 30, 129, 1000]


def _coverage(a, b, symmetric, tile):
    """How often each ``(a, b)`` is written by the launched tiles."""
    count = np.zeros((a, b), dtype=np.int64)
    for ta, tb in gk.se_tiles(a, b, symmetric, tile):
        rows = slice(ta * tile, min(a, (ta + 1) * tile))
        cols = slice(tb * tile, min(b, (tb + 1) * tile))
        count[rows, cols] += 1
        if symmetric and ta != tb:
            count[cols, rows] += 1  # the mirrored write
    return count


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("a", SIZES)
def test_symmetric_tiles_cover_every_entry_once(a, tile):
    tiles = gk.se_tiles(a, a, True, tile)
    assert all(ta <= tb for ta, tb in tiles)
    assert np.array_equal(_coverage(a, a, True, tile), np.ones((a, a)))
    assert len(tiles) == gk.se_tile_count(a, a, True, tile)
    # the kernel's closed form enumerates the same tiles in the same order
    assert [gk.se_tile_of(t, -(-a // tile), True)
            for t in range(len(tiles))] == tiles


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("a,b", [(a, b) for a in SIZES for b in (1, 129, 1000)])
def test_full_tiles_cover_every_entry_once(a, b, tile):
    tiles = gk.se_tiles(a, b, False, tile)
    assert np.array_equal(_coverage(a, b, False, tile), np.ones((a, b)))
    assert len(tiles) == gk.se_tile_count(a, b, False, tile)
    assert [gk.se_tile_of(t, -(-b // tile), False)
            for t in range(len(tiles))] == tiles


def test_closed_form_holds_for_large_triangles():
    """``se_tile_of`` against the enumeration far past config 5 (the
    reduction's 32-row tiles at P = 10,000: 313 tiles a side)."""
    tiles = gk.se_tiles(10000, 10000, True, 32)
    got = [gk.se_tile_of(t, 0, True) for t in range(len(tiles))]
    assert got == tiles


def test_tile_size_takes_the_small_tile_below_128_rows():
    assert gk.se_tile_size(1000, 1000) == 128
    assert gk.se_tile_size(129, 129) == 128
    assert gk.se_tile_size(30, 30) == 32
    assert gk.se_tile_size(7, 129) == 32


@pytest.mark.parametrize("slots", [132, 264, 528])
def test_split_fills_the_last_wave_best(slots):
    """Config 5's triangle (36 tiles of 128) over n = 32,768 and 16,384:
    S > 1, within the cap, and no S in the cap fills its last wave better;
    S = 1 at the d=20 ``[30, 30]`` over 800, for short rows and where the
    tiles alone fill two waves."""
    tiles = gk.se_tile_count(1000, 1000, True, 128)
    assert tiles == 36

    def fill(s):
        blocks = tiles * s
        return blocks / (-(-blocks // slots) * slots)

    for n in (32768, 16384):
        cap = min(gk._SE_MAX_SPLITS, n // gk._SE_MIN_SLICE)
        s = gk.se_split(tiles, n, slots)
        assert 1 < s <= cap
        assert all(fill(s) >= fill(o) for o in range(1, cap + 1))
        assert all(fill(s) > fill(o) for o in range(1, s))  # smallest such
    assert gk.se_split(gk.se_tile_count(30, 30, True, 32), 800, slots) == 1
    assert gk.se_split(36, 2 * gk._SE_MIN_SLICE - 1, slots) == 1
    assert gk.se_split(2 * slots, 32768, slots) == 1


def test_split_on_the_h100_at_config_5():
    """132 SMs with two resident blocks each: seven slices, 252 blocks in
    one wave of 264 (the scratch [7, 1000, 1000] is 28 MB)."""
    assert gk.se_split(36, 32768, 264) == 7
    assert gk.se_split(36, 16384, 264) == 7


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(9, 33)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(4, 33)).astype(np.float32))
    for a, b in ((x, x), (x, y)):
        assert torch.equal(gk.se_matrix(a, b, 3.0, 0.5),
                           gk.se_matrix_plain(a, b, 3.0, 0.5))


@pytest.fixture
def calls(monkeypatch):
    """Records ``(x is y, x.shape, y.shape)`` of every ``se_matrix`` call of
    the SVGD kernels."""
    seen = []

    def recorder(x, y, h, scale):
        seen.append((x is y, tuple(x.shape), tuple(y.shape)))
        return gk.se_matrix_plain(x, y, h, scale)

    monkeypatch.setattr(port_kernel, "se_matrix", recorder)
    return seen


def _particles(seed, p=5, d=4, k=3):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.normal(size=(p, d, k, 2)).astype(np.float32))
    theta = torch.from_numpy(rng.normal(size=(p, d, d)).astype(np.float32))
    tree = [tuple(torch.from_numpy(rng.normal(size=(p,) + s)
                                   .astype(np.float32)) for s in shapes)
            for shapes in (((d, 3, d), (d, 3)), ((d, 3), (d,)))]
    return z, theta, tree


def test_marginal_kernel_sends_the_same_particles_as_one_matrix(calls):
    z, _, _ = _particles(1)
    z2, _, _ = _particles(2)
    kern = port_kernel.AdditiveFrobeniusSEKernel(h=5.0)
    k_zz = kern.matrix(z, z)
    kern.matrix_and_grad_factor(z, z)
    kern.matrix(z, z2)
    assert calls == [(True, (5, 24), (5, 24))] * 2 + [(False, (5, 24),
                                                       (5, 24))]
    assert torch.equal(k_zz, k_zz.T)


@pytest.mark.parametrize("theta_kind", ["tensor", "tree"])
def test_joint_kernel_sends_the_same_particles_as_one_matrix(calls,
                                                              theta_kind):
    z, theta, tree = _particles(3)
    z2, theta2, tree2 = _particles(4)
    t, t2 = (theta, theta2) if theta_kind == "tensor" else (tree, tree2)
    n_t = 16 if theta_kind == "tensor" else 4 * 3 * 4 + 4 * 3 + 4 * 3 + 4
    kern = port_kernel.JointAdditiveFrobeniusSEKernel()
    k_z, k_t, _, _ = kern.component_matrices_and_factors(z, t, z, t)
    assert calls == [(True, (5, 24), (5, 24)), (True, (5, n_t), (5, n_t))]
    assert torch.equal(k_z, k_z.T) and torch.equal(k_t, k_t.T)
    calls.clear()
    kern.component_matrices_and_factors(z, t, z2, t2)
    assert calls == [(False, (5, 24), (5, 24)), (False, (5, n_t), (5, n_t))]
