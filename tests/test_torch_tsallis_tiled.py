"""The tiled schedule of the Tsallis reduction (B5) and its form reporting,
on the CPU.

``tsallis_reduce_tiled_kernel`` (``csrc/tsallis_reduce.cu``) runs a grid of
(64-sample block, column tile): the fewest tiles of at most 64 columns over
the T*C columns of U, their width W rounded up to four columns (16 bytes).
Block (b, tile) copies its slab of U (the block's valid samples x the
tile's columns) into shared memory in 16-byte pieces where T*C is a multiple
of 4 (4-byte pieces otherwise), takes rho (a strided NaN-keeping minimum
over 256 threads, each warp's xor shuffles, then the 8 warps' minima in
order) and the block's 64 weights, and sums each column of the slab left to
right over the valid samples; tile 0 also sums the weights and writes the
row's 0 and, in block 0, rho.

``tiled_rows`` mirrors that schedule with the kernel's index arithmetic and
float32 operations, and the tests hold it bit for bit against
``tsallis_rows_plain`` (rows) and ``torch.amin`` (rho): K = 8192 and 1920,
a ragged ``K_valid``, column counts that are not a multiple of the tile or
of 4, a gamma that zeros some weights, a NaN cost giving a NaN rho. The
kernel is held against the plain version and its one-block build on the card
(``tests/test_torch_cuda_kernels.py``, ``-k tsallis``).
"""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_sample_warp import stub_form  # noqa: F401 (a fixture)

BLOCK, THREADS, TILE_COLS = 64, 256, 64


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tile_width(TC):
    """The C function's tiles: (W, number of tiles)."""
    tiles = -(-TC // TILE_COLS)
    W = (-(-TC // tiles) + 3) // 4 * 4
    return W, -(-TC // W)


def nan_min(a, b):
    """mppi_common.cuh nan_min: a where a < b or a is NaN, else b."""
    return torch.where((a < b) | torch.isnan(a), a, b)


def block_rho(rho_src):
    """The tiled kernel's rho: thread i takes rho_src[i], [i + 256], ...
    from +inf, each warp's butterfly of xor shuffles (strides 16 to 1), then
    lane 0's of the 8 warps in order."""
    m = torch.full((THREADS,), float("inf"))
    for i in range(0, rho_src.numel(), THREADS):
        part = rho_src[i:i + THREADS]
        m[:part.numel()] = nan_min(m[:part.numel()], part)
    m = m.reshape(THREADS // 32, 32)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        m = nan_min(m, m[:, lane ^ off])
    rho = m[0, 0]
    for w in range(1, THREADS // 32):
        rho = nan_min(rho, m[w, 0])
    return rho


def slab_pieces(n_valid, ncol, vec):
    """(row, first column, width) of every copy a block issues, in the order
    of its loop over e = tid, tid + 256, ..."""
    if vec:
        pieces = ncol // 4
        return [(e // pieces, 4 * (e % pieces), 4) for e in range(n_valid * pieces)]
    return [(e // ncol, e % ncol, 1) for e in range(n_valid * ncol)]


def copied_once(n_valid, ncol, vec, W):
    """Whether the copies fill each slot of the slab's first n_valid rows and
    ncol columns (pitch W) exactly once, and nothing else."""
    hits = np.zeros((BLOCK, W), dtype=int)
    for i, c, n in slab_pieces(n_valid, ncol, vec):
        hits[i, c:c + n] += 1
    want = np.zeros((BLOCK, W), dtype=int)
    want[:n_valid, :ncol] = 1
    return bool((hits == want).all())


def tiled_rows(U, costs, rho_src, gamma, pw, K_valid):
    """The tiled kernel's rows (nb, 2 + T*C) and rho, every sample block at
    once."""
    K, T, C = U.shape
    TC = T * C
    nb = -(-K // BLOCK)
    W, n_tiles = tile_width(TC)
    assert W <= TILE_COLS and W % 4 == 0 and (n_tiles - 1) * W < TC <= n_tiles * W
    vec = TC % 4 == 0
    rho = block_rho(rho_src)
    k = torch.arange(nb * BLOCK).reshape(nb, BLOCK)
    inside = k < K_valid
    n_valid = (K_valid - BLOCK * torch.arange(nb)).clamp(0, BLOCK)
    dj = torch.where(inside, costs[k.clamp(max=K - 1)], 0.0) - rho
    base_w = torch.clamp(1.0 - fr.true_div(dj, gamma), min=1e-30)
    w = torch.where(inside & (dj < gamma), torch.exp(torch.log(base_w) * pw), 0.0)
    Ub = torch.nn.functional.pad(U.reshape(K, TC), (0, 0, 0, nb * BLOCK - K),
                                 value=float("nan")).reshape(nb, BLOCK, TC)
    rows = torch.full((nb, 2 + TC), float("nan"))
    for tile in range(n_tiles):
        c0 = tile * W
        ncol = min(W, TC - c0)
        for n in set(n_valid.tolist()):
            assert copied_once(n, ncol, vec, W)
        # the slab: the copied rows; a row past n_valid is never read
        slab = torch.where(inside[:, :, None], Ub[:, :, c0:c0 + ncol], float("nan"))
        a = torch.zeros((nb, ncol))
        for i in range(BLOCK):
            a = torch.where(inside[:, i, None], a + w[:, i, None] * slab[:, i], a)
        rows[:, 2 + c0:2 + c0 + ncol] = a
    d = torch.zeros((nb,))  # tile 0's sum of the weights
    for i in range(BLOCK):
        d = torch.where(inside[:, i], d + w[:, i], d)
    rows[:, 0], rows[:, 1] = 0.0, d
    return rows, rho


def _inputs(K, T, C, seed, nan_at=None):
    g = torch.Generator().manual_seed(seed)
    U = torch.randn((K, T, C), generator=g)
    costs = 5.0 + 3.0 * torch.rand((K,), generator=g)
    if nan_at is not None:
        costs[nan_at] = float("nan")
    return U, costs


@pytest.mark.parametrize("K,K_valid,T,C", [
    (8192, 8192, 100, 2),  # the colored row: 128 x 4 tiles of 52 columns
    (1920, 1920, 150, 2),  # 30 x 5 tiles of 60
    (1920, 1900, 100, 2),  # a ragged K_valid: the last block 44 samples
    (300, 250, 31, 2),     # T*C = 62: one tile, 4-byte pieces
    (200, 130, 33, 2),     # T*C = 66: tiles of 36 and 30, 4-byte pieces
    (256, 256, 100, 1),    # T*C = 100: tiles of 52 and 48
])
@pytest.mark.parametrize("gamma,r", [(10.0, 2.0), (1.5, 2.4)])
def test_tiled_schedule_equals_the_plain_rows(K, K_valid, T, C, gamma, r):
    U, costs = _inputs(K, T, C, K + T)
    minima = fr.block_minima_plain(costs)
    g32, pw = fr._f32(gamma), fr._tsallis_pw(r)
    rows, rho = tiled_rows(U, costs, minima, g32, pw, K_valid)
    prho = torch.amin(minima)
    assert torch.equal(rho, prho)
    prows = fr.tsallis_rows_plain(U, costs, prho, g32, pw, K_valid)
    assert torch.equal(rows, prows)
    if K_valid == K:
        assert bool((prows[:, 1] > 0).all())  # every block weighs something
    if gamma == 1.5:  # the small gamma zeros some weights
        dj = costs[:K_valid] - prho
        assert 0 < int((dj >= g32).sum()) < K_valid


def test_tiled_schedule_takes_a_given_rho():
    """tsallis_reduce: one given rho (n_rho = 1) in place of the minima."""
    U, costs = _inputs(384, 100, 2, 7)
    rho_src = costs[:300].min().reshape(1)
    g32, pw = fr._f32(0.5), fr._tsallis_pw(2.4)
    rows, rho = tiled_rows(U, costs, rho_src, g32, pw, 300)
    assert torch.equal(rho, rho_src[0])
    assert torch.equal(rows, fr.tsallis_rows_plain(U, costs, rho_src[0], g32, pw, 300))


def test_tiled_schedule_keeps_a_nan_rho():
    U, costs = _inputs(1920, 100, 2, 11, nan_at=1333)
    minima = fr.block_minima_plain(costs)
    rows, rho = tiled_rows(U, costs, minima, fr._f32(10.0), fr._tsallis_pw(2.0), 1920)
    assert bool(torch.isnan(rho)) and bool(torch.isnan(torch.amin(minima)))
    prows = fr.tsallis_rows_plain(U, costs, torch.amin(minima), fr._f32(10.0),
                                  fr._tsallis_pw(2.0))
    assert torch.equal(rows, prows)  # every weight 0: the sums are 0
    assert float(rows[:, 1:].abs().sum()) == 0.0


def test_tiles_cover_every_column_once():
    """The C function's tiles at every T*C up to 600: each column in one
    tile, at most 64 columns and a multiple of 4 wide, the fewest tiles."""
    for TC in range(1, 601):
        W, n_tiles = tile_width(TC)
        assert W % 4 == 0 and W <= TILE_COLS, TC
        cols = [c for t in range(n_tiles) for c in range(t * W, min(TC, (t + 1) * W))]
        assert cols == list(range(TC)), TC
        assert n_tiles == -(-TC // TILE_COLS), TC


@pytest.mark.parametrize("form,name", [(4, "tsallis_reduce_tiled_kernel"),
                                       (0, "tsallis_reduce_kernel")])
def test_tsallis_wrapper_counts_the_reported_form(stub_form, form, name):
    stub_form(form)
    U, costs = _inputs(130, 8, 2, 3)
    fr.reset_launch_counts()
    fr.tsallis_block_rows(U, costs, fr.block_minima_plain(costs), 10.0, 2.0)
    fr.tsallis_reduce(U, costs, costs.min(), 10.0, 2.0, 100)
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        name: 2, "flash_combine_tiled_kernel": 1}
