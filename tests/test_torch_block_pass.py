"""The schedules of the passes after the warp forms, and of their launch
bookkeeping, on the CPU.

The warp forms of B4, B3 and B1 (``csrc/sample_warp.cuh``,
``csrc/rollout_kernel.cuh``) hold 4 or 8 samples a block, so the carry rows
of 64 samples, and for Tsallis pass 1 the 64-sample minima, are written by a
second launch (``csrc/block_pass.cuh``):

* ``block_carry_tiled_kernel``: one block of 64 threads per (64-sample
  group, tile of 32 or 64 columns); the group's slab of X staged in shared
  memory; s = -J / lam (-1e30 past K); m_b and d_b by block_max's and
  block_sum's trees, the off = 32 step through shared memory (thread t with
  thread t + 32's value), then off = 16 ... 1 by ``__shfl_down_sync``
  (lane l with lane l + off, a lane past the warp keeping its own value);
  w = exp(s - m_b); each column of the slab summed over the group's valid
  samples left to right. Tiles past the grid's 65535 rows loop.
* ``block_min_warp_kernel``: one warp a group, lane l holding costs l and
  l + 32 (1e30 past K), ``nan_min`` of the pair, then ``nan_min`` with
  ``__shfl_down_sync`` at 16 ... 1.

``tiled_carry_pass`` and ``warp_min_pass`` emulate those schedules with
float32 tensor operations in the kernels' order, and the tests hold them bit
for bit against the plain versions (``fr.block_carries_ordered``,
``fr.block_minima_plain``) at the paths' shapes and ragged ones, with NaN and
+inf costs. The kernels themselves are held against the plain versions on
the card (``tests/test_torch_cuda_kernels.py``, ``-k block_pass``). Also:
the wrappers' CPU paths and launch counts by the form a (stubbed) library
reports, and the C signatures of the new entries.
"""

import pytest
import torch

from mppi_generic_tpu_torch.ops import _build, riccati
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.utils.math_utils import true_div
from test_torch_sample_warp import _StubLibrary

LANES = 32
GRID_Y = 65535  # the most rows of a grid


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _shfl_down_tree(v, op):
    """Lanes (the last axis, 32 wide) reduced by ``op`` at off = 16 ... 1
    with __shfl_down_sync's values: lane l takes op(v[l], v[l + off]), a
    lane with l + off >= 32 op(v[l], v[l]). Lane 0's value."""
    off = LANES // 2
    while off:
        shifted = torch.cat([v[..., off:], v[..., LANES - off:]], dim=-1)
        v = op(v, shifted)
        off //= 2
    return v[..., 0]


def _groups(v, K, pad, block=fr.BLOCK):
    """v (K,) padded with ``pad`` to whole groups: (nb, 64)."""
    nb = -(-K // block)
    out = torch.full((nb * block,), pad, dtype=torch.float32)
    out[:K] = v
    return out.reshape(nb, block)


def tiled_carry_pass(costs, X, lam, tile):
    """block_carry_tiled_kernel's schedule: (nb, 2 + TC) carry rows."""
    K, T, C = X.shape
    TC = T * C
    s = _groups(true_div(-costs, lam), K, fr._MASKED)
    nb = s.shape[0]
    lo, hi = s[:, :LANES], s[:, LANES:]  # thread t and thread t + 32
    m_b = _shfl_down_tree(torch.fmax(lo, hi), torch.fmax)
    w_lo, w_up = torch.exp(lo - m_b[:, None]), torch.exp(hi - m_b[:, None])
    d_b = _shfl_down_tree(w_lo + w_up, torch.add)
    w = torch.cat([w_lo, w_up], dim=1)
    rows = torch.full((nb, 2 + TC), float("nan"))
    rows[:, 0], rows[:, 1] = m_b, d_b
    # group b's valid rows (rows past K are not read: a padded row never
    # enters a sum)
    valid = (torch.arange(nb * fr.BLOCK) < K).reshape(nb, fr.BLOCK)
    Xp = torch.zeros((nb * fr.BLOCK, TC))
    Xp[:K] = X.reshape(K, TC)
    Xp = Xp.reshape(nb, fr.BLOCK, TC)
    n_tiles = -(-TC // tile)
    for y in range(min(n_tiles, GRID_Y)):  # every group's block (b, y)
        for t_ in range(y, n_tiles, GRID_Y):  # the tiles that block takes
            c0, c1 = t_ * tile, min(TC, (t_ + 1) * tile)
            a = torch.zeros((nb, c1 - c0))
            for i in range(fr.BLOCK):
                a = torch.where(valid[:, i, None], a + w[:, i, None] * Xp[:, i, c0:c1], a)
            rows[:, 2 + c0:2 + c1] = a
    return rows


def _nan_min(a, b):
    """nan_min (csrc/mppi_common.cuh): (a < b || a != a) ? a : b."""
    return torch.where((a < b) | torch.isnan(a), a, b)


def warp_min_pass(costs):
    """block_min_warp_kernel's schedule: each group's minimum (nb,)."""
    v = _groups(costs, costs.shape[0], fr._MIN_PAD)
    return _shfl_down_tree(_nan_min(v[:, :LANES], v[:, LANES:]), _nan_min)


def _same(a, b):
    """Bit for bit, NaN where the other is NaN."""
    return torch.equal(a, b) or (torch.equal(a.isnan(), b.isnan())
                                 and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _costs(K, special, seed):
    g = torch.Generator().manual_seed(seed)
    costs = 50.0 * torch.rand((K,), generator=g) + 10.0
    if special == "nan":
        costs[K // 2] = float("nan")
    elif special == "inf":
        costs[K - 1] = float("inf")
    return costs, g


@pytest.mark.parametrize("special", ["", "nan", "inf"])
@pytest.mark.parametrize("lam", [0.3, 1.0])
@pytest.mark.parametrize("TC", [300, 200, 62, 2])
@pytest.mark.parametrize("K", [1920, 1901, 65, 64, 1])
def test_tiled_carry_pass_equals_the_ordered_rows(K, TC, lam, special):
    """The tiled schedule, tiles of 32 and 64 columns, against the rows in
    write_block_carry's order, bit for bit (NaN where they are NaN)."""
    costs, g = _costs(K, special, seed=K + TC)
    X = torch.randn((K, TC // 2, 2), generator=g)
    want = fr.block_carries_ordered(costs, X, fr._f32(lam))
    for tile in (32, 64):
        got = tiled_carry_pass(costs, X, fr._f32(lam), tile)
        assert _same(got, want), tile
    if special == "nan":
        assert bool(want.isnan().any())


@pytest.mark.parametrize("special", ["", "nan", "inf"])
@pytest.mark.parametrize("K", [1920, 1901, 65, 64, 1])
def test_warp_min_pass_equals_the_plain_minima(K, special):
    costs, _ = _costs(K, special, seed=K + 7)
    got, want = warp_min_pass(costs), fr.block_minima_plain(costs)
    assert _same(got, want)
    assert bool(got.isnan().any()) == (special == "nan")


def test_the_trees_order_matters():
    """d_b summed left to right over the 64 weights differs from the
    trees' float for these costs, so the comparison above would catch a
    pass that summed in another order."""
    costs, g = _costs(1920, "", seed=3)
    costs = costs * 0.01
    s = _groups(true_div(-costs, fr._f32(0.3)), 1920, fr._MASKED)
    w = torch.exp(s - s.amax(1, keepdim=True))
    seq = torch.zeros(w.shape[0])
    for i in range(fr.BLOCK):
        seq = seq + w[:, i]
    want = fr.block_carries_ordered(costs, torch.randn((1920, 3, 2), generator=g),
                                    fr._f32(0.3))
    assert not torch.equal(seq, want[:, 1])


def test_grid_rows_past_the_limit_loop():
    """A row of more tiles than the grid has rows: the blocks loop over
    tiles y, y + 65535, ... (the emulation with a small limit)."""
    global GRID_Y
    saved, GRID_Y = GRID_Y, 3
    try:
        costs, g = _costs(130, "", seed=5)
        X = torch.randn((130, 50, 2), generator=g)
        got = tiled_carry_pass(costs, X, fr._f32(1.0), 16)  # 7 tiles on 3 rows
    finally:
        GRID_Y = saved
    assert torch.equal(got, fr.block_carries_ordered(costs, X, fr._f32(1.0)))


def test_cpu_wrappers_run_the_plain_versions():
    costs, g = _costs(130, "", seed=9)
    X = torch.randn((130, 31, 2), generator=g)
    fr.reset_launch_counts()
    assert torch.equal(fr._block_carries(costs, X, 1.0),
                       fr.block_carries_ordered(costs, X, fr._f32(1.0)))
    assert torch.equal(fr._block_minima(costs), fr.block_minima_plain(costs))
    assert not any(fr.launch_counts.values())
    with pytest.raises(ValueError):
        fr._block_carries(costs[:-1], X, 1.0)
    with pytest.raises(ValueError):
        fr._block_carries(costs, X.transpose(0, 1), 1.0)


class _PassStub(_StubLibrary):
    """A stubbed library whose ``block_pass_form()`` and
    ``riccati_backward_form()`` return ``pass_form``, and which records
    the arguments of its pass entries."""

    def __init__(self, pass_form):
        super().__init__(1)
        self.pass_form = pass_form
        self.calls = []

    def __getattr__(self, name):
        if name in ("block_pass_form", "riccati_backward_form"):
            return lambda: self.pass_form
        if name in ("block_carry_pass", "block_min_pass"):
            return lambda *args: self.calls.append((name, args)) or 0
        if name == "riccati_max_alphas":
            return lambda: riccati.MAX_ALPHAS
        return super().__getattr__(name)


@pytest.mark.parametrize("pass_form,names", [
    (4, ("block_carry_tiled_kernel", "block_min_warp_kernel")),
    (0, ("block_carry_kernel", "block_min_kernel"))])
def test_pass_wrappers_count_the_reported_form(monkeypatch, pass_form, names):
    lib = _PassStub(pass_form)
    monkeypatch.setattr(fr, "_lib", lambda name="flash_combine": lib)
    monkeypatch.setattr(fr, "_on_cpu", lambda t: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    costs = torch.zeros(130)
    fr.reset_launch_counts()
    carry = fr._block_carries(costs, torch.zeros((130, 31, 2)), 0.5)
    minima = fr._block_minima(costs)
    assert carry.shape == (3, 64) and minima.shape == (3,)
    assert {k: v for k, v in fr.launch_counts.items() if v} == dict.fromkeys(names, 1)
    (carry_fn, carry_args), (min_fn, min_args) = lib.calls
    assert (carry_fn, min_fn) == ("block_carry_pass", "block_min_pass")
    assert carry_args[3:6] == (130, 62, fr._f32(0.5))  # K, TC, lam
    assert min_args[2] == 130


@pytest.mark.parametrize("form,name", [(1, "riccati_backward_warp_kernel"),
                                       (0, "riccati_backward_kernel")])
def test_backward_wrapper_counts_the_reported_form(monkeypatch, form, name):
    lib = _PassStub(form)
    monkeypatch.setattr(riccati, "_lib", lambda: lib)
    monkeypatch.setattr(riccati, "_on_cpu", lambda t: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    S, C, T = 7, 2, 1024
    args = (torch.zeros((T, S, S)), torch.zeros((T, S, C)), torch.zeros((T, S)),
            torch.zeros((T, C)), torch.eye(S), torch.eye(C), torch.eye(S), torch.zeros(S))
    riccati.reset_launch_counts()
    Ks, ks = riccati.riccati_backward(*args, 0.02)
    assert Ks.shape == (T, C, S) and ks.shape == (T, C)
    assert {k: v for k, v in riccati.launch_counts.items() if v} == {name: 1}
    assert riccati.backward_kernel_name() == name


def test_signatures_declare_the_new_entries():
    """Every library with a B1, B3 or B4 entry declares block_pass_form();
    the merge's library the passes launched alone; riccati.cu its backward
    form."""
    for pair, kinds in _build.PAIR_KERNELS.items():
        for kind in kinds:
            lib, _ = _build.pair_entry(pair, kind)
            if kind in ("rollout", "rollout_x0", "solve", "sample"):
                assert _build.SIGNATURES[lib]["block_pass_form"] == []
    merge = _build.SIGNATURES["flash_combine"]
    assert merge["block_pass_form"] == []
    assert len(merge["block_carry_pass"]) == 8 and len(merge["block_min_pass"]) == 5
    assert _build.SIGNATURES["riccati"]["riccati_backward_form"] == []
    assert {"block_carry_tiled_kernel", "block_min_warp_kernel",
            "riccati_backward_warp_kernel"} <= set(_build.launch_counts)
