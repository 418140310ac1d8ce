"""The tiled form of the flash merge on the CPU: its schedule, the form its
library reports and the launch counter of its wrapper.

``flash_combine_tiled_kernel`` (``csrc/flash_combine.cu``) spreads the T*C
columns over blocks of ``COLS``. Each block copies its columns of the carry
rows into shared memory, ``ROWS`` rows at a time (``tile[r][c]`` = row b0 +
r, column j0 + c), takes m = max m_b and d = sum d_b exp(m_b - m) by the
one-block kernel's 256-lane trees (thread l folds rows l, l + 256, ... in
order, then the tree halves the lanes), computes each row's scale exp(m_b -
m) once, and sums each column over the rows in order. ``tiled_merge``
emulates that schedule with NaN-filled tiles and the kernel's index
arithmetic; ``one_block_merge`` the one-block kernel's order
(``flash_combine_kernel``: thread l takes columns l, l + 256, ..., each
summed over all rows in order). The tests hold the two bit for bit at nb =
1, 30, 128, 129 and 300 rows and TC = 100, 200, 300 and 400 columns, with
flash rows, Tsallis rows (m_b = 0), a masked row (m_b = -1e30) and a NaN
row, and hold the tiled schedule against ``flash_combine_plain`` within the
card tests' tolerances (new mean rtol 1e-4 / atol 1e-5, baseline rtol 1e-6,
eta rtol 1e-5; num rtol 1e-5 and, as its sums cancel, an atol of 1e-6 times
the largest column's sum of |terms|). A NaN row keeps the kernels' semantics: its NaN
reaches eta, the mean and num, as in ``flash_combine_plain``; the max
skips it (fmaxf), where ``flash_combine_plain``'s ``amax`` would return
it, so the baseline is compared only without one. ``exp`` is a pure
function of its argument in both kernels, so the emulations take it once
per row. The kernel is held against the one-block build and the plain
version on the card (``tests/test_torch_cuda_kernels.py``, ``-k tiled``).
"""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch.ops import _build
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_sample_warp import _StubLibrary

LANES = 256  # kCombineThreads
COLS = 32  # kCombineCols
ROWS = 128  # kCombineRows
LAM = 1.3


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def merge_scalars(carry):
    """m_g and d_g as the 256 lanes take them: each lane folds its rows
    l, l + 256, ... in order, then the tree halves the lanes."""
    nb = carry.shape[0]
    m = torch.full((LANES,), fr._MASKED, dtype=torch.float32)
    for b0 in range(0, nb, LANES):  # lane l takes row b0 + l
        n = min(LANES, nb - b0)
        m[:n] = torch.fmax(m[:n], carry[b0:b0 + n, 0])
    off = LANES // 2
    while off:
        m[:off] = torch.fmax(m[:off], m[off:2 * off])
        off //= 2
    m_g = m[0]
    scale = torch.exp(carry[:, 0] - m_g)
    d = torch.zeros((LANES,), dtype=torch.float32)
    for b0 in range(0, nb, LANES):
        n = min(LANES, nb - b0)
        d[:n] = d[:n] + carry[b0:b0 + n, 1] * scale[b0:b0 + n]
    off = LANES // 2
    while off:
        d[:off] = d[:off] + d[off:2 * off]
        off //= 2
    return m_g, d[0], scale


def _outputs(a, m_g, d_g, T, C, lam, with_num):
    out = ((a / d_g).reshape(T, C), -lam * m_g, d_g)
    return out + (a.reshape(T, C),) if with_num else out


def one_block_merge(carry, T, C, lam, with_num=False):
    """flash_combine_kernel's order: every column over all rows in order."""
    m_g, d_g, scale = merge_scalars(carry)
    a = torch.zeros((T * C,), dtype=torch.float32)
    for b in range(carry.shape[0]):
        a = a + carry[b, 2:] * scale[b]
    return _outputs(a, m_g, d_g, T, C, lam, with_num)


def tiled_merge(carry, T, C, lam, with_num=False):
    """flash_combine_tiled_kernel's schedule: blocks of COLS columns, slabs
    of ROWS rows staged into a tile, one scale per row, each column's sum
    carried from slab to slab."""
    nb, ld = carry.shape
    TC = T * C
    flat = carry.reshape(-1)
    a = torch.full((TC,), float("nan"))
    scal = None
    for blk in range(-(-TC // COLS)):
        j0 = blk * COLS
        ncol = min(COLS, TC - j0)
        m_g, d_g, _ = merge_scalars(carry)
        if blk == 0:
            scal = (m_g, d_g)
        _equal((m_g, d_g), scal)  # every block takes the same scalars
        acc = torch.zeros((ncol,), dtype=torch.float32)
        for b0 in range(0, nb, ROWS):
            rows = min(ROWS, nb - b0)
            tile = torch.full((ROWS, COLS), float("nan"))
            e = torch.arange(rows * COLS)  # thread e % 256 copies element e
            r, c = e // COLS, e % COLS
            r, c = r[c < ncol], c[c < ncol]
            tile[r, c] = flat[(b0 + r) * ld + 2 + j0 + c]
            scale = torch.exp(carry[b0:b0 + rows, 0] - m_g)  # once per row
            for r in range(rows):
                acc = acc + tile[r, :ncol] * scale[r]
        a[j0:j0 + ncol] = acc
    return _outputs(a, scal[0], scal[1], T, C, lam, with_num)


def carry_rows(nb, TC, kind, seed):
    """nb carry rows of 2 + TC floats: flash rows (m_b, d_b in [1, 64],
    num_b), Tsallis rows (m_b = 0), and with ``kind`` "masked" / "nan" one
    masked row (m_b = -1e30, d_b = num_b = 0) / one NaN row among them."""
    rng = np.random.default_rng(seed)
    rows = np.empty((nb, 2 + TC), np.float32)
    rows[:, 0] = 0.0 if kind == "tsallis" else 3.0 * rng.normal(size=nb)
    rows[:, 1] = rng.uniform(1.0, 64.0, size=nb)
    rows[:, 2:] = rng.normal(size=(nb, TC)) * rows[:, 1:2]
    b = nb // 2
    if kind == "masked":
        rows[b] = 0.0
        rows[b, 0] = fr._MASKED
    elif kind == "nan":
        rows[b, 0] = np.nan
    return torch.from_numpy(rows)


def _equal(got, want):
    """Each pair bit for bit, NaN where the other is NaN."""
    for a, b in zip(got, want):
        assert torch.equal(a, b) or (torch.isnan(a).equal(torch.isnan(b))
                                     and torch.equal(a.nan_to_num(), b.nan_to_num()))


# (nb, TC, kind): a masked or NaN row sits beside others, so not at nb = 1
CASES = [(nb, TC, kind) for nb in (1, 30, 128, 129, 300) for TC in (100, 200, 300, 400)
         for kind in ("flash", "tsallis", "masked", "nan")
         if nb > 1 or kind in ("flash", "tsallis")]


@pytest.mark.parametrize("nb,TC,kind", CASES)
def test_tiled_merge_schedule_matches_the_one_block_order(nb, TC, kind):
    carry = carry_rows(nb, TC, kind, seed=nb + TC)
    C = 2 if TC % 2 == 0 else 1
    T = TC // C
    for with_num in (False, True):
        got = tiled_merge(carry, T, C, LAM, with_num)
        _equal(got, one_block_merge(carry, T, C, LAM, with_num))
    plain = fr.flash_combine_plain(carry, T, C, fr._f32(LAM), with_num=True)
    if kind == "nan":
        for a, b in ((got[0], plain[0]), (got[2], plain[2]), (got[3], plain[3])):
            assert torch.isnan(a).all() and torch.isnan(b).all()
        return
    np.testing.assert_allclose(got[0].numpy(), plain[0].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), plain[1].numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[2].numpy(), plain[2].numpy(), rtol=1e-5, atol=0)
    # num's sums cancel: an atol of 1e-6 of the largest column's sum of |terms|
    terms = (carry[:, 2:].abs() * torch.exp(carry[:, :1] - plain[1] / -fr._f32(LAM))).sum(0)
    np.testing.assert_allclose(got[3].numpy(), plain[3].numpy(), rtol=1e-5,
                               atol=1e-6 * float(terms.max()))


def test_the_merge_library_declares_its_form():
    assert _build.SIGNATURES["flash_combine"]["flash_combine_form"] == []
    assert {"flash_combine_kernel", "flash_combine_tiled_kernel"} <= set(_build.launch_counts)


class _MergeStub(_StubLibrary):
    """A merge library that reports ``form``."""

    def __getattr__(self, name):
        if name == "flash_combine_form":
            return lambda: self.form
        return super().__getattr__(name)


@pytest.mark.parametrize("with_num", [False, True])
@pytest.mark.parametrize("form", [0, 4])
def test_merge_wrapper_counts_the_reported_form(monkeypatch, form, with_num):
    lib = _MergeStub(form)
    monkeypatch.setattr(fr, "_lib", lambda name="flash_combine": lib)
    monkeypatch.setattr(fr, "_on_cpu", lambda t: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    fr.reset_launch_counts()
    out = fr.flash_combine(torch.zeros((3, 2 + 8 * 2)), 8, 2, LAM, with_num=with_num)
    assert len(out) == (4 if with_num else 3)
    name = {0: "flash_combine_kernel", 4: "flash_combine_tiled_kernel"}[form]
    assert {k: v for k, v in fr.launch_counts.items() if v} == {name: 1}
