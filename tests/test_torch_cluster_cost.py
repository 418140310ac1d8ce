"""The cluster form of the split cost pass on the CPU: its schedule, the form
its entries report and the launch counter of its wrapper.

``split_cost_cluster_kernel`` (``csrc/split_kernels.cuh``) runs a cluster
of ``CLUSTER`` = 8 CTAs for each block of 64 samples. The horizon is cut
into ``fr.COST_CHUNKS`` = 8 chunks of ceil(T / 8) steps and CTA r of the
cluster owns chunk r. A CTA walks its steps in
windows of ``WINDOW``: it stages the window's controls of its valid samples
into a padded buffer ``u_s[buf][i][e]`` (a sample's controls are contiguous
in U), computes every (step, sample) value of the window at once, and then
one thread per (sample, chunk) adds its chunk's values of the window in
step order into two sums and a trigger flag. Rank 0 reads every chunk's
sums from the CTA that owns it and adds them in chunk order with the prefix
OR of the flags, then the terminal cost (and B3's LR sum), J = (sum +
terminal) / T. The carry row takes m_b, the weights and d_b on rank 0, one
after the other in sample order, and its columns spread over the CTAs: CTA
r sums the columns of its own steps, each over the samples in order. The
block minimum is rank 0's ordered NaN-keeping minimum. The wrapper picks
the form of each launch (``fr.split_cost_form``), passes it to the entry
and counts the launch under that form's name.

``cluster_cost_pass`` emulates that schedule with NaN-filled buffers, the
kernel's index arithmetic and its order of additions; ``one_block_pass``
the earlier form (``split_cost_kernel``: a thread per (sample, chunk), thread
0 merging and making the carry's scalars, the block's threads all its
columns). The tests hold the cluster schedule bit for bit against the plain
versions (``split_sums_plain``, ``split_rollout_plain``,
``block_minima_plain``, ``fused_solve_split_plain``: costs, crash flags and
block minima) and against the earlier form (the carry rows too), for
AutoRally with ``ARStandardCost`` on a map that part of the samples reach,
the bicycle, the racer LSTM-steering pair and the double integrator's
circle cost; T = 150, 100, 31 and 7 (chunks without steps); K = 70 (a
second block of 6 samples); every epilogue with and without LR, and B3's
LR sum. ``block_carries_plain`` sums the carry rows in another order, so
the carry rows are held against it within rtol 1e-5 / atol 1e-6 (m_b
exactly). The kernel itself is held against the plain versions and the
earlier build on the card (``tests/test_torch_cuda_kernels.py``, ``-k
cluster``).
"""

import ctypes
import functools
import types

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch import GaussianDistribution
from mppi_generic_tpu_torch.costs import ARStandardCost, DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.maps import MapTexture2D
from mppi_generic_tpu_torch.models import (
    AutorallyNNDynamics,
    BicycleSlipDynamics,
    DoubleIntegratorDynamics,
    RacerDubinsElevationLSTMSteering,
)
from mppi_generic_tpu_torch.nn import FNN, LSTM
from mppi_generic_tpu_torch.ops import _build, fused_solve
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.utils.math_utils import true_div
from test_torch_sample_warp import _StubLibrary

NS = fr.BLOCK  # kBlockSamples
CHUNKS = fr.COST_CHUNKS  # kCostChunks
CLUSTER = 8  # kCostCluster, CTAs a 64-sample block in the port's build
WINDOW = 16  # kCostWindow
K, DT, LAM, ALPHA, GAIN_SUM = 70, 0.05, 1.3, 0.1, 0.37
PAIRS = ("di_circle", "ar_nn", "bicycle_ar", "racer_steering_ar")
MODES = ("costs", "costs+lr", "epilogue", "epilogue+lr", "tsallis", "tsallis+lr")


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _sparse_track(rng, resolution, density):
    """A 160^2 track map from (-4, -8) m on, 0.2 |N| but for a share
    ``density`` of boundary texels (value 2), so that whether a sample
    crashes, and at which step, depends on its path."""
    track = (0.2 * np.abs(rng.normal(size=(160, 160)))).astype(np.float32)
    track[rng.uniform(size=track.shape) < density] = 2.0
    return MapTexture2D(track, origin=(-4.0, -8.0, 0.0), resolution=resolution)


@functools.lru_cache(maxsize=None)
def _parts(pair):
    """(dynamics, cost, x0, control std) of a pair with a split cost entry;
    the AutoRally costs' maps crash part of the samples."""
    if pair == "di_circle":
        return (DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                torch.tensor([2.0, 0.05, -0.1, 1.0]), [0.8, 1.3])
    rng = np.random.default_rng(0)
    if pair == "ar_nn":
        dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=0.5))
        return (dyn, ARStandardCost(costmap=_sparse_track(rng, 0.1, 0.01)),
                torch.tensor([0.0, 0.0, 0.3, 0.0, 3.0, 0.0, 0.0]), [0.3, 0.5])
    if pair == "bicycle_ar":
        x0 = torch.zeros(10)
        x0[5] = 3.0
        cost = ARStandardCost(costmap=_sparse_track(rng, 0.25, 0.01),
                              output_indices=(0, 1, 2, 8, 5, 6))
        return BicycleSlipDynamics.create(), cost, x0, [0.3, 0.5]
    warm = {n: 0.3 * rng.normal(size=16) for n in ("warm_hidden", "warm_cell")}
    lstm = LSTM.create(4, 16, [20, 16, 1], seed=0, scale=0.5)
    elev = MapTexture2D((0.3 * rng.normal(size=(64, 64))).astype(np.float32),
                        origin=(-8.0, -8.0, 0.0), resolution=0.25)
    dyn = RacerDubinsElevationLSTMSteering(lstm, elev, **warm)
    x0 = torch.zeros(9)
    x0[0], x0[1] = 3.0, 0.2
    cost = ARStandardCost(costmap=_sparse_track(rng, 0.1, 0.01),
                          output_indices=(2, 3, 5, 6, 0, 1))
    return dyn, cost, x0, [0.3, 0.5]


def _lr_params(T, C, std, with_lr, seed=3):
    """(mean, sigma) of the samples and B1's LR tables (or None)."""
    rng = np.random.default_rng(seed + T)
    mean = torch.from_numpy((0.2 * rng.normal(size=(T, C))).astype(np.float32))
    sigma = torch.tensor([std], dtype=torch.float32).expand(T, C).contiguous()
    lr = (mean, sigma, torch.full((C,), 0.5), LAM, ALPHA, 0.9 * K) if with_lr else None
    return mean, sigma, lr


@functools.lru_cache(maxsize=None)
def _rollout_inputs(pair, T):
    """(U (K, T, C), Y (K, T, O)): clamped samples and the dynamics pass's
    outputs, as the plain version steps them."""
    dyn, _, x0, std = _parts(pair)
    C = dyn.CONTROL_DIM
    mean, sigma, _ = _lr_params(T, C, std, False)
    g = torch.Generator().manual_seed(T)
    U = mean + sigma * torch.randn((K, T, C), generator=g)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    return U, fr.split_outputs_plain(dyn, x0, U, DT)


def chunk_steps(ch, T):
    """Steps [t0, t1) of chunk ``ch``: min(T, ch Tc), min(T, t0 + Tc)."""
    Tc = -(-T // CHUNKS)
    t0 = min(T, ch * Tc)
    return t0, min(T, t0 + Tc)


def cta_steps(rank, T):
    """Steps [t_lo, t_hi) of CTA ``rank``'s chunks."""
    per = CHUNKS // CLUSTER
    Tc = -(-T // CHUNKS)
    return min(T, rank * per * Tc), min(T, (rank + 1) * per * Tc)


def nan_min(a, b):
    """nan_min of csrc/mppi_common.cuh: a if a < b or a is NaN, else b."""
    return torch.where((a < b) | torch.isnan(a), a, b)


def block_scalars(J, n_valid, lam_w):
    """The carry's m_b (a max in sample order over 64 slots, kMasked past
    the valid samples), the 64 weights exp(s - m_b) and d_b (their sum in
    sample order), as thread 0 of rank 0 takes them."""
    s = torch.full((NS,), fr._MASKED, dtype=torch.float32)
    s[:n_valid] = true_div(-J, lam_w)
    m = s[0]
    for i in range(1, NS):
        m = torch.fmax(m, s[i])
    w = torch.exp(s - m)
    d = torch.zeros((), dtype=torch.float32)
    for i in range(NS):
        d = d + w[i]
    return m, w, d


def column_sums(w, X, n_valid, j0, j1):
    """Columns j0 .. j1 - 1 of a carry row: acc + w_i X_i in sample order."""
    acc = torch.zeros((j1 - j0,), dtype=torch.float32)
    for i in range(n_valid):
        acc = acc + w[i] * X[i, j0:j1]
    return acc


def block_min(J, n_valid):
    """Rank 0's block minimum: kMinPad past the valid samples, NaN kept."""
    pad = torch.full((NS,), fr._MIN_PAD, dtype=torch.float32)
    pad[:n_valid] = J
    mn = pad[0]
    for s in range(1, NS):
        mn = nan_min(mn, pad[s])
    return mn


def _epilogue_out(epilogue, nb, TC):
    if epilogue == fr.EPI_EXP:
        return torch.full((nb, 2 + TC), float("nan"))
    return torch.full((nb,), float("nan")) if epilogue == fr.EPI_MIN else None


def cluster_cost_pass(cost, Y, U, lr_params=None, lr_sum=None, lr_sum_gain=0.0,
                      lam_w=1.0, epilogue=fr.EPI_NONE):
    """The cluster form's schedule: (costs (K,), crash (K,) int32, out), out
    the carry rows, the block minima or None. Y is (K, T, O)."""
    Kr, T, C = U.shape
    v0, v1, trig = fr.split_step_values_plain(cost, Y, U, lr_params)
    sticky = trig is not None
    per = CHUNKS // CLUSTER
    nb = -(-Kr // NS)
    term = cost.terminal_cost(Y[:, -1].T)
    flat = U.reshape(-1)
    nan = float("nan")
    costs = torch.full((Kr,), nan)
    crash = torch.full((Kr,), -1, dtype=torch.int32)
    out = _epilogue_out(epilogue, nb, T * C)
    for blk in range(nb):
        base = blk * NS
        n_valid = min(NS, Kr - base)
        shared = []  # each CTA's (sel, all1, fired) of its chunks
        for rank in range(CLUSTER):
            t_lo, t_hi = cta_steps(rank, T)
            sel = torch.zeros((per, n_valid))
            all1 = torch.zeros((per, n_valid))
            fired = torch.zeros((per, n_valid), dtype=torch.bool)
            u_s = torch.full((2, NS, WINDOW * C + 1), nan)
            for w, tw0 in enumerate(range(t_lo, t_hi, WINDOW)):
                n, buf = min(WINDOW, t_hi - tw0), w % 2
                u_s[buf] = nan
                for i in range(n_valid):  # a warp a sample, element e of its run
                    src = ((base + i) * T + tw0) * C
                    u_s[buf, i, :n * C] = flat[src:src + n * C]
                v0_s = torch.full((WINDOW, NS), nan)
                v1_s = torch.full((WINDOW, NS), nan)
                trig_s = torch.zeros((WINDOW, NS), dtype=torch.bool)
                for tl in range(n):  # every (step, sample) of the window at once
                    t = tw0 + tl
                    u_read = u_s[buf, :n_valid, tl * C:(tl + 1) * C]
                    assert torch.equal(u_read, U[base:base + n_valid, t]), "staged controls"
                    v0_s[tl, :n_valid] = v0[base:base + n_valid, t]
                    if sticky:
                        v1_s[tl, :n_valid] = v1[base:base + n_valid, t]
                        trig_s[tl, :n_valid] = trig[base:base + n_valid, t]
                for lc in range(per):  # a thread per (sample, chunk), steps in order
                    s_t0, s_t1 = chunk_steps(rank * per + lc, T)
                    for t in range(max(s_t0, tw0), min(s_t1, tw0 + n)):
                        tl = t - tw0
                        if sticky:
                            fired[lc] = fired[lc] | trig_s[tl, :n_valid]
                            all1[lc] = all1[lc] + v1_s[tl, :n_valid]
                            sel[lc] = sel[lc] + torch.where(fired[lc], v1_s[tl, :n_valid],
                                                            v0_s[tl, :n_valid])
                        else:
                            sel[lc] = sel[lc] + v0_s[tl, :n_valid]
            shared.append((sel, all1, fired))
        # rank 0: the chunks in order, each from the CTA that owns it
        acc = torch.zeros((n_valid,))
        crashed = torch.zeros((n_valid,), dtype=torch.bool)
        for ch in range(CHUNKS):
            sel, all1, fired = shared[ch // per]
            acc = acc + torch.where(crashed, all1[ch % per], sel[ch % per])
            crashed = crashed | fired[ch % per]
        ks = slice(base, base + n_valid)
        acc = acc + term[ks]
        if lr_sum is not None:
            acc = acc + lr_sum_gain * lr_sum[ks]
        J = true_div(acc, T)
        costs[ks], crash[ks] = J, crashed.to(torch.int32)
        if epilogue == fr.EPI_EXP:
            m, w, d = block_scalars(J, n_valid, lam_w)
            out[blk, 0], out[blk, 1] = m, d
            X = U[ks].reshape(n_valid, T * C)
            for rank in range(CLUSTER):  # each CTA its own steps' columns
                t_lo, t_hi = cta_steps(rank, T)
                out[blk, 2 + t_lo * C:2 + t_hi * C] = column_sums(w, X, n_valid, t_lo * C,
                                                                  t_hi * C)
        elif epilogue == fr.EPI_MIN:
            out[blk] = block_min(J, n_valid)
    return costs, crash, out


def one_block_pass(cost, Y, U, lr_params=None, lr_sum=None, lr_sum_gain=0.0, lam_w=1.0,
                   epilogue=fr.EPI_NONE):
    """The earlier form's schedule (split_cost_kernel): the chunk sums of
    split_sums_plain, the carry's scalars and then all its columns."""
    Kr, T, C = U.shape
    acc, crash = fr.split_sums_plain(*fr.split_step_values_plain(cost, Y, U, lr_params))
    acc = acc + cost.terminal_cost(Y[:, -1].T)
    if lr_sum is not None:
        acc = acc + lr_sum_gain * lr_sum
    costs = true_div(acc, T)
    nb = -(-Kr // NS)
    out = _epilogue_out(epilogue, nb, T * C)
    for blk in range(nb):
        ks = slice(blk * NS, min(Kr, (blk + 1) * NS))
        n_valid = ks.stop - ks.start
        if epilogue == fr.EPI_EXP:
            m, w, d = block_scalars(costs[ks], n_valid, lam_w)
            out[blk, 0], out[blk, 1] = m, d
            out[blk, 2:] = column_sums(w, U[ks].reshape(n_valid, T * C), n_valid, 0, T * C)
        elif epilogue == fr.EPI_MIN:
            out[blk] = block_min(costs[ks], n_valid)
    return costs, crash, out


def _equal(a, b, what):
    if a is None:
        assert b is None, what
        return
    assert torch.equal(a, b), f"{what}: max |diff| {float((a - b).abs().max())}"


def _check_carry(carry, costs, U, lam):
    want = fr.block_carries_plain(costs, U, lam)
    assert torch.equal(carry[:, 0], want[:, 0])
    np.testing.assert_allclose(carry.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("T", [150, 100, 31, 7])
@pytest.mark.parametrize("pair", PAIRS)
def test_cluster_cost_schedule_matches_the_plain_versions(pair, T, mode):
    dyn, cost, x0, std = _parts(pair)
    U, Y = _rollout_inputs(pair, T)
    _, _, lr = _lr_params(T, dyn.CONTROL_DIM, std, mode.endswith("+lr"))
    epilogue = {"costs": fr.EPI_NONE, "epilogue": fr.EPI_EXP,
                "tsallis": fr.EPI_MIN}[mode.split("+")[0]]
    costs, crash, out = cluster_cost_pass(cost, Y, U, lr, lam_w=LAM, epilogue=epilogue)
    acc, pcrash = fr.split_sums_plain(*fr.split_step_values_plain(cost, Y, U, lr))
    _equal(costs, true_div(acc + cost.terminal_cost(Y[:, -1].T), T), "costs")
    _equal(crash, pcrash, "crash")
    pc, pcrash = fr.split_rollout_plain(dyn, cost, x0, U, DT, lr)
    _equal(costs, pc, "costs against split_rollout_plain")
    _equal(crash, pcrash, "crash against split_rollout_plain")
    _equal(out, one_block_pass(cost, Y, U, lr, lam_w=LAM, epilogue=epilogue)[2],
           "epilogue against the earlier form")
    if epilogue == fr.EPI_EXP:
        _check_carry(out, costs, U, LAM)
    elif epilogue == fr.EPI_MIN:
        _equal(out, fr.block_minima_plain(pc), "block minima")


def test_the_maps_crash_part_of_the_samples():
    """At T = 31 each AutoRally-cost pair has samples that crash at
    different steps and samples that do not, so the prefix OR decides."""
    for pair in PAIRS[1:]:
        _, cost, _, _ = _parts(pair)
        U, Y = _rollout_inputs(pair, 31 if pair != "racer_steering_ar" else 100)
        crash = fr.split_sums_plain(*fr.split_step_values_plain(cost, Y, U))[1]
        assert 0 < int(crash.sum()) < K, pair


@pytest.mark.parametrize("T", [100, 7])
@pytest.mark.parametrize("pair", PAIRS)
def test_cluster_cost_schedule_takes_b3s_lr_sum(pair, T):
    """B3's split form: the samples and LR sums of the plain dynamics pass,
    the cost pass with the LR sum, against fused_solve_split_plain."""
    dyn, cost, x0, std = _parts(pair)
    C = dyn.CONTROL_DIM
    samp = GaussianDistribution.create(std_dev=std, pure_noise_percentage=0.1)
    mean = _lr_params(T, C, std, False)[0]
    seed = torch.tensor(11, dtype=torch.int32)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_split_plain(*args, iteration=0,
                                                                 optimization_stride=2)
    U, lr = fused_solve._samples_plain(dyn, samp, mean, seed, K, 0, 2, None)
    Y = fr.split_outputs_plain(dyn, x0, U, DT)
    gain = fr._lr_gain(LAM, ALPHA)
    costs, crash, carry = cluster_cost_pass(cost, Y, U, None, lr, gain, LAM, fr.EPI_EXP)
    _equal(U, pU, "U")
    _equal(costs, pc, "costs")
    _equal(crash, pcrash, "crash")
    _equal(carry, one_block_pass(cost, Y, U, None, lr, gain, LAM, fr.EPI_EXP)[2], "carry")
    _check_carry(carry, costs, U, LAM)
    np.testing.assert_allclose(carry.numpy(), pcarry.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T", [150, 31, 7])
def test_the_cluster_keeps_the_earlier_forms_bits(T):
    """The cluster of 8 CTAs: the same outputs as the earlier form."""
    dyn, cost, _, std = _parts("ar_nn")
    U, Y = _rollout_inputs("ar_nn", T)
    lr = _lr_params(T, dyn.CONTROL_DIM, std, True)[2]
    for epilogue in (fr.EPI_EXP, fr.EPI_MIN):
        got = cluster_cost_pass(cost, Y, U, lr, lam_w=LAM, epilogue=epilogue)
        want = one_block_pass(cost, Y, U, lr, lam_w=LAM, epilogue=epilogue)
        for a, b, what in zip(got, want, ("costs", "crash", "epilogue")):
            _equal(a, b, what)


@pytest.mark.parametrize("T", [1, 3, 7, 8, 9, 31, 100, 150, 257])
def test_chunks_windows_and_columns_cover_the_horizon(T):
    """Each step lies in one chunk, that chunk's CTA's range and one of its
    windows; the CTAs' columns cover the carry row once."""
    per = CHUNKS // CLUSTER
    owner = {}
    for ch in range(CHUNKS):
        t0, t1 = chunk_steps(ch, T)
        lo, hi = cta_steps(ch // per, T)
        assert lo <= t0 <= t1 <= hi
        for t in range(t0, t1):
            assert t not in owner
            owner[t] = ch
    assert sorted(owner) == list(range(T))
    covered = []
    for rank in range(CLUSTER):
        lo, hi = cta_steps(rank, T)
        windows = [t for tw0 in range(lo, hi, WINDOW) for t in range(tw0, min(hi, tw0 + WINDOW))]
        assert windows == list(range(lo, hi))
        covered += list(range(lo * 2, hi * 2))  # C = 2
    assert covered == list(range(2 * T))


def test_every_split_cost_entry_declares_its_form():
    pairs = set()
    for pair in _build.PAIR_KERNELS:
        entry = _build.pair_entry(pair, "split_cost")
        if entry is not None:
            lib, fn = entry
            assert _build.SIGNATURES[lib][fn + "_form"] == []
            assert _build.SIGNATURES[lib][fn][-2:] == [ctypes.c_int, ctypes.c_void_p]
            pairs.add(pair)
    assert "ar_nn" in pairs and "di_robust" in pairs
    assert {"split_cost_kernel", "split_cost_cluster_kernel"} <= set(_build.launch_counts)


class _RecordingStub(_StubLibrary):
    """A split library whose entries record their arguments; its
    ``<entry>_form()`` reports ``form``."""

    def __init__(self, form):
        super().__init__(form)
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_form"):
            return super().__getattr__(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recording_stub(monkeypatch):
    """The wrappers on a recording stub of the port's build (the cluster
    form beside the one-block form) on a card of 132 multiprocessors, CPU
    tensors taking the launch path."""
    lib = _RecordingStub(3)
    monkeypatch.setattr(fr, "_lib", lambda name="flash_combine": lib)
    monkeypatch.setattr(fr, "_on_cpu", lambda t: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    fr._cost_form.cache_clear()
    yield lib
    fr._cost_form.cache_clear()


def _launch_cost_pass(pair, K_, T, **kw):
    dyn, cost, _, _ = _parts(pair)
    fr.reset_launch_counts()
    fr.split_cost_cuda(dyn, cost, torch.zeros((T, dyn.OUTPUT_DIM, K_)), torch.zeros((K_, T, 2)),
                       epilogue=fr.EPI_EXP, lam_w=LAM, **kw)
    return {k: v for k, v in fr.launch_counts.items() if v}


# (pair, K, T, the form picked) on 132 multiprocessors: the cluster form up to
# 49 blocks (8 CTAs each, three a multiprocessor), for AutoRally's dual cost
# at any T, for the others' at chunks of 8 steps or more (T >= 57)
RULE_CASES = [("di_circle", 100, 100, 3), ("di_circle", 3136, 100, 3),
              ("di_circle", 3137, 100, 0), ("di_circle", 8192, 100, 0),
              ("di_circle", 100, 57, 3), ("di_circle", 100, 56, 0), ("di_circle", 576, 48, 0),
              ("ar_nn", 100, 8, 3), ("ar_nn", 3136, 48, 3), ("ar_nn", 3137, 150, 0)]


@pytest.mark.parametrize("pair,K_,T,form", RULE_CASES)
def test_split_cost_wrapper_passes_and_counts_the_form_it_picks(recording_stub, pair, K_, T,
                                                                form):
    name = "split_cost" + fr._FORM_SUFFIX[form]
    assert _launch_cost_pass(pair, K_, T) == {name: 1}
    fn = f"split_cost_{pair}"
    assert fr.entry_counts == {fn: 1}
    (called, args), = recording_stub.calls
    assert called == fn and args[-2] == form
    assert fr.split_cost_kernel_name(_build.pair_entry(pair, "split_cost"), None, K_, T,
                                     pair == "ar_nn") == name


@pytest.mark.parametrize("form", [0, 3])
def test_split_cost_wrapper_takes_the_form_it_is_given(recording_stub, form):
    assert _launch_cost_pass("di_circle", 576, 48, form=form) == {
        "split_cost" + fr._FORM_SUFFIX[form]: 1}
    assert recording_stub.calls[0][1][-2] == form


def test_an_earlier_build_takes_the_one_block_form_at_every_K(recording_stub):
    recording_stub.form = 0
    assert _launch_cost_pass("ar_nn", 100, 150) == {"split_cost_kernel": 1}
    assert recording_stub.calls[0][1][-2] == 0


def test_split_choices_forced_against_auto_are_counted():
    """resolve_split counts a choice forced against AUTO_SPLIT by the form
    forced; AUTO's own choice, asked for or forced, counts nothing."""
    di = _parts("di_circle")[:2]  # AUTO: the combined kernel
    ar = _parts("ar_nn")[:2]  # AUTO: B1's split form, B3's combined kernel
    fr.reset_launch_counts()
    assert not fr.resolve_split(*di, None) and not fr.resolve_split(*di, False)
    assert fr.resolve_split(*ar, None) and fr.resolve_split(*ar, True, "rollout_x0")
    assert not fr.resolve_split(*ar, None, "solve") and not fr.resolve_split(*ar, False, "solve")
    assert _build.forced_routes == {}
    assert fr.resolve_split(*di, True)
    assert not fr.resolve_split(*ar, False) and fr.resolve_split(*ar, True, "solve")
    assert _build.forced_routes == {"split": 2, "combined": 1}
    fr.reset_launch_counts()
    assert _build.forced_routes == {}
