"""The chunk prologue of B1's warp form and its epilogue passes, on the CPU.

B1's warp form (``rollout_costs_warp_kernel``, ``csrc/rollout_kernel.cuh``)
runs one warp per sample of the network pairs (AutoRally, the racer LSTMs):
blocks of the model's ``kWarpSamples`` warps, sample k = block * kWarpSamples
+ warp. Its inputs depend on no state, so each chunk of 32 steps starts with
a prologue spread over the lanes: lane j of chunk q reads step 32 q + j of
its sample's U row and, with the LR term, makes that step's scaled term
gain sum_c coeff_c mu (mu - 2 u_c) / (s_c s_c) (mu = 0 for a sample of the
pure-noise tail); lanes with t >= T make nothing and keep the last chunk's
values. Step t takes lane t mod 32's controls and term by shuffles, and
every lane adds cost = running + lr_t into acc, one step at a time: J =
(acc + terminal) / T. With one x0 per sample each lane reads row k of x0.
The epilogue rows stay rows of 64 samples, written after the warp kernel
by the passes of ``csrc/block_pass.cuh``: the carry pass for the exp carry,
the minima pass for Tsallis pass 1 (1e30 past K). ``carry_pass`` and
``min_pass`` below follow the earlier form of those passes,
``block_carry_kernel`` over (64-sample block, 64-column tile) and
``block_min_kernel`` (``write_block_min``: a halving tree of ``nan_min``);
``tests/test_torch_block_pass.py`` follows the tiled and warp forms.

``warp_rollout`` mirrors that index map and those float32 operations (the
network step and the costs through the model's plain step, whose warp form
other tests hold bit for bit), ``carry_pass`` and ``min_pass`` the two
passes, and the tests hold them bit for bit against the plain versions
(``fr.rollout_costs_plain``, ``fr.block_carries_ordered``,
``fr.block_minima_plain``): AutoRally from one x0 and from one x0 per
sample, the racer LSTM-steering model from its warm (h, c) on its elevation
and track maps; T = 150, 100 and 31 (each ending in a partial chunk); K =
70 with a pure-noise tail (a partial last block of warps and of 64
samples); every epilogue mode, with and without the LR term. The wrappers
count the warp form's epilogue pass, and one case holds the port's B1 (the
plain version on the CPU) against the JAX package's Pallas kernel in
interpret mode. The kernels themselves are held against the plain versions
and the one-thread build on the card (``tests/test_torch_cuda_kernels.py``,
``-k rollout_warp``).
"""

import functools

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_cluster_cost import _parts as _cost_parts
from test_torch_sample_warp import stub_form  # noqa: F401  (a fixture)

LANES = 32
K, DT, LAM, ALPHA, P_PURE = 70, 0.02, 1.3, 0.1, 0.1
# samples (warps) per block of the warp form: kWarpSamples in csrc/
WARP_SAMPLES = {"ar_nn": 4, "ar_nn_x0": 4, "racer_steering_ar": 8}
EPILOGUES = {"none": fr.EPI_NONE, "exp": fr.EPI_EXP, "min": fr.EPI_MIN}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def _model(pair):
    """(dynamics, cost, x0) on the CPU, the models of the split cost pass's
    tests (maps that crash part of the samples; the racer steering model
    with its warm (h, c)): x0 (K, S) for "ar_nn_x0"."""
    dyn, cost, x0, _ = _cost_parts("ar_nn" if pair == "ar_nn_x0" else pair)
    if pair == "ar_nn_x0":
        rng = np.random.default_rng(5)
        x0 = (x0 + torch.from_numpy(
            (0.2 * rng.normal(size=(K, x0.numel()))).astype(np.float32))).contiguous()
    return dyn, cost, x0


@functools.lru_cache(maxsize=None)
def _inputs(T):
    """U (K, T, 2) and B1's LR tables (mean, sigma, coeff, lam, alpha, the
    pure-noise threshold (1 - p) K)."""
    rng = np.random.default_rng(T)
    mean = torch.from_numpy((0.3 * rng.normal(size=(T, 2))).astype(np.float32))
    sigma = torch.from_numpy((0.3 + 0.3 * rng.random(size=(T, 2))).astype(np.float32))
    U = (mean + sigma * torch.from_numpy(rng.normal(size=(K, T, 2)).astype(np.float32)))
    thresh = float((np.float32(1) - np.float32(P_PURE)) * np.float32(K))
    return U.clamp(-0.9, 0.9).contiguous(), (mean, sigma, torch.tensor([0.5, 1.0]), LAM,
                                             ALPHA, thresh)


def chunk_prologue(U, lr, T):
    """The lanes' registers at each step: for step t, (controls (K, C), LR
    term (K,)) as lane t mod 32 of chunk t // 32 made them, each lane keeping
    its last chunk's values where its step of this chunk is >= T. The LR
    term by rollout_lr_term's float32 operations, or None without LR."""
    C = U.shape[2]
    v_lane = torch.zeros((K, LANES, C + 1))  # the warp's registers, zeros at the start
    gain = fr._lr_gain(lr[3], lr[4]) if lr is not None else None
    pure = torch.arange(K, dtype=torch.float32) >= fr._f32(lr[5]) if lr is not None else None
    steps = []
    for t in range(T):
        j = t % LANES
        if j == 0:
            for lane in range(LANES):
                ts = t + lane
                if ts >= T:  # the lanes past T make nothing
                    continue
                u = U[:, ts]  # the coalesced read of the chunk
                v_lane[:, lane, :C] = u
                if lr is not None:
                    mean, sigma, coeff = lr[:3]
                    term = torch.zeros((K,))
                    for c in range(C):
                        mu = torch.where(pure, 0.0, mean[ts, c])
                        sg = sigma[ts, c]
                        term = term + coeff[c] * mu * (mu - 2.0 * u[:, c]) / (sg * sg)
                    v_lane[:, lane, C] = gain * term
        steps.append((v_lane[:, j, :C].clone(),
                      v_lane[:, j, C].clone() if lr is not None else None))
    return steps


def warp_rollout(pair, T, with_lr, lr_apart=False):
    """B1's warp form: (costs, crash) of every sample, by warps of blocks;
    cost = running + lr_t added into acc step by step (with ``lr_apart``
    B3's order instead: the terms summed apart and added at the end)."""
    dyn, cost, x0 = _model(pair)
    U, lr = _inputs(T)
    lr = lr if with_lr else None
    NW = WARP_SAMPLES[pair]
    ks = [b * NW + w for b in range(-(-K // NW)) for w in range(NW)]
    assert [k for k in ks if k < K] == list(range(K))  # each warp past K leaves
    S = dyn.STATE_DIM
    flat = x0.reshape(-1)
    # x[i] = X0 ? x0[k * S + i] : x0[i], each lane of warp k
    x = torch.stack([flat[torch.arange(K) * S + i] if x0.dim() == 2
                     else flat[i].expand(K) for i in range(S)])
    rec = fr.broadcast_rec(dyn.init_recurrent_state(), K)
    crash = torch.zeros((K,), dtype=torch.int32)
    acc = torch.zeros((K,))
    lr_sum = torch.zeros((K,))
    y = None
    for t, (u, lr_t) in enumerate(chunk_prologue(U, lr, T)):
        x, y, rec = dyn.kernel_step_recurrent(x, rec, u.T, float(t), DT)
        c, crash = cost.running_cost(y, u.T, t, crash)
        if lr_t is not None and lr_apart:
            lr_sum = lr_sum + lr_t
        elif lr_t is not None:
            c = c + lr_t
        acc = acc + c
    J = acc + cost.terminal_cost(y)
    return fr.true_div(J + lr_sum if lr_apart else J, T), crash


def _tree(v, op):
    """A block reduction's halving tree over rows of 64: red[i] = op(red[i],
    red[i + off]) for off = 32, 16, ..., 1; the result in red[0]."""
    off = v.shape[1] // 2
    while off:
        v = torch.cat([op(v[:, :off], v[:, off:2 * off]), v[:, off:]], dim=1)
        off //= 2
    return v[:, 0]


def carry_pass(costs, X, lam, block=fr.BLOCK):
    """The earlier block_carry_kernel over (64-sample block, 64-column
    tile): s = -J / lam (-1e30 past K), m_b and d_b by the halving trees,
    w = exp(s - m_b), then each tile's columns summed over the block's
    valid samples left to right; (nb, 2 + TC) in the kernel's row
    layout."""
    K_, T, C = X.shape
    TC = T * C
    nb = -(-K_ // block)
    lam = torch.tensor(fr._f32(lam))
    s = torch.full((nb * block,), fr._MASKED)
    s[:K_] = -costs / lam
    s = s.reshape(nb, block)
    m = _tree(s.clone(), torch.fmax)
    w = torch.exp(s - m[:, None])
    d = _tree(w.clone(), torch.add)
    rows = torch.full((nb, 2 + TC), float("nan"))
    rows[:, 0], rows[:, 1] = m, d
    Xf = X.reshape(K_, TC)
    n_tiles = -(-TC // block)
    for b in range(nb):
        n_valid = min(block, K_ - b * block)
        for tile in range(n_tiles):
            cols = torch.arange(tile * block, min(TC, (tile + 1) * block))
            a = torch.zeros(cols.numel())
            for i in range(n_valid):
                a = a + w[b, i] * Xf[b * block + i, cols]
            rows[b, 2 + cols] = a
    return rows


def _nan_min(a, b):
    """nan_min (csrc/mppi_common.cuh): (a < b || a != a) ? a : b."""
    return torch.where((a < b) | torch.isnan(a), a, b)


def min_pass(costs, block=fr.BLOCK):
    """The earlier block_min_kernel: per block of 64, the halving tree of
    nan_min over the valid costs and 1e30 past K."""
    K_ = costs.shape[0]
    nb = -(-K_ // block)
    v = torch.full((nb * block,), fr._MIN_PAD)
    v[:K_] = costs
    return _tree(v.reshape(nb, block), _nan_min)


@functools.lru_cache(maxsize=None)
def _runs(pair, T, with_lr):
    """(the warp form's (costs, crash), the plain version's)."""
    dyn, cost, x0 = _model(pair)
    U, lr = _inputs(T)
    plain = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr if with_lr else None)
    return warp_rollout(pair, T, with_lr), plain


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("with_lr", [False, True])
@pytest.mark.parametrize("T", [150, 100, 31])
@pytest.mark.parametrize("pair", ["ar_nn", "ar_nn_x0", "racer_steering_ar"])
def test_warp_rollout_equals_the_plain_rollout(pair, T, with_lr, epilogue):
    (wc, wcrash), (pc, pcrash) = _runs(pair, T, with_lr)
    assert bool(torch.isfinite(pc).all())
    assert torch.equal(wc, pc)
    assert torch.equal(wcrash, pcrash)
    U, _ = _inputs(T)
    if epilogue == "exp":
        got = carry_pass(wc, U, LAM)
        assert torch.equal(got, fr.block_carries_ordered(pc, U, fr._f32(LAM)))
        np.testing.assert_allclose(got.numpy(), fr.block_carries_plain(pc, U, fr._f32(LAM)),
                                   rtol=1e-5, atol=1e-5)
    elif epilogue == "min":
        assert torch.equal(min_pass(wc), fr.block_minima_plain(pc))


@pytest.mark.parametrize("pair", ["ar_nn", "ar_nn_x0", "racer_steering_ar"])
def test_maps_crash_some_samples(pair):
    """The track maps crash some samples, so the sticky crash flags are
    worth comparing."""
    (_, crash), _ = _runs(pair, 150, True)
    assert 0 < int(crash.sum()) < K


def test_lr_term_goes_into_each_step_before_the_sum():
    """The term added into each step's cost before acc gives the plain
    version's floats; the terms summed apart and added at the end (B3's
    order) do not, so the comparison above would catch that order."""
    (wc, _), (pc, _) = _runs("ar_nn", 150, True)
    apart, _ = warp_rollout("ar_nn", 150, True, lr_apart=True)
    assert torch.equal(wc, pc)
    assert not torch.equal(apart, pc)


@pytest.mark.parametrize("K_", [1920, 1900, 1901, 130, 3])
def test_passes_cover_partial_blocks(K_):
    """The carry and min passes at the paths' K (a partial last block of
    64 at 1900 and 1901) against the plain rows and minima, with a NaN cost
    propagated by the min tree."""
    g = torch.Generator().manual_seed(K_)
    costs = 100.0 * torch.rand((K_,), generator=g)
    X = torch.randn((K_, 5, 2), generator=g)
    assert torch.equal(carry_pass(costs, X, LAM), fr.block_carries_ordered(costs, X,
                                                                           fr._f32(LAM)))
    assert torch.equal(min_pass(costs), fr.block_minima_plain(costs))
    costs[K_ // 2] = float("nan")
    got, want = min_pass(costs), fr.block_minima_plain(costs)
    assert torch.equal(got.isnan(), want.isnan()) and bool(got.isnan().any())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


# the launches of B1 by its form and epilogue mode: 1 the warp form and its
# epilogue pass, 2 the staged form, 0 the one-thread kernel
ROLLOUT_FORM_LAUNCHES = {
    (1, fr.EPI_NONE): {"rollout_costs_warp_kernel": 1},
    (1, fr.EPI_EXP): {"rollout_costs_warp_kernel": 1, "block_carry_tiled_kernel": 1},
    (1, fr.EPI_MIN): {"rollout_costs_warp_kernel": 1, "block_min_warp_kernel": 1},
    (2, fr.EPI_EXP): {"rollout_costs_staged_kernel": 1},
    (0, fr.EPI_MIN): {"rollout_costs_kernel": 1},
}


@pytest.mark.parametrize("x0_rows", [0, K])
@pytest.mark.parametrize("form,epilogue", list(ROLLOUT_FORM_LAUNCHES))
def test_rollout_wrapper_counts_the_warp_forms_pass(stub_form, form, epilogue, x0_rows):
    """The wrapper counts the kernel its entry reports and, after the warp
    form's launch, the epilogue pass (block_carry_tiled_kernel,
    block_min_warp_kernel) under its own name."""
    stub_form(form)
    dyn, cost, x0 = _model("ar_nn")
    x0 = x0.expand(x0_rows, -1).contiguous() if x0_rows else x0
    U = torch.zeros((K, 8, 2))
    fr.reset_launch_counts()
    fr._rollout_cuda(dyn, cost, x0, U, DT, None, epilogue, LAM)
    assert {k: v for k, v in fr.launch_counts.items() if v} == ROLLOUT_FORM_LAUNCHES[
        (form, epilogue)]
    assert fr.entry_counts == {"rollout_costs_x0_ar_nn" if x0_rows else "rollout_costs_ar_nn": 1}


def test_x0_b1_matches_the_jax_kernel():
    """AutoRally's B1 from one x0 per sample with the LR term and the pure-
    noise tail, the port's entry (its plain version on the CPU) against the
    JAX package's ``fused_rollout_costs`` in interpret mode with a (K, S) x0:
    the configuration of tests/test_torch_autorally_kernels.py (K = 256, T =
    16, the 6-32-32-4 network at scale 1, the 32^2 map with its hot block).
    Tolerances as there: costs rtol 2e-5 / atol 2e-4, crash flags exactly."""
    import jax.numpy as jnp

    from mppi_generic_tpu.ops import pallas_rollout
    from test_torch_autorally_kernels import X0, _rollout_inputs, _setup

    (jdyn, jcost, _), (dyn, cost, _) = _setup("32")
    U, lr = _rollout_inputs()
    Kj = U.shape[0]
    x0s = (X0 + 0.2 * np.random.default_rng(3).normal(size=(Kj, X0.size))).astype(np.float32)
    jc, jcrash = pallas_rollout.fused_rollout_costs(
        jdyn, jcost, jnp.asarray(x0s), jnp.asarray(U), DT, tile_k=128,
        lr_params=tuple(jnp.asarray(a) for a in lr[:3]) + tuple(jnp.float32(v)
                                                                 for v in lr[3:]))
    tc, tcrash = fr.fused_rollout_costs(
        dyn, cost, torch.from_numpy(x0s), torch.from_numpy(U), DT,
        lr_params=tuple(torch.from_numpy(a) for a in lr[:3]) + lr[3:], split_cost=False)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5, atol=2e-4)
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    assert 0 < int(np.asarray(jcrash).sum()) < Kj
