"""The staged forms of B3 and B1 on the CPU: their schedule, the forms their
entries report and the launch counters of their wrappers.

``fused_solve_staged_kernel`` and ``rollout_costs_staged_kernel``
(``csrc/sample_staged.cuh``, ``csrc/rollout_kernel.cuh``) share B4's ring:
per block of 64 samples and chunk of 32 steps, producer warp w makes, for
samples w, w + 8, ..., lane j's step t0 + j into a padded stage in shared
memory at ``(j rows + r) (NS + 1) + i``; consumer i then reads its slots
step by step and walks the chain of states. B3's producers draw, carve out
and clamp the controls (U written) and make the step's C LR terms lrc mu
(mu - 2 u), 2 C rows a step; the consumer adds acc + running and then the
terms one by one into the LR sum kept apart, J = (acc + terminal + gain lr)
/ T. B1's producers read lane j's C controls of U and, with LR, make gain
lr_t (C divisions), C (+ 1) rows; the consumer adds cost = running + gain
lr_t, acc = acc + cost.

``staged_ring`` emulates that schedule with a flat stage per block filled
with NaN, the producers' index arithmetic and the consumers' order, the
last 64-sample block and the last chunk ragged, and the tests hold it bit
for bit against the plain versions ``fused_solve_plain`` and
``rollout_costs_plain`` (costs, crash flags, U, the carry rows in
``write_block_carry``'s order and the block minima): the double integrator,
the cartpole, the quadrotor (C = 4) and the bicycle; T = 100, 150 and 31;
the Gaussian and NLN samplers with a pure-noise tail and stride 2; every
epilogue with and without LR; one x0 per sample. It pins the layout and the
order the kernels must keep; the kernels themselves are held against the
plain versions on the card (``tests/test_torch_cuda_kernels.py``, ``-k
staged``).
"""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch import GaussianDistribution, NLNDistribution
from mppi_generic_tpu_torch.costs import (
    ARStandardCost,
    CartpoleQuadraticCost,
    DoubleIntegratorCircleCost,
    QuadrotorQuadraticCost,
)
from mppi_generic_tpu_torch.maps import MapTexture2D
from mppi_generic_tpu_torch.models import (
    AutorallyNNDynamics,
    BicycleSlipDynamics,
    CartpoleDynamics,
    DoubleIntegratorDynamics,
    QuadrotorDynamics,
)
from mppi_generic_tpu_torch.models.base import broadcast_rec
from mppi_generic_tpu_torch.nn import FNN
from mppi_generic_tpu_torch.ops import _build, fused_solve
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_sample_warp import _clamp, stub_form  # noqa: F401 (stub_form: a fixture)

NS = 64  # kBlockSamples
CHUNK = 32  # kChunk: steps of a stage, one per producer lane
PRODUCER_WARPS = 8  # kProducerWarps
K, P_PURE, STRIDE, SEED = 70, 0.1, 2, 29  # K = 70: the second block holds 6 samples
DT, LAM, ALPHA = 0.02, 1.3, 0.1


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _parts(pair):
    """(dynamics, cost, x0, control std, mean offset of the last channel)."""
    if pair == "di_circle":
        return (DoubleIntegratorDynamics.create(control_ranges=[[-2.5, 2.5], [-2.0, 2.0]],
                                                control_deadband=[0.05, 0.1]),
                DoubleIntegratorCircleCost(), torch.tensor([2.0, 0.05, -0.1, 1.0]),
                [0.8, 1.3], 0.0)
    if pair == "cartpole":
        return (CartpoleDynamics.create(control_ranges=[[-5.0, 5.0]]),
                CartpoleQuadraticCost(coeffs=[100.0, 10.0, 200.0, 20.0],
                                      terminal_cost_coeff=0.5),
                torch.tensor([0.1, 0.0, 0.3, 0.0]), [5.0], 0.0)
    if pair == "quadrotor_quadratic":
        x0 = torch.zeros(13)
        x0[6], x0[0], x0[1] = 1.0, 0.8, -0.3
        return (QuadrotorDynamics.create(control_ranges=[[-3.0, 3.0]] * 3 + [[0.0, 20.0]]),
                QuadrotorQuadraticCost(x_coeff=50.0, v_coeff=5.0, terminal_cost_coeff=0.3),
                x0, [0.5, 0.5, 0.5, 2.0], 9.81)
    rng = np.random.default_rng(0)
    tex = MapTexture2D(np.abs(rng.normal(size=(128, 128))).astype("f"),
                       origin=(-64, -64, 0), resolution=1.0)
    x0 = torch.zeros(10)
    x0[5] = 3.0
    return (BicycleSlipDynamics.create(),
            ARStandardCost(costmap=tex, output_indices=(0, 1, 2, 8, 5, 6)), x0, [0.3, 0.5],
            0.0)


def _mean(pair, T, C, offset):
    rng = np.random.default_rng(T + C)
    mean = torch.from_numpy((0.3 * rng.normal(size=(T, C))).astype(np.float32))
    mean[:, -1] += offset
    return mean


def stage_at(j, r, i, rows):
    """StageLayout<NS, rows>::at: step j's row r of sample i."""
    return (j * rows + r) * (NS + 1) + i


def staged_ring(dynamics, cost, x0, Kr, T, rows, make, add):
    """The staged kernels' schedule: per chunk of 32 steps, the producers'
    rows (``make(ks, ts)``: (len(ks), len(ts), rows) for samples ks at
    steps ts) into one flat stage per block, then the consumers' chain
    reading it, the controls its first C rows, ``add(sums, running, v)``
    each step. Returns (sums, terminal cost, crash)."""
    C = dynamics.CONTROL_DIM
    n_blocks, n_chunks = -(-Kr // NS), -(-T // CHUNK)
    x = x0.T.clone() if x0.dim() == 2 else x0[:, None].expand(-1, Kr).clone()
    rec = broadcast_rec(dynamics.init_recurrent_state(), Kr)
    crash = torch.zeros((Kr,), dtype=torch.int32)
    sums = {"acc": torch.zeros((Kr,)), "lr": torch.zeros((Kr,))}
    ks = torch.arange(Kr)
    blocks, slots = ks // NS, ks % NS
    y = None
    for ch in range(n_chunks):
        t0 = ch * CHUNK
        lanes = [j for j in range(CHUNK) if t0 + j < T]  # the lanes past T make nothing
        ts = torch.tensor([t0 + j for j in lanes])
        stage = torch.full((n_blocks, CHUNK * rows * (NS + 1)), float("nan"))
        for b in range(n_blocks):
            for w in range(PRODUCER_WARPS):  # warp w: samples w, w + 8, ... of the block
                mine = [i for i in range(w, NS, PRODUCER_WARPS) if b * NS + i < Kr]
                if not mine:
                    continue
                idx = torch.tensor([[[stage_at(j, r, i, rows) for r in range(rows)]
                                     for j in lanes] for i in mine])
                stage[b, idx] = make(b * NS + torch.tensor(mine), ts)
        for j in range(len(lanes)):
            t = t0 + j
            v = torch.stack([stage[blocks, stage_at(j, r, 0, rows) + slots]
                             for r in range(rows)])  # (rows, K): consumer i's slots
            x, y, rec = dynamics.kernel_step_recurrent(x, rec, v[:C], float(t), DT)
            c_t, crash = cost.running_cost(y, v[:C], t, crash)
            add(sums, c_t, v)
    return sums, cost.terminal_cost(y), crash


def staged_solve(dyn, cost, samp, x0, mean, seed, iteration, z=None):
    """B3's staged schedule: (costs, crash, U, carry rows in the kernel's
    order)."""
    T, C = mean.shape
    kind = fr.noise_kind(samp)
    sigma, aux, lrc = fused_solve._tables(samp, kind, mean, iteration)
    cons = fr.constraint_table(dyn)
    normals = fr.standard_normals(kind, seed, K, T, C, z)
    thresh = samp.pure_threshold(K)
    U = torch.full((K, T, C), float("nan"))

    def make(ks, ts):  # solve_controls (csrc/sample_draw.cuh)
        zs = normals[:, ks][:, :, ts]  # (n_z, samples, steps, C)
        eps = zs[0] * torch.exp(aux[ts] * zs[1]) if kind == fr.NLN else zs[0]
        pure = (ks.to(torch.float32) >= thresh)[:, None]
        pin = (ks[:, None] == 0) | (ts[None, :] < STRIDE)
        us, terms = [], []
        for c in range(C):
            m = mean[ts, c]
            noise = sigma[ts, c] * eps[..., c]
            mu = torch.where(pure, 0.0, m)
            v = _clamp(torch.where(pin, m, torch.where(pure, noise, m + noise)), cons, c)
            us.append(v)
            terms.append(lrc[ts, c] * mu * (mu - 2.0 * v))
        u = torch.stack(us, dim=-1)
        U[ks[:, None], ts[None, :]] = u  # the producers' U rows
        return torch.cat([u, torch.stack(terms, dim=-1)], dim=-1)

    def add(s, running, v):
        s["acc"] = s["acc"] + running
        for c in range(C):
            s["lr"] = s["lr"] + v[C + c]

    sums, term, crash = staged_ring(dyn, cost, x0, K, T, 2 * C, make, add)
    costs = fr.true_div(sums["acc"] + term + fr._lr_gain(LAM, ALPHA) * sums["lr"], T)
    return costs, crash, U, fr.block_carries_ordered(costs, U, fr._f32(LAM))


def staged_rollout(dyn, cost, x0, U, lr_params):
    """B1's staged schedule: (costs, crash)."""
    _, T, C = U.shape

    def make(ks, ts):  # rollout_controls (csrc/rollout_kernel.cuh)
        u = U[ks][:, ts]
        if lr_params is None:
            return u
        mean, sigma, coeff, lam, alpha, thresh = lr_params
        pure = (ks.to(torch.float32) >= fr._f32(thresh))[:, None]
        lr_t = torch.zeros(u.shape[:2])
        for c in range(C):
            mu = torch.where(pure, 0.0, mean[ts, c])
            sg = sigma[ts, c]
            lr_t = lr_t + coeff[c] * mu * (mu - 2.0 * u[..., c]) / (sg * sg)
        return torch.cat([u, (fr._lr_gain(lam, alpha) * lr_t)[..., None]], dim=-1)

    def add(s, running, v):
        cost_t = running if lr_params is None else running + v[C]
        s["acc"] = s["acc"] + cost_t

    rows = C if lr_params is None else C + 1
    sums, term, crash = staged_ring(dyn, cost, x0, U.shape[0], T, rows, make, add)
    return fr.true_div(sums["acc"] + term, T), crash


PAIRS = ["di_circle", "cartpole", "quadrotor_quadratic", "bicycle_ar"]


@pytest.mark.parametrize("kind", ["gaussian", "nln"])
@pytest.mark.parametrize("T", [100, 150, 31])
@pytest.mark.parametrize("pair", PAIRS)
def test_staged_b3_schedule_matches_the_plain_version(pair, T, kind):
    dyn, cost, x0, std, offset = _parts(pair)
    C = dyn.CONTROL_DIM
    samp = (NLNDistribution if kind == "nln" else GaussianDistribution).create(
        std_dev=std, control_cost_coeff=[0.5] * C, pure_noise_percentage=P_PURE)
    mean = _mean(pair, T, C, offset)
    seed = torch.tensor(SEED + T, dtype=torch.int32)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, iteration=1,
                                                           optimization_stride=STRIDE)
    lc, lcrash, lU, lcarry = staged_solve(dyn, cost, samp, x0, mean, seed, 1)
    assert torch.isfinite(pc).all()
    assert torch.equal(lc, pc)
    assert torch.equal(lcrash, pcrash)
    assert torch.equal(lU, pU)
    assert torch.equal(lcarry, fr.block_carries_ordered(pc, pU, fr._f32(LAM)))
    np.testing.assert_allclose(lcarry.numpy(), pcarry.numpy(), rtol=1e-5, atol=1e-6)


def test_staged_b3_schedule_takes_injected_normals():
    dyn, cost, x0, std, _ = _parts("di_circle")
    T = 33
    samp = NLNDistribution.create(std_dev=std, control_cost_coeff=[0.5, 1.0],
                                  pure_noise_percentage=P_PURE)
    mean = _mean("di_circle", T, 2, 0.0)
    z = torch.randn((2, K, T, 2), generator=torch.Generator().manual_seed(T))
    seed = torch.tensor(SEED, dtype=torch.int32)
    pc, pcrash, pU, _ = fused_solve.fused_solve_plain(
        dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K, optimization_stride=STRIDE,
        injected_noise=z)
    lc, lcrash, lU, _ = staged_solve(dyn, cost, samp, x0, mean, seed, 0, z)
    assert torch.equal(lc, pc) and torch.equal(lcrash, pcrash) and torch.equal(lU, pU)


def _rollout_inputs(pair, T, with_lr):
    dyn, cost, x0, std, offset = _parts(pair)
    C = dyn.CONTROL_DIM
    mean = _mean(pair, T, C, offset)
    sigma = torch.tensor([std]).expand(T, C).contiguous()
    g = torch.Generator().manual_seed(T + 3)
    U = (mean + sigma * torch.randn((K, T, C), generator=g)).contiguous()
    thresh = float((np.float32(1) - np.float32(P_PURE)) * np.float32(K))
    lr = (mean, sigma, torch.full((C,), 0.5), LAM, ALPHA, thresh) if with_lr else None
    return dyn, cost, x0, U, lr


def _check_rollout(dyn, cost, x0, U, lr, epilogue):
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    lc, lcrash = staged_rollout(dyn, cost, x0, U, lr)
    assert torch.isfinite(pc).all()
    assert torch.equal(lc, pc)
    assert torch.equal(lcrash, pcrash)
    if epilogue == fr.EPI_EXP:
        lam = fr._f32(LAM)
        assert torch.equal(fr.block_carries_ordered(lc, U, lam),
                           fr.block_carries_ordered(pc, U, lam))
    if epilogue == fr.EPI_MIN:
        assert torch.equal(fr.block_minima_plain(lc), fr.block_minima_plain(pc))


@pytest.mark.parametrize("with_lr", [False, True])
@pytest.mark.parametrize("epilogue", [fr.EPI_NONE, fr.EPI_EXP, fr.EPI_MIN])
@pytest.mark.parametrize("T", [100, 150, 31])
@pytest.mark.parametrize("pair", PAIRS)
def test_staged_b1_schedule_matches_the_plain_version(pair, T, epilogue, with_lr):
    dyn, cost, x0, U, lr = _rollout_inputs(pair, T, with_lr)
    _check_rollout(dyn, cost, x0, U, lr, epilogue)


@pytest.mark.parametrize("with_lr", [False, True])
@pytest.mark.parametrize("T", [100, 31])
@pytest.mark.parametrize("pair", ["di_circle", "bicycle_ar"])
def test_staged_b1_schedule_per_sample_x0(pair, T, with_lr):
    dyn, cost, x0, U, lr = _rollout_inputs(pair, T, with_lr)
    g = torch.Generator().manual_seed(T)
    x0s = (x0 + 0.05 * torch.randn((K, x0.numel()), generator=g)).contiguous()
    _check_rollout(dyn, cost, x0s, U, lr, fr.EPI_EXP)


@pytest.mark.parametrize("rows", [1, 2, 3, 5, 8])
def test_stage_slots_are_distinct_and_in_range(rows):
    """Every (step, row, sample) of a stage of ``rows`` rows a step (B1
    without LR: C; with it and B4: C + 1; B3: 2 C) has its own slot, and
    consecutive consumers read consecutive words."""
    slots = {stage_at(j, r, i, rows) for j in range(CHUNK) for r in range(rows)
             for i in range(NS)}
    assert len(slots) == CHUNK * rows * NS
    assert max(slots) < CHUNK * rows * (NS + 1)
    assert stage_at(3, rows - 1, 7, rows) + 1 == stage_at(3, rows - 1, 8, rows)


def test_every_solve_and_rollout_entry_declares_its_form():
    declared = {kind: set() for kind in ("solve", "rollout", "rollout_x0")}
    for pair in _build.PAIR_KERNELS:
        for kind in declared:
            entry = _build.pair_entry(pair, kind)
            if entry is not None:
                lib, fn = entry
                assert _build.SIGNATURES[lib][fn + "_form"] == []
                declared[kind].add(pair)
    assert declared["solve"] == set(fr._PAIRS.values())
    # every pair has B1 from one x0 and, but the rest of the racer family
    # (still to come), from one x0 per sample (RMPPI's stage 1)
    family = {"racer_dubins_ar", "racer_elevation_ar", "racer_suspension_ar",
              "bicycle_elevation_ar", "racer_elev_susp_ar"}
    assert declared["rollout_x0"] == set(fr._PAIRS.values()) - family
    assert declared["rollout"] == set(fr._PAIRS.values())
    assert {"rollout_costs_staged_kernel", "fused_solve_staged_kernel",
            "fused_solve_warp_kernel", "block_carry_tiled_kernel"} <= set(_build.launch_counts)


FORM_NAMES = {0: "_kernel", 2: "_staged_kernel"}
# the kernels each B3 form launches (besides the merge): 0 one thread, 1 the
# warp form and its carry pass, 2 staged
SOLVE_FORM_LAUNCHES = {
    0: {"fused_solve_kernel": 1},
    1: {"fused_solve_warp_kernel": 1, "block_carry_tiled_kernel": 1},
    2: {"fused_solve_staged_kernel": 1},
}


@pytest.mark.parametrize("form", [0, 1, 2])
@pytest.mark.parametrize("pair", ["di_circle", "ar_nn"])
def test_solve_wrapper_counts_the_reported_form(stub_form, pair, form):
    stub_form(form)
    T = 8
    if pair == "ar_nn":
        dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=1.0))
        cost, x0 = ARStandardCost(), torch.zeros(7)
    else:
        dyn, cost, x0, _, _ = _parts(pair)
    samp = GaussianDistribution.create(std_dev=[0.3, 0.5])
    fr.reset_launch_counts()
    fused_solve.fused_solve_iteration(dyn, cost, samp, x0, torch.zeros((T, 2)),
                                      torch.tensor(3, dtype=torch.int32), DT, LAM, ALPHA,
                                      100, split_cost=False)
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        **SOLVE_FORM_LAUNCHES[form], "flash_combine_tiled_kernel": 1}
    assert fr.entry_counts == {f"fused_solve_{pair}": 1}


@pytest.mark.parametrize("form", [0, 2])
@pytest.mark.parametrize("x0_rows", [0, 100])
def test_rollout_wrapper_counts_the_reported_form(stub_form, x0_rows, form):
    stub_form(form)
    dyn, cost, x0, _, _ = _parts("di_circle")
    x0 = x0.expand(x0_rows, -1).contiguous() if x0_rows else x0
    fr.reset_launch_counts()
    fr.fused_rollout_costs(dyn, cost, x0, torch.zeros((100, 8, 2)), DT, split_cost=False)
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        "rollout_costs" + FORM_NAMES[form]: 1}
    want = "rollout_costs_x0_di_circle" if x0_rows else "rollout_costs_di_circle"
    assert fr.entry_counts == {want: 1}
