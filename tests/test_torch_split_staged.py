"""The staged form of the split form's two dynamics passes on the CPU: their
schedule, the forms their entries report and the launch counters of their
wrappers.

``split_solve_dynamics_staged_kernel`` and ``split_dynamics_staged_kernel``
(``csrc/split_staged.cuh``) run on the ring of the staged fused kernels
(``staged_ring``, ``csrc/sample_staged.cuh``): per block of 64 samples and
chunk of 32 steps, producer warp w makes, for samples w, w + 8, ..., lane
j's step t0 + j into a padded stage in shared memory at ``(j rows + r) (NS
+ 1) + i``; consumer i then reads its slots step by step, steps its state
and writes the outputs to Y at ``(t O + o) K + k``. B3's producers draw,
carve out and clamp the controls (U written) and make the step's C LR terms
lrc mu (mu - 2 u), 2 C rows a step, which the consumer adds one by one into
its LR sum in (t, c) order. B1's producers read lane j's C controls of U, C
rows a step; with one x0 per sample consumer k starts from row k.

``ring_pass`` emulates that schedule with a flat stage per block and a flat
Y, both filled with NaN, the producers' index arithmetic and the consumers'
order, the last 64-sample block (K = 70) and the last chunk ragged, and the
tests hold Y, U and the LR sums bit for bit against the plain versions
(``split_outputs_plain``, the samples and LR sums of
``fused_solve_split_plain``): the double integrator, the cartpole, the
quadrotor (C = 4), Dubins and (B3's pass) the bicycle; T = 100 and 31;
Gaussian and NLN with a pure-noise tail and stride 2; one x0 per sample for
the double integrator. The kernels themselves are held against the plain
versions on the card (``tests/test_torch_cuda_kernels.py``, ``-k
split_staged``).
"""

import pytest
import torch

from mppi_generic_tpu_torch import GaussianDistribution, NLNDistribution
from mppi_generic_tpu_torch.costs import DoubleIntegratorRobustCost, QuadraticCost
from mppi_generic_tpu_torch.models import DubinsDynamics
from mppi_generic_tpu_torch.models.base import broadcast_rec
from mppi_generic_tpu_torch.ops import _build, fused_solve
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_sample_warp import _clamp, stub_form  # noqa: F401 (stub_form: a fixture)
from test_torch_staged_solve import (
    CHUNK,
    DT,
    K,
    NS,
    P_PURE,
    PRODUCER_WARPS,
    SEED,
    STRIDE,
    _mean,
    _parts,
    stage_at,
)


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def parts(pair):
    """(dynamics, cost, x0, control std, mean offset of the last channel)."""
    if pair == "dubins_quadratic":
        return (DubinsDynamics.create(control_ranges=[[-2.0, 2.0], [-1.5, 1.5]]),
                QuadraticCost([1.0, 2.0, 0.5], [1.0, 2.0, 0.3], terminal_scale=2.0),
                torch.tensor([0.0, 0.0, 3.0]), [1.0, 1.0], 0.0)
    return _parts(pair)


def ring_pass(dyn, x0, Kr, T, rows, make, lr_terms):
    """The staged split passes' schedule: per chunk of 32 steps, the
    producers' rows (``make(ks, ts)``: (len(ks), len(ts), rows) for samples
    ks at steps ts) into one flat stage per block, then each consumer reads
    its slots, steps with the controls (its first C rows), stores the
    outputs into a flat Y at (t O + o) K + k and, with ``lr_terms``, adds
    rows C .. 2 C - 1 one by one into its LR sum. Returns (Y (T, O, K), LR
    sums (K,))."""
    C, O = dyn.CONTROL_DIM, dyn.OUTPUT_DIM
    n_blocks, n_chunks = -(-Kr // NS), -(-T // CHUNK)
    x = x0.T.clone() if x0.dim() == 2 else x0[:, None].expand(-1, Kr).clone()
    rec = broadcast_rec(dyn.init_recurrent_state(), Kr)
    Y = torch.full((T * O * Kr,), float("nan"))
    lr = torch.zeros((Kr,))
    ks = torch.arange(Kr)
    blocks, slots = ks // NS, ks % NS
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
            x, y, rec = dyn.kernel_step_recurrent(x, rec, v[:C], float(t), DT)
            for o in range(O):
                Y[(t * O + o) * Kr + ks] = y[o]
            if lr_terms:
                for c in range(C):
                    lr = lr + v[C + c]
    return Y.view(T, O, Kr), lr


def staged_solve_pass(dyn, samp, x0, mean, seed, iteration, z=None):
    """B3's staged split pass: (U, Y (T, O, K), LR sums)."""
    T, C = mean.shape
    kind = fr.noise_kind(samp)
    sigma, aux, lrc = fused_solve._tables(samp, kind, mean, iteration)
    cons = fr.constraint_table(dyn)
    normals = fr.standard_normals(kind, seed, K, T, C, z)
    thresh = samp.pure_threshold(K)
    U = torch.full((K, T, C), float("nan"))

    def make(ks, ts):  # SolvePolicy: solve_controls (csrc/sample_draw.cuh)
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

    Y, lr = ring_pass(dyn, x0, K, T, 2 * C, make, True)
    return U, Y, lr


def staged_dynamics_pass(dyn, x0, U):
    """B1's staged split pass: Y (T, O, K)."""
    Kr, T, C = U.shape
    return ring_pass(dyn, x0, Kr, T, C, lambda ks, ts: U[ks][:, ts], False)[0]


B3_PAIRS = ["di_circle", "cartpole", "quadrotor_quadratic", "dubins_quadratic", "bicycle_ar"]
B1_PAIRS = B3_PAIRS[:-1]  # the bicycle's B1 pass takes the lane-group form


@pytest.mark.parametrize("kind", ["gaussian", "nln"])
@pytest.mark.parametrize("T", [100, 31])
@pytest.mark.parametrize("pair", B3_PAIRS)
def test_staged_split_b3_pass_matches_the_plain_version(pair, T, kind):
    dyn, cost, x0, std, offset = parts(pair)
    C = dyn.CONTROL_DIM
    samp = (NLNDistribution if kind == "nln" else GaussianDistribution).create(
        std_dev=std, control_cost_coeff=[0.5] * C, pure_noise_percentage=P_PURE)
    mean = _mean(pair, T, C, offset)
    seed = torch.tensor(SEED + T, dtype=torch.int32)
    pU, plr = fused_solve._samples_plain(dyn, samp, mean, seed, K, 1, STRIDE, None)
    pY = fr.split_outputs_plain(dyn, x0, pU, DT).permute(1, 2, 0)
    lU, lY, llr = staged_solve_pass(dyn, samp, x0, mean, seed, 1)
    assert torch.isfinite(pY).all() and torch.isfinite(plr).all()
    assert torch.equal(lU, pU)
    assert torch.equal(lY, pY)
    assert torch.equal(llr, plr)
    # the split form's plain version draws the same samples
    _, _, sU, _ = fused_solve.fused_solve_split_plain(
        dyn, cost, samp, x0, mean, seed, DT, 1.3, 0.1, K, iteration=1,
        optimization_stride=STRIDE)
    assert torch.equal(sU, pU)


def test_staged_split_b3_pass_takes_injected_normals():
    dyn, _, x0, std, _ = parts("di_circle")
    T = 33
    samp = NLNDistribution.create(std_dev=std, control_cost_coeff=[0.5, 1.0],
                                  pure_noise_percentage=P_PURE)
    mean = _mean("di_circle", T, 2, 0.0)
    z = torch.randn((2, K, T, 2), generator=torch.Generator().manual_seed(T))
    seed = torch.tensor(SEED, dtype=torch.int32)
    pU, plr = fused_solve._samples_plain(dyn, samp, mean, seed, K, 0, STRIDE, z)
    lU, lY, llr = staged_solve_pass(dyn, samp, x0, mean, seed, 0, z)
    assert torch.equal(lU, pU) and torch.equal(llr, plr)
    assert torch.equal(lY, fr.split_outputs_plain(dyn, x0, pU, DT).permute(1, 2, 0))


def _controls(pair, dyn, T, offset, std):
    C = dyn.CONTROL_DIM
    mean = _mean(pair, T, C, offset)
    g = torch.Generator().manual_seed(T + 7)
    U = mean + torch.tensor([std]) * torch.randn((K, T, C), generator=g)
    return dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()


@pytest.mark.parametrize("T", [100, 31])
@pytest.mark.parametrize("pair", B1_PAIRS)
def test_staged_split_b1_pass_matches_the_plain_version(pair, T):
    dyn, _, x0, std, offset = parts(pair)
    U = _controls(pair, dyn, T, offset, std)
    want = fr.split_outputs_plain(dyn, x0, U, DT).permute(1, 2, 0)
    assert torch.isfinite(want).all()
    assert torch.equal(staged_dynamics_pass(dyn, x0, U), want)


@pytest.mark.parametrize("T", [100, 48, 31])
def test_staged_split_b1_pass_per_sample_x0(T):
    dyn, _, x0, std, offset = parts("di_circle")
    U = _controls("di_circle", dyn, T, offset, std)
    g = torch.Generator().manual_seed(T)
    x0s = (x0 + 0.05 * torch.randn((K, x0.numel()), generator=g)).contiguous()
    want = fr.split_outputs_plain(dyn, x0s, U, DT).permute(1, 2, 0)
    assert torch.equal(staged_dynamics_pass(dyn, x0s, U), want)


SPLIT_FORM_NAMES = {0: "_kernel", 1: "_warp_kernel", 2: "_staged_kernel", 5: "_lanes_kernel"}


@pytest.mark.parametrize("form", [0, 1, 2, 5])
@pytest.mark.parametrize("x0_rows", [0, 70])
def test_split_dynamics_wrapper_counts_the_reported_form(stub_form, form, x0_rows):
    stub_form(form)
    dyn, cost, x0, _, _ = parts("di_circle")
    cost = DoubleIntegratorRobustCost() if x0_rows else cost
    x0 = x0.expand(x0_rows, -1).contiguous() if x0_rows else x0
    fr.reset_launch_counts()
    fr.split_dynamics_cuda(dyn, cost, x0, torch.zeros((K, 8, 2)), DT)
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        "split_dynamics" + SPLIT_FORM_NAMES[form]: 1}
    want = "split_dynamics_x0_di_robust" if x0_rows else "split_dynamics_di_circle"
    assert fr.entry_counts == {want: 1}


@pytest.mark.parametrize("form", [0, 1, 2])
@pytest.mark.parametrize("pair", B3_PAIRS)
def test_split_solve_dynamics_wrapper_counts_the_reported_form(stub_form, pair, form):
    stub_form(form)
    dyn, cost, x0, std, _ = parts(pair)
    C = dyn.CONTROL_DIM
    samp = GaussianDistribution.create(std_dev=std)
    fr.reset_launch_counts()
    fused_solve.split_solve_dynamics_cuda(dyn, cost, samp, fr.GAUSSIAN, x0,
                                          torch.zeros((8, C)),
                                          torch.tensor(3, dtype=torch.int32), DT, K, 0, 0,
                                          None)
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        "split_solve_dynamics" + SPLIT_FORM_NAMES[form]: 1}
    assert fr.entry_counts == {f"split_solve_dynamics_{pair}": 1}


def test_every_analytic_split_pass_has_a_form_entry():
    """The pairs whose split passes take the staged form declare
    ``<entry>_form`` beside each of their split dynamics entries."""
    want = {"split_dynamics": {"di_circle", "di_quadratic", "cartpole", "quadrotor_quadratic",
                               "dubins_quadratic", "bicycle_ar"},
            "split_solve_dynamics": {"di_circle", "di_quadratic", "cartpole",
                                     "quadrotor_quadratic", "dubins_quadratic", "bicycle_ar"},
            "split_dynamics_x0": {"di_robust"}}
    for kind, pairs in want.items():
        for pair in pairs:
            lib, fn = _build.pair_entry(pair, kind)
            assert _build.SIGNATURES[lib][fn + "_form"] == []
