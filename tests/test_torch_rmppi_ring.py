"""The staged form of B8 on the CPU: its ring, emulated, against the plain
version bit for bit.

``rmppi_rollout_staged_kernel`` (``csrc/rmppi_staged.cuh``) runs the
double integrator's RMPPI rollout on B4's ring: blocks of 32 samples, two
stages of 32-step chunks, each (step j, sample i) a 16-byte aligned record
of 12 floats at ``j (32 * 12 + 4) + 12 i``: u_raw and u_nom, x_nom, x_real.
Producer warp w (of 8) makes, for its samples w, w + 8, w + 16, w + 24,
lane j's step t0 + j: u_raw and u_nom = clamp(u_raw); warp 0 lane j also
the step's table row: the gain rows K[t] (C S) and sigma^2 as sg * sg (C),
padded to 12 floats. One
walker thread a sample leaves x_nom and x_real before each step in its
record, forms dx, the feedback (the gain products in s order), writes
u_real = clamp(u_raw + u_fb) over u_raw and steps both systems. Once a
chunk is walked, the producers take each step of it apart: the feedback's
cost from dx (in c order), both outputs (the step again), both running
costs and the real system's crash flag, U_real; they leave c_nom, c_real,
fb and the flag in the x_nom group (the terminal costs at t = T - 1 in the
x_real group), and three lanes a sample add them in t order into s_nom,
j_real and s_fb, the second OR-ing the flags. Two stages alternate, so
chunk ch + 2 overwrites chunk ch's stage only after its costs are summed.

``ring`` emulates that schedule with two flat stages per block filled with
NaN, the producers' and the walkers' index arithmetic, the last 32-sample
block and the last chunk ragged, and the tests hold it bit for bit against
``rmppi_rollout_plain`` (s_nom, j_real, s_fb, the crash flags, U_real) for
the circle and the robust cost at T = 50 (``rmppi``), 48
(``rmppi_di_robust``), 31 and 100 (four chunks: each stage refilled), and
with a cost that sets the crash flag (the flags' OR). The
plain version is held against the JAX package's RMPPI kernel in interpret
mode. The kernel itself is held against the plain version and its
one-thread build on the card (``tests/test_torch_cuda_kernels.py``, ``-k
rmppi``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs.double_integrator import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.costs.double_integrator import DoubleIntegratorRobustCost as JRobust
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost, DoubleIntegratorRobustCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_sample_warp import _clamp

NS = 32  # kRmppiSamples
CHUNK = 32  # kChunk
PRODUCER_WARPS = 8  # kRmppiProducerWarps
C, S = 2, 4
REC = 2 * C + 2 * S  # a record: u_raw / u_real, u_nom, x_nom, x_real
STEP = NS * REC + 4  # kStep: the floats between two steps of a stage
K_U, K_UNOM, K_XNOM, K_XREAL = 0, C, 2 * C, 2 * C + S
TAB = 12  # kTab: C S gains, C sigma^2, a pad
DT, LAM, ALPHA = 0.02, 1.3, 0.1
CONSTRAINTS = dict(control_ranges=[[-2.5, 2.5], [-2.0, 2.0]], control_deadband=[0.05, 0.1])
X0 = {"circle": ([2.0, 0.0, 0.0, 1.0], [2.15, -0.05, 0.1, 0.9]),
      "robust": ([2.05, 0.0, 0.0, 1.9], [2.12, -0.05, 0.1, 1.8])}


@pytest.fixture(autouse=True)
def one_thread():
    """One thread and TF32 off, as the kernels' bit-exact references run."""
    saved = (torch.get_num_threads(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(saved[0])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[1:]


def stage_at(j, f, i):
    """RmppiStage::rec: float f of the record of step j, sample i."""
    return j * STEP + i * REC + f


class FlaggingCost:
    """A cost that is not sticky yet sets the crash flag: the DI cost's
    values, with the flag set where the first control passes 2.4 (as the
    quadrotor's gate cost sets it without reading it)."""

    def __init__(self, cost):
        self.cost = cost

    def running_cost(self, y, u, t, crash):
        c, _ = self.cost.running_cost(y, u, t, crash)
        return c, crash | (u[0] > 2.4).to(torch.int32)

    def terminal_cost(self, y):
        return self.cost.terminal_cost(y)


def feedback(g, dx):
    """u_fb = K[t] dx, the gain products in s order."""
    u_fb = g[0] * dx[0]
    for s in range(1, S):
        u_fb = u_fb + g[s] * dx[s]
    return u_fb


def ring(dyn, cost, x0_nom, x0_real, U, gains, sigma, coeff):
    """B8's staged schedule: (s_nom, j_real, s_fb, crash_real, U_real)."""
    K, T, _ = U.shape
    n_blocks, n_chunks = -(-K // NS), -(-T // CHUNK)
    stages = [torch.full((n_blocks, CHUNK * STEP), float("nan")) for _ in range(2)]
    tabs = [torch.full((CHUNK, TAB), float("nan")) for _ in range(2)]
    cons = fr.constraint_table(dyn)
    gain = fr._lr_gain(LAM, ALPHA)
    ks = torch.arange(K)
    blocks, slots = ks // NS, ks % NS
    x_nom = x0_nom[:, None].expand(-1, K)
    x_real = x0_real[:, None].expand(-1, K)
    sums = [torch.zeros((K,)) for _ in range(3)]  # s_nom, j_real, s_fb
    crashed = torch.zeros((K,), dtype=torch.int32)
    terms = [None, None]
    U_real = torch.full((K, T, C), float("nan"))

    def lanes(ch):
        return [j for j in range(CHUNK) if ch * CHUNK + j < T]

    def read(stage, j, f):
        return stage[blocks, stage_at(j, f, 0) + REC * slots]

    def write(stage, j, f, v):
        stage[blocks, stage_at(j, f, 0) + REC * slots] = v

    def fill(ch):
        stage, tab, t0 = stages[ch & 1], tabs[ch & 1], ch * CHUNK
        for j in lanes(ch):  # warp 0's table row of step t0 + j
            t = t0 + j
            sg = sigma[t]
            tab[j] = torch.cat([gains[t].reshape(-1), sg * sg, torch.zeros(2)])
        ts = torch.tensor([t0 + j for j in lanes(ch)])
        for b in range(n_blocks):
            for w in range(PRODUCER_WARPS):  # samples w, w + 8, ... of the block
                mine = [i for i in range(w, NS, PRODUCER_WARPS) if b * NS + i < K]
                if not mine:
                    continue
                idx = torch.tensor([[[stage_at(j, f, i) for f in range(2 * C)]
                                     for j in lanes(ch)] for i in mine])
                u = U[b * NS + torch.tensor(mine)][:, ts]  # (samples, steps, C)
                nom = torch.stack([_clamp(u[..., c], cons, c) for c in range(C)], dim=-1)
                stage[b, idx] = torch.cat([u, nom], dim=-1)

    def walk(ch):
        nonlocal x_nom, x_real
        stage, tab, t0 = stages[ch & 1], tabs[ch & 1], ch * CHUNK
        for j in lanes(ch):
            t = float(t0 + j)
            u_raw = [read(stage, j, K_U + c) for c in range(C)]
            u_nom = torch.stack([read(stage, j, K_UNOM + c) for c in range(C)])
            for s in range(S):
                write(stage, j, K_XNOM + s, x_nom[s])
                write(stage, j, K_XREAL + s, x_real[s])
            dx = [x_real[s] - x_nom[s] for s in range(S)]
            u_real = []
            for c in range(C):
                u_real.append(_clamp(u_raw[c] + feedback(tab[j, c * S:(c + 1) * S], dx),
                                     cons, c))
                write(stage, j, K_U + c, u_real[c])
            x_nom, _ = dyn.kernel_step(x_nom, u_nom, t, DT)
            x_real, _ = dyn.kernel_step(x_real, torch.stack(u_real), t, DT)

    def costs(ch):
        nonlocal crashed
        stage, tab, t0 = stages[ch & 1], tabs[ch & 1], ch * CHUNK
        for j in lanes(ch):  # producer lane j, every sample of its warps
            t = t0 + j
            u_nom = torch.stack([read(stage, j, K_UNOM + c) for c in range(C)])
            u_real = torch.stack([read(stage, j, K_U + c) for c in range(C)])
            xn = torch.stack([read(stage, j, K_XNOM + s) for s in range(S)])
            xr = torch.stack([read(stage, j, K_XREAL + s) for s in range(S)])
            U_real[:, t] = u_real.T
            dx = [xr[s] - xn[s] for s in range(S)]
            fb = torch.zeros((K,))
            for c in range(C):
                u_fb = feedback(tab[j, c * S:(c + 1) * S], dx)
                fb = fb + coeff[c] * u_fb * u_fb / tab[j, C * S + c]
            fb = gain * fb
            _, y_nom = dyn.kernel_step(xn, u_nom, float(t), DT)
            _, y_real = dyn.kernel_step(xr, u_real, float(t), DT)
            zero = torch.zeros((K,), dtype=torch.int32)
            c_nom, _ = cost.running_cost(y_nom, u_nom, t, zero)
            c_real, crash_r = cost.running_cost(y_real, u_real, t, zero)
            write(stage, j, K_XNOM, c_nom)
            write(stage, j, K_XNOM + 1, c_real)
            write(stage, j, K_XNOM + 2, fb)
            write(stage, j, K_XNOM + 3, torch.where(crash_r != 0, 1.0, 0.0))
            if t == T - 1:
                write(stage, j, K_XREAL, cost.terminal_cost(y_nom))
                write(stage, j, K_XREAL + 1, cost.terminal_cost(y_real))
        for j in lanes(ch):  # three lanes a sample, in t order
            c_real = read(stage, j, K_XNOM + 1)
            sums[0] = sums[0] + read(stage, j, K_XNOM)
            sums[1] = sums[1] + c_real
            sums[2] = sums[2] + c_real + read(stage, j, K_XNOM + 2)
            crashed = crashed | (read(stage, j, K_XNOM + 3) != 0.0).to(torch.int32)
        if ch == n_chunks - 1:
            n = len(lanes(ch))
            terms[:] = [read(stage, n - 1, K_XREAL), read(stage, n - 1, K_XREAL + 1)]

    for ch in range(min(2, n_chunks)):
        fill(ch)
    for ch in range(n_chunks):
        walk(ch)
        costs(ch)
        if ch + 2 < n_chunks:
            fill(ch + 2)  # into the stage chunk ch has left
    return (fr.true_div(sums[0] + terms[0], T), fr.true_div(sums[1] + terms[1], T),
            fr.true_div(sums[2] + terms[1], T), crashed, U_real)


def _inputs(kind, T, K=130):
    g = torch.Generator().manual_seed(T + (kind == "robust"))
    dyn = DoubleIntegratorDynamics.create(**CONSTRAINTS)
    cost = (DoubleIntegratorRobustCost if kind == "robust" else DoubleIntegratorCircleCost)(
        discount=0.95)
    U = 1.2 * torch.randn((K, T, C), generator=g)
    gains = -0.8 * torch.rand((T, C, S), generator=g)
    sigma = 0.6 + 0.8 * torch.rand((T, C), generator=g)
    x_nom, x_real = (torch.tensor(x) for x in X0[kind])
    return dyn, cost, x_nom, x_real, U, gains, sigma, torch.tensor([0.02, 0.5])


@pytest.mark.parametrize("K", [130, 70])
@pytest.mark.parametrize("T", [50, 48, 31, 100])
@pytest.mark.parametrize("kind", ["circle", "robust"])
def test_ring_matches_the_plain_version(kind, T, K):
    """K = 130: the fifth block holds 2 samples; K = 70: the third 6."""
    args = _inputs(kind, T, K)
    want = fr.rmppi_rollout_plain(*args, DT, LAM, ALPHA)
    got = ring(*args)
    for name, a, b in zip(("s_nom", "j_real", "s_fb", "crash", "U_real"), got, want):
        assert torch.equal(a, b), name
    assert torch.isfinite(want[4]).all()
    # the crash term ran: some samples left the track (the factor's path)
    cost = args[1]
    assert float(want[0].max()) > 0.95 ** (T - 1) * float(cost.crash_cost) / T


@pytest.mark.parametrize("T", [50, 48, 31])
@pytest.mark.parametrize("kind", ["circle", "robust"])
def test_ring_ors_the_real_systems_crash_flags(kind, T):
    """A cost that sets the flag without reading it: the ring's crash
    output is the OR of the real system's flags over the steps, as the
    one-thread kernel carries it, and every other output is unchanged."""
    dyn, cost, *rest = _inputs(kind, T)
    args = (dyn, FlaggingCost(cost), *rest)
    want = fr.rmppi_rollout_plain(*args, DT, LAM, ALPHA)
    got = ring(*args)
    for name, a, b in zip(("s_nom", "j_real", "s_fb", "crash", "U_real"), got, want):
        assert torch.equal(a, b), name
    assert 0 < int(want[3].sum()) < want[3].numel()  # both kinds of sample


def test_stage_records_are_distinct_aligned_and_apart_in_banks():
    """Every (step, sample, float) of a stage has its own slot; records are
    16-byte aligned; the 16-byte accesses of each quarter warp reach eight
    distinct groups of four banks, for the walkers (one step, eight
    neighbouring samples) and for the producers (one sample, eight
    neighbouring steps); the two stages and the step tables fit the 227 KB a
    block may hold."""
    slots = {stage_at(j, f, i) for j in range(CHUNK) for f in range(REC) for i in range(NS)}
    assert len(slots) == CHUNK * REC * NS
    assert max(slots) < CHUNK * STEP
    assert all(stage_at(j, 0, i) % 4 == 0 for j in range(CHUNK) for i in range(NS))
    for first in range(0, 32, 8):
        walkers = [stage_at(5, 4, i) % 32 for i in range(first, first + 8)]
        producers = [stage_at(j, 4, 7) % 32 for j in range(first, first + 8)]
        for bases in (walkers, producers):
            banks = {(b + d) % 32 for b in bases for d in range(4)}
            assert len(banks) == 32
    assert 2 * 4 * CHUNK * STEP + 2 * 4 * CHUNK * TAB <= 227 * 1024


@pytest.mark.parametrize("kind", ["circle", "robust"])
def test_plain_version_matches_the_jax_kernel(kind):
    """rmppi_rollout_plain against the JAX package's RMPPI kernel
    (_fused_rmppi_call) in interpret mode at K = 130, T = 31. Tolerances:
    rtol / atol 1e-5 for the sums (the two sides order the likelihood terms
    differently, tests/test_torch_robust.py), 1e-6 for U_real; crash flags
    exactly."""
    T = 31
    dyn, cost, x_nom, x_real, U, gains, sigma, coeff = _inputs(kind, T)
    jcost = (JRobust if kind == "robust" else JCircle)(discount=jnp.float32(0.95))
    jout = pallas_rollout.fused_rmppi_rollout(
        JDI.create(**CONSTRAINTS), jcost, *(jnp.asarray(a.numpy()) for a in (
            x_nom, x_real, U, gains, sigma, coeff)), jnp.float32(DT), LAM, ALPHA,
        interpret=True)
    tout = fr.rmppi_rollout_plain(dyn, cost, x_nom, x_real, U, gains, sigma, coeff, DT,
                                  LAM, ALPHA)
    for name, t, j in zip(("s_nom", "j_real", "s_fb"), tout[:3], jout[:3]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_allclose(tout[4].numpy(), np.asarray(jout[4]), rtol=1e-5, atol=1e-6)
