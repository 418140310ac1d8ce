"""The lane orders of the ladder's warp recursion (B7) and of B4's staged
form, on the CPU.

``riccati_ladder_warp_kernel`` (``csrc/riccati_kernels.cuh``,
``backward_pass_warp``) spreads each step of the Riccati recursion over the
32 lanes of a warp in four rounds, each made of segments, one per product:
round 1 makes VA = Vxx A, VB = Vxx B, qx and qu, round 2 qxx, qux and quu,
each entry one sum over k on one lane with its operands fixed by the
segment and the entry's index; in round 3 lane j <= S solves column j of
quu [K | k] = -[qux | qu], every lane eliminating quu itself; round 4 makes
the new Vxx (both Vn entries of a symmetric pair on one lane) and Vx. This
file emulates those rounds with the entries (and in round 3 the lanes) as
a tensor axis, float32 elementwise operations in the kernel's order and the
kernel's index arithmetic, and holds the gains bit for bit against
``riccati_backward_plain`` (the kernels' plain version).

``fused_sample_rollout_staged_kernel`` (``csrc/sample_staged.cuh``) hands
each chunk of 32 steps from producer warps to consumer threads through a
padded stage in shared memory: producer warp w writes, for samples w, w + 8,
..., lane j's step t0 + j at ``(j (C + 1) + c) (NS + 1) + i`` (controls, then
the LR term at c = C); consumer i reads the same slots and adds
acc + running + lr_t. The emulation writes and reads a flat stage with that
arithmetic, the last chunk and the last block ragged (T = 33, K = 65 and
T = 65, K = 129), and
holds costs, crash flags, U and W bit for bit against
``sample_rollout_plain``. It pins the layout and the order the kernels must
keep; the kernels themselves are held against the plain versions on the
card (``tests/test_torch_cuda_kernels.py``, ``-k "ladder_warp or staged"``).
"""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.models.base import broadcast_rec
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import riccati
from mppi_generic_tpu_torch.sampling import GaussianDistribution, SmoothMPPIDistribution

LANES = 32
CHUNK = 32  # kChunk: steps of a stage
PRODUCER_WARPS = 8  # kProducerWarps
DT, LAM, ALPHA = 0.02, 1.3, 0.1


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# the warp recursion
# ---------------------------------------------------------------------------
def _round_tables(S, C):
    """The kernel's operand picks of rounds 1, 2 and 4 as index tables into
    one flat memory ``[A | B | dLx | dLu | Vxx | Vx | r1 | r2 | Qdt | Rdt |
    Kk | kk]`` (the offsets in ``off``): per entry, the flat indices of p[k]
    and q[k] (k < S, or k < C in round 4) and of its base (-1: none)."""
    SS, SC, CS = S * S, S * C, C * S
    sizes = dict(A=SS, B=SC, dLx=S, dLu=C, Vxx=SS, Vx=S, r1=SS + SC + S + C,
                 r2=SS + CS + C * C, Qdt=SS, Rdt=C * C, Kk=CS, kk=C)
    off, at = {}, 0
    for name, n in sizes.items():
        off[name] = at
        at += n
    VA, VB = off["r1"], off["r1"] + SS
    qx, qu = VB + SC, VB + SC + S
    qxx, qux = off["r2"], off["r2"] + SS

    def entry(p, ps, q, qs, base=-1, n=S):
        return [p + k * ps for k in range(n)], [q + k * qs for k in range(n)], base

    r1 = []
    for e in range(sizes["r1"]):
        if e < SS:
            r1.append(entry(off["Vxx"] + (e // S) * S, 1, off["A"] + e % S, S))
        elif e < SS + SC:
            f = e - SS
            r1.append(entry(off["Vxx"] + (f // C) * S, 1, off["B"] + f % C, C))
        elif e < SS + SC + S:
            f = e - SS - SC
            r1.append(entry(off["A"] + f, S, off["Vx"], 1, off["dLx"] + f))
        else:
            f = e - SS - SC - S
            r1.append(entry(off["B"] + f, C, off["Vx"], 1, off["dLu"] + f))
    r2, diag = [], []
    for e in range(sizes["r2"]):
        if e < SS:
            r2.append(entry(off["A"] + e // S, S, VA + e % S, S, off["Qdt"] + e))
            diag.append(False)
        elif e < SS + CS:
            f = e - SS
            r2.append(entry(off["B"] + f // S, C, VA + f % S, S))
            diag.append(False)
        else:
            f = e - SS - CS
            r2.append(entry(off["B"] + f // C, C, VB + f % C, C, off["Rdt"] + f))
            diag.append(f // C == f % C)
    r4a, r4b = [], []
    for e in range(SS + S):
        vxx = e < SS
        r, c = (e // S, e % S) if vxx else (e - SS, 0)
        r4a.append(entry(qux + r, S, off["Kk"] + c if vxx else off["kk"], S if vxx else 1,
                         qxx + r * S + c if vxx else qx + r, n=C))
        r4b.append(entry(qux + c, S, off["Kk"] + r, S, qxx + c * S + r, n=C))
    tables = {}
    for name, rows in (("r1", r1), ("r2", r2), ("r4a", r4a), ("r4b", r4b)):
        tables[name] = tuple(torch.tensor([row[i] for row in rows]) for i in range(3))
    return off, at, tables, torch.tensor(diag)


def _dots(mem, table):
    """Each entry's sum p[0] q[0] + p[1] q[1] + ..., left to right."""
    P, Q, _ = table
    acc = mem[P[:, 0]] * mem[Q[:, 0]]
    for k in range(1, P.shape[1]):
        acc = acc + mem[P[:, k]] * mem[Q[:, k]]
    return acc


def _lane_solve(M, cols, C):
    """Round 3: lane j solves column j of M X = cols (lanes on the last
    axis), each lane eliminating M in the same order."""
    M = [[M[i, c] for c in range(C)] for i in range(C)]
    r = [cols[i] for i in range(C)]
    for p in range(C):
        inv_p = 1.0 / M[p][p]
        for i in range(p + 1, C):
            f = M[i][p] * inv_p
            for c in range(p + 1, C):
                M[i][c] = M[i][c] - f * M[p][c]
            r[i] = r[i] - f * r[p]
    x = [None] * C
    for i in range(C - 1, -1, -1):
        acc = r[i]
        for c in range(i + 1, C):
            acc = acc - M[i][c] * x[c]
        x[i] = acc / M[i][i]
    return torch.stack(x)


def backward_pass_lanes(As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T, dt, reg):
    """backward_pass_warp's rounds with the entries as a tensor axis."""
    T, S, C = As.shape[0], As.shape[1], Bs.shape[2]
    SS, SC, CS = S * S, S * C, C * S
    off, n_mem, tab, diag = _round_tables(S, C)
    mem = torch.zeros(n_mem, dtype=torch.float32)
    mem[off["Vxx"]:off["Vxx"] + SS] = Vxx_T.flatten()
    mem[off["Vx"]:off["Vx"] + S] = Vx_T
    mem[off["Qdt"]:off["Qdt"] + SS] = Qdt.flatten()
    mem[off["Rdt"]:off["Rdt"] + C * C] = Rdt.flatten()
    dt, reg = torch.tensor(dt, dtype=torch.float32), torch.tensor(reg, dtype=torch.float32)
    Ks = torch.zeros((T, C, S), dtype=torch.float32)
    ks = torch.zeros((T, C), dtype=torch.float32)
    r1, r2 = off["r1"], off["r2"]
    for t in range(T - 2, -1, -1):
        mem[off["A"]:off["A"] + SS] = As[t].flatten()
        mem[off["B"]:off["B"] + SC] = Bs[t].flatten()
        mem[off["dLx"]:off["dLx"] + S] = dLx[t]
        mem[off["dLu"]:off["dLu"] + C] = dLu[t]
        # round 1: the base (dLx or dLu) times dt, plus the sum
        acc = _dots(mem, tab["r1"])
        base = tab["r1"][2]
        has = base >= 0
        v = acc.clone()
        v[has] = mem[base[has]] * dt + acc[has]
        mem[r1:r1 + v.numel()] = v
        # round 2: the base (Qdt or Rdt) plus the sum, then reg on quu's diagonal
        acc = _dots(mem, tab["r2"])
        base = tab["r2"][2]
        has = base >= 0
        v = acc.clone()
        v[has] = mem[base[has]] + acc[has]
        v[diag] = v[diag] + reg
        mem[r2:r2 + v.numel()] = v
        # round 3: lanes j < S take qux's column j, lane S qu
        quu = mem[r2 + SS + CS:r2 + SS + CS + C * C].reshape(C, C)
        qux = mem[r2 + SS:r2 + SS + CS].reshape(C, S)
        qu = mem[r1 + SS + SC + S:r1 + SS + SC + S + C]
        x = _lane_solve(quu, torch.cat([qux, qu[:, None]], dim=1), C)
        Ks[t], ks[t] = -x[:, :S], -x[:, S]
        mem[off["Kk"]:off["Kk"] + CS] = Ks[t].flatten()
        mem[off["kk"]:off["kk"] + C] = ks[t]
        # round 4: Vn[r][c] (or Vx[r]) and Vn[c][r]
        v1 = mem[tab["r4a"][2]] + _dots(mem, tab["r4a"])
        v2 = mem[tab["r4b"][2]] + _dots(mem, tab["r4b"])
        mem[off["Vxx"]:off["Vxx"] + SS] = 0.5 * (v1[:SS] + v2[:SS])
        mem[off["Vx"]:off["Vx"] + S] = v1[SS:]
    return Ks, ks


def _linearisation(S, C, T, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    As = f32(np.eye(S) + 0.05 * rng.normal(size=(T, S, S)))
    Bs = f32(0.1 * rng.normal(size=(T, S, C)))
    Q = f32(np.diag(rng.uniform(0.5, 2.0, S)))
    R = f32(np.diag(rng.uniform(0.5, 2.0, C)))
    Vxx_T = f32(3.0 * np.eye(S) + 0.1 * np.ones((S, S)))
    return (As, Bs, f32(rng.normal(size=(T, S))), f32(rng.normal(size=(T, C))), Q * DT,
            R * DT, Vxx_T, f32(rng.normal(size=S)))


@pytest.mark.parametrize("S,C", [(4, 2), (4, 1), (7, 2)])
@pytest.mark.parametrize("T", [48, 50, 100, 150])
def test_warp_recursion_lanes_match_the_plain_recursion(S, C, T):
    args = _linearisation(S, C, T, seed=10 * S + C + T)
    pK, pk = riccati.riccati_backward_plain(*args, torch.tensor(DT), 1e-6)
    lK, lk = backward_pass_lanes(*args, DT, 1e-6)
    assert torch.isfinite(pK).all() and pK.abs().max() > 0
    assert torch.equal(lK, pK)
    assert torch.equal(lk, pk)


def test_warp_recursion_lanes_match_the_plain_recursion_at_the_longest_horizon():
    """The recursion at the most steps the kernels take (T = 1024,
    ``riccati.supported``) at AutoRally's (7, 2): the horizon at which B6's
    warp form keeps 64 KB of gains in shared memory."""
    S, C, T = 7, 2, 1024
    args = _linearisation(S, C, T, seed=10 * S + C + T)
    pK, pk = riccati.riccati_backward_plain(*args, torch.tensor(DT), 1e-6)
    lK, lk = backward_pass_lanes(*args, DT, 1e-6)
    assert torch.isfinite(pK).all() and pK.abs().max() > 0
    assert torch.equal(lK, pK)
    assert torch.equal(lk, pk)


def lane_iters(n):
    """csrc/riccati_kernels.cuh lane_iters: a segment's entries a lane."""
    return -(-n // LANES)


def test_round_tables_cover_every_entry_once():
    """Each round's entries are every product entry once, segment after
    segment in the order of the outputs (lane l takes entries l, l + 32, ...
    of each segment)."""
    S, C = 7, 2
    off, _, tab, diag = _round_tables(S, C)
    assert tab["r1"][0].shape == (S * S + S * C + S + C, S)
    assert tab["r2"][0].shape == (S * S + C * S + C * C, S)
    assert tab["r4a"][0].shape == (S * S + S, C)
    assert int(diag.sum()) == C
    # round 1's VA[r][c] reads Vxx row r and A column c
    e = 3 * S + 5
    assert tab["r1"][0][e].tolist() == [off["Vxx"] + 3 * S + k for k in range(S)]
    assert tab["r1"][1][e].tolist() == [off["A"] + k * S + 5 for k in range(S)]
    # sums a lane runs a step at S = 7: VA, VB, qx, qu; qxx, qux, quu; Vxx
    # (two sums an entry), Vx
    segments = ([S * S, S * C, S, C], [S * S, C * S, C * C], [S * S, S * S, S])
    assert [sum(lane_iters(n) for n in seg) for seg in segments] == [5, 4, 5]


# ---------------------------------------------------------------------------
# B4's staged form
# ---------------------------------------------------------------------------
def _stage_at(j, c, i, C, NS):
    """StageLayout<NS, C>::at: step j's row c (c = C: the LR term), sample i."""
    return (j * (C + 1) + c) * (NS + 1) + i


def staged_rollout_lanes(dynamics, cost, sampler, x0, mean, seed, K, stride, state, NS=64):
    """The staged kernel's schedule: per block of NS samples and chunk of 32
    steps, the producers' tile into a flat stage, then the consumers' chain
    reading it. Returns (costs, crash, U, W)."""
    T, C = mean.shape
    kind = fr.noise_kind(sampler)
    sigma, _ = fr.sample_tables(sampler, kind, mean, 0, state)
    U, W = fr.sample_plain(dynamics, sampler, kind, mean, seed, K, 0, stride, state)
    coeff = sampler.control_cost_coeff
    gain = torch.tensor(fr._lr_gain(LAM, ALPHA), dtype=torch.float32)
    pure = sampler._pure_noise_mask(K)
    n_blocks, n_chunks = -(-K // NS), -(-T // CHUNK)
    stage_len = CHUNK * (C + 1) * (NS + 1)
    x = x0[:, None].expand(-1, K).clone()
    rec = broadcast_rec(dynamics.init_recurrent_state(), K)
    crash = torch.zeros((K,), dtype=torch.int32)
    acc = torch.zeros((K,), dtype=torch.float32)
    y = None
    for ch in range(n_chunks):
        t0 = ch * CHUNK
        stage = torch.full((n_blocks, stage_len), float("nan"))
        # producers: warp w, samples w, w + 8, ...; lane j, step t0 + j
        for b in range(n_blocks):
            for w in range(PRODUCER_WARPS):
                for i in range(w, NS, PRODUCER_WARPS):
                    k = b * NS + i
                    lanes = [j for j in range(LANES) if t0 + j < T]
                    if k >= K or not lanes:
                        continue
                    ts = torch.tensor([t0 + j for j in lanes])
                    u = U[k, ts]  # (lanes, C): sample_controls' controls
                    lr = torch.zeros(len(lanes))
                    for c in range(C):
                        mu = torch.where(pure[k], 0.0, mean[ts, c])
                        sg = sigma[ts, c]
                        lr = lr + coeff[c] * mu * (mu - 2.0 * u[:, c]) / (sg * sg)
                    lr = gain * lr
                    for c in range(C + 1):
                        idx = torch.tensor([_stage_at(j, c, i, C, NS) for j in lanes])
                        stage[b, idx] = u[:, c] if c < C else lr
        # consumers: sample i of block b reads its slots step by step
        ks = torch.arange(K)
        blocks, slots = ks // NS, ks % NS
        for j in range(min(CHUNK, T - t0)):
            t = t0 + j
            u = torch.stack([stage[blocks, _stage_at(j, c, 0, C, NS) + slots]
                             for c in range(C)])  # (C, K)
            lr_t = stage[blocks, _stage_at(j, C, 0, C, NS) + slots]
            x, y, rec = dynamics.kernel_step_recurrent(x, rec, u, float(t), DT)
            c_t, crash = cost.running_cost(y, u, t, crash)
            acc = acc + c_t + lr_t
    return fr.true_div(acc + cost.terminal_cost(y), T), crash, U, W


def _pair(name):
    if name == "di_circle":
        return (DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                torch.tensor([2.0, 0.0, 0.0, 2.0]), [1.0, 1.0], 0.0)
    from test_torch_sample_pairs import pair_parts
    _, _, dyn, cost, x0, std, offset = pair_parts(name)
    x0 = torch.from_numpy(x0).clone()
    x0[0] -= 0.06  # 6 cm further from the gate's post: over T = 33 a part crashes
    return dyn, cost, x0, std, float(offset[-1])


@pytest.mark.parametrize("K,T", [(65, 33), (129, 65)])
@pytest.mark.parametrize("kind", ["gaussian", "smooth"])
@pytest.mark.parametrize("name", ["di_circle", "quadrotor_map"])
def test_staged_b4_tiling_matches_the_plain_version(name, kind, K, T):
    stride = 2
    dyn, cost, x0, std, offset = _pair(name)
    C = dyn.CONTROL_DIM
    kw = dict(std_dev=std, control_cost_coeff=[0.5] * C, pure_noise_percentage=0.1)
    samp = (SmoothMPPIDistribution.create(num_timesteps=T, dt=0.05, **kw) if kind == "smooth"
            else GaussianDistribution.create(**kw))
    rng = np.random.default_rng(len(name) + K)
    mean = torch.from_numpy((0.3 * rng.normal(size=(T, C))).astype(np.float32))
    mean[:, -1] += offset
    state = (torch.from_numpy((0.3 * rng.normal(size=(T, C))).astype(np.float32))
             if kind == "smooth" else None)
    seed = torch.tensor(17, dtype=torch.int32)
    pc, pcrash, pU, pW = fr.sample_rollout_plain(
        dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K, optimization_stride=stride,
        sampler_state=state)
    lc, lcrash, lU, lW = staged_rollout_lanes(dyn, cost, samp, x0, mean, seed, K, stride,
                                              state)
    assert torch.isfinite(pc).all()
    assert torch.equal(lc, pc)
    assert torch.equal(lcrash, pcrash)
    assert torch.equal(lU, pU)
    if kind == "smooth":
        assert torch.equal(lW, pW)
    if name == "quadrotor_map" and kind == "gaussian" and T == 33:
        assert 0 < int(pcrash.sum()) < K  # a mixed crash population


@pytest.mark.parametrize("C", [1, 2, 4])
def test_stage_slots_are_distinct_and_in_range(C):
    """Every (step, row, sample) of a stage has its own slot inside the
    stage, and consecutive consumers read consecutive words."""
    NS = 64
    slots = {_stage_at(j, c, i, C, NS) for j in range(CHUNK) for c in range(C + 1)
             for i in range(NS)}
    assert len(slots) == CHUNK * (C + 1) * NS
    assert max(slots) < CHUNK * (C + 1) * (NS + 1)
    assert _stage_at(3, 1, 7, C, NS) + 1 == _stage_at(3, 1, 8, C, NS)
