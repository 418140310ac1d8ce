"""Smoke run of the PyTorch/CUDA port (mppi_generic_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mppi_generic_tpu_torch/csrc`` (into
``build/torch_kernels/``), holds each kernel against its plain PyTorch
version on the card, checks the in-kernel Philox draw bit for bit and by
its statistics, and drives six closed loops through the port's entry
points: the flagship vanilla MPPI (double integrator, circle cost, Gaussian
sampler, K=8192, T=100) on the precomputed-noise kernels, RMPPI and
Tube-MPPI with DDP feedback on the same task (bench.py:809-840: K=2560,
T=50, lambda 2, 9 candidates x 256 samples for RMPPI), and the fused solve
(``kernel="fused_solve"``, the samples drawn in the kernels) for the
flagship and the JAX suite's NLN and Smooth-MPPI rows (bench.py:619-638,
K=8192, T=100). Then AutoRally (bench.py:704-717 and :775-789: the 6-32-32-4
network dynamics and ARStandardCost on the 128^2 and the 4 x 1024^2
channel-major track maps, K=1920, T=150): the fused solve and rollout
kernels' AutoRally entries against their plain versions
(``autorally_kernels``), a fused-vs-combined reference, and three closed
loops with the AutoRally model as the plant (``autorally``,
``autorally_1024`` on the fused solve, ``autorally_fused`` on
``kernel="fused"``). Then the colored-noise rows (bench.py:641-702): the
rollout kernel's Tsallis mode, the Tsallis reduction kernel and the merge
against their plain versions (``tsallis_kernels``, DI at K=8192 and 8000,
T=100), the rollout kernel's bicycle-slip entry on the 128^2 track map
(``bicycle_kernels``, K=1920 and 1900, T=100), a fused-vs-combined
reference without host syncs (``colored_reference``), and three closed
loops on ``kernel="fused"``: ``colored_fused`` (normExp), ``colored_tsallis``
(Tsallis, gamma 10, r 2) and ``bicycle_colored``. Then the analytic model
zoo (``zoo_kernels``): the cartpole (bench.py:599-608), the quadrotor with
QuadrotorQuadraticCost or QuadrotorMapCost (on a synthetic 512^2 map with
one gate), the Dubins car with QuadraticCost (a fixed goal and a goal
trajectory) and the double integrator with QuadraticCost, each pair's B1
entry in four modes and its B3 entry (the cartpole's also B4) against their
plain versions at K=8192, T=100 (the cartpole also at the ragged K=8000);
a check that the eager path divides as the kernels do (``division``,
lambda 0.3, T = 100); the zoo's closed loops (``cartpole_fused_solve``, the
bench row; ``cartpole_swingup``, tests/test_vanilla_mppi.py:80-107 at
K=8192 with its bar; ``quadrotor_hover``, tests/test_model_zoo.py:60-92 with
its bar; ``quadrotor_waypoint``; ``di_quadratic``; short loops that put each
remaining entry on a main path) and two more bench rows
(``bicycle_1024``, bench.py:755-773, and ``di_K1024``, :593-597). Each phase
prints one JSON line. The line before the last lists every kernel with its launches on
the main path, its error against the plain version and its times; the last
line is
``{"ok": true, "device": {...}}``. Any failed check ends the run with a
non-zero exit and no result line. Without CUDA it exits non-zero at once.

Times come from CUDA events. Each timed call is preceded by a device-side
sleep, so the events measure the device and not the host's enqueue.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from mppi_generic_tpu_torch import (
    ColoredMPPI,
    ColoredNoiseDistribution,
    DDPFeedback,
    GaussianDistribution,
    NLNDistribution,
    RobustMPPI,
    SmoothMPPIDistribution,
    TubeMPPI,
    VanillaMPPI,
)
from mppi_generic_tpu_torch.costs import (
    ARStandardCost,
    CartpoleQuadraticCost,
    DoubleIntegratorCircleCost,
    QuadraticCost,
    QuadrotorMapCost,
    QuadrotorQuadraticCost,
)
from mppi_generic_tpu_torch.feedback.ilqr import _alpha_ladder, linearize
from mppi_generic_tpu_torch.maps import MapTexture2D
from mppi_generic_tpu_torch.models import (
    AutorallyNNDynamics,
    BicycleSlipDynamics,
    CartpoleDynamics,
    DoubleIntegratorDynamics,
    DubinsDynamics,
    QuadrotorDynamics,
    rollout_single,
)
from mppi_generic_tpu_torch.ops import _build, fused_solve, philox, riccati, weights
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops.rollout import rollout_combined

K_MAIN, K_RAGGED, T, C, S = 8192, 8000, 100, 2, 4
DT, LAM, ALPHA = 0.02, 1.0, 0.0
CLOSED_LOOP_STEPS = 100
N_TIMED, N_TIMED_PLAIN = 100, 10

# the robust controllers' configuration (bench.py:809-840)
K_R, K_R_RAGGED, T_R = 2560, 2500, 50
LAM_R, THRESH_R = 2.0, 20.0
N_CAND, S_PER = 9, 256
N_ALPHA = 14
X0 = [2.0, 0.0, 0.0, 1.0]
BAND = (1.5, 2.5)  # the radius band of tests/test_tube_robust.py:181-199
MAX_OUT_OF_BAND = 10

# one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# operations per sample-step that the rollout always does (csrc/rollout_kernel.cuh):
# Euler step 8, circle cost 20 (the crash term's exp/log runs only off the
# track and is not counted), LR 16, accumulate 1
OPS_STEP, OPS_COST, OPS_LR, OPS_ACC = 8, 20, 16, 1
# the RMPPI kernel per sample-step: two steps and two costs, two clamps of C
# channels (5 each), the feedback K (x_r - x_n) (S + C (2S - 1)), its cost
# (5 per channel + 1), u_raw + u_fb, three accumulations
OPS_RMPPI = 2 * OPS_STEP + 2 * OPS_COST + 2 * 5 * C + S + C * (2 * S - 1) + 5 * C + 1 + C + 4
# The in-kernel draw per sample-step (csrc/philox.cuh): ten Philox rounds of
# two 32 x 32 products (high and low words: 4 operations) and 4 xors, with 2
# key additions in the last nine; Box-Muller: 2 shifts, 2 conversions, an
# add, 4 multiplies and logf, sqrtf, cosf, sinf. The accurate transcendentals
# (no fast math) are software sequences on the FMA pipes: each is counted as
# OPS_TRANSCENDENTAL fp32 operations, not as one SFU instruction. Integer
# operations are counted against the fp32 rate (the H100 issues INT32 at half
# of it), which keeps the bound below what the card can reach.
OPS_TRANSCENDENTAL = 20
OPS_PHILOX = 10 * (4 + 4) + 9 * 2
OPS_BOX_MULLER = 9 + 4 * OPS_TRANSCENDENTAL
SAMPLERS = ("gaussian", "nln", "smooth")
DT_SMOOTH = 0.02  # bench.py:634

# AutoRally (bench.py:704-717 and :775-789): 6-32-32-4 network, ARStandardCost,
# Gaussian std [0.3, 0.5], K=1920, T=150, dt 0.02, lambda 1, alpha 0, x0 = 0
# with v_x = 3; the 128^2 map of bench.py:641-644 and the 4 x 1024^2
# channel-major map of :773-778. The network is random (numpy seed 0, scale
# 0.1 as FNN.create), since the bench's comes from a JAX key.
K_AR, K_AR_RAGGED, T_AR, S_AR = 1920, 1900, 150, 7
AR_STD = [0.3, 0.5]
AR_MAPS = ("128", "1024")
AR_FUSED_LOOP_STEPS = 20  # the kernel="fused" loop: B1 on the path, kept short
N_TIMED_PLAIN_AR = 3  # an AutoRally plain version takes seconds
# Operations per sample-step of the AutoRally step (csrc/autorally_nn.cuh):
# the FNN's 1,344 multiplies and 1,344 adds, 68 bias adds and 64 tanhf; the
# kinematics (cosf, sinf, 4 multiplies, 2 adds, a negation), the Euler update
# (7 multiplies, 7 adds) and the yaw wrap (fmodf and 4 more).
FNN_MACS = 6 * 32 + 32 * 32 + 32 * 4
OPS_AR_STEP = (2 * FNN_MACS + 68 + 64 * OPS_TRANSCENDENTAL + 2 * OPS_TRANSCENDENTAL + 7
               + 14 + OPS_TRANSCENDENTAL + 4)
# The cost (csrc/ar_standard_cost.cuh): cosf, sinf, the two points (4), two
# map queries (the world transform 17, two sample positions 16, four texel
# addresses 12, the lerp 9: 54 each), the track term 8, speed 3, the slip
# (division, the atan polynomial with its inversion: 20) and its terms 6, the
# rollover test 2, the sum and its guard 5. The crash term's expf/logf runs
# only once a sample has crashed and is not counted.
OPS_AR_COST = 2 * OPS_TRANSCENDENTAL + 4 + 2 * 54 + 8 + 3 + 20 + 6 + 2 + 5

# The colored rows (bench.py:641-702): DI + circle cost with colored noise
# (std [1, 1], exponents [1, 2]) at K=8192, T=100, normExp or Tsallis (gamma
# 10, r 2); a gamma small enough that some Tsallis weights are exactly 0 (as
# tests/test_pallas_rollout.py:581-604); the bicycle-slip model with
# ARStandardCost on the 128^2 map, output_indices (0, 1, 2, 8, 5, 6), colored
# std [0.3, 0.5], exponents [1, 1], K=1920, T=100, x0 = 0.
COLORED_STD, COLORED_EXPONENTS = [1.0, 1.0], [1.0, 2.0]
GAMMA, R_TS = 10.0, 2.0
GAMMA_SMALL, R_SMALL = 1.0, 2.4
K_BI, K_BI_RAGGED, T_BI, S_BI = 1920, 1900, 100, 10
BI_STD, BI_EXPONENTS = [0.3, 0.5], [1.0, 1.0]
BI_OUTPUT_INDICES = (0, 1, 2, 8, 5, 6)
# The bicycle step per sample-step (csrc/bicycle_slip.cuh): the lags and
# their clamps 11, the forces 16 plus four tanhf, the wheel angle (a division
# and tanf) and its sinf and cosf, the yaw rate 6, the two accelerations 18,
# the kinematics cosf, sinf and 6, the Euler update 20, the yaw wrap (fmodf
# and 4 more) and the two clamps 4.
OPS_BI_STEP = 11 + 16 + 1 + 6 + 18 + 6 + 20 + 4 + 4 + 10 * OPS_TRANSCENDENTAL
# the Tsallis weight per sample: the difference, the division, 1 -, the
# clamp, the comparison, logf, the multiply, expf
OPS_TSALLIS_W = 6 + 2 * OPS_TRANSCENDENTAL

TOL = {  # (rtol, atol)
    # the same operations in the same order: agree to the last bit
    "costs": (1e-5, 1e-6),
    # block sums of w_k U_kj taken in another order; rtol is relative to the
    # sum of absolute terms, since the sums cancel
    "carry": (1e-5, 1e-6),
    # different reduction order over 8192 samples
    "new_mean": (1e-4, 1e-5),
    "baseline": (1e-6, 0.0),
    "eta": (1e-5, 0.0),
    # the RMPPI, Riccati and ladder kernels repeat their plain versions'
    # operations in order: agree to the last bit
    "exact": (1e-5, 1e-6),
    # the fused and the eager (combined) robust solves: sums in another
    # order (the LR and feedback costs, the feedback product)
    "solve": (1e-4, 1e-5),
    # the AutoRally kernels repeat their plain versions' operations in order,
    # tanhf included: U and costs to the last bit
    "bitwise": (0.0, 0.0),
}


T_START = time.perf_counter()


def emit(phase, **fields):
    """One JSON line per phase, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - T_START, 1)}), flush=True)


def check(what, got, want, tol, scale=None):
    """Fail unless |got - want| <= atol + rtol * scale everywhere, where
    scale is |want| unless given; return the max abs and rel errors."""
    rtol, atol = TOL[tol]
    got, want = got.double(), want.double()
    scale = want.abs() if scale is None else scale.double()
    err = (got - want).abs()
    rel = err / want.abs().clamp_min(1e-30)
    max_abs, max_rel = float(err.max()), float(rel.max())
    bad = err > atol + rtol * scale
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements outside rtol={rtol} atol={atol}"
            f" (max abs {max_abs}, max rel {max_rel})")
    return {"check": what, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "rtol": rtol, "atol": atol}


def within(what, got, want, atol):
    """Fail unless |got - want| <= atol everywhere (a derived tolerance)."""
    err = float((got.double() - want.double()).abs().max())
    if not err <= atol:
        raise AssertionError(f"{what}: max abs error {err} > {atol}")
    return {"check": what, "max_abs_err": err, "atol": atol}


def time_ms(fn, n):
    """Median device milliseconds of ``fn`` over ``n`` runs."""
    for _ in range(3):
        fn()
    start = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        torch.cuda._sleep(1_000_000)
        start[i].record()
        fn()
        end[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(start, end))


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rollout_work(K, epilogue, with_lr):
    """(bytes, operations) the rollout function needs: U, x0, the cost
    parameters and the LR tables read once; costs, crash and the carry
    rows written once."""
    nb = -(-K // fr.BLOCK)
    n_bytes = 4 * (K * T * C + S + len(DoubleIntegratorCircleCost.PARAM_NAMES)
                   + 2 * K)
    per_step = OPS_STEP + OPS_COST + OPS_ACC + (OPS_LR if with_lr else 0)
    n_ops = K * T * per_step + 2 * K
    if with_lr:
        n_bytes += 4 * (2 * T * C + C)
    if epilogue:
        n_bytes += 4 * nb * (2 + T * C)
        n_ops += 5 * K + 2 * K * T * C  # s, max, exp, sum; weighted sum
    return n_bytes, n_ops


def combine_work(nb, T_=T):
    TC = T_ * C
    return 4 * (nb * (2 + TC) + TC + 2), 4 * nb + 2 * nb * TC + TC + 1


def sampling_ops(kind, solve):
    """Operations per sample-step of the fused solve (B3, ``solve``) or the
    sampling kernel (B4): the draw (NLN: two Box-Muller pairs and expf per
    channel), carve-outs (4 per channel, Smooth-MPPI 3 more), clamp (7), LR
    (B3 5, B4 7 and the gain), step, cost and accumulation."""
    ops = OPS_PHILOX + (2 if kind == "nln" else 1) * OPS_BOX_MULLER
    per_channel = 4 + 7 + (5 if solve else 7)
    if kind == "nln":
        per_channel += OPS_TRANSCENDENTAL + 2
    if kind == "smooth":
        per_channel += 3
    return ops + C * per_channel + OPS_STEP + OPS_COST + OPS_ACC + (0 if solve else 2)


def sampling_work(K, kind, solve, epilogue, emit_u, emit_w):
    """(bytes, operations) of the function of B3 or B4: the (T, C) tables
    (mean, sigma, NLN/Smooth aux, B3's coeff / sigma^2), coefficients,
    constraints, x0, cost parameters and seed read once; costs, crash, the
    carry rows and the emitted U / W written once."""
    nb = -(-K // fr.BLOCK)
    tables = 2 + (kind != "gaussian") + (1 if solve else 0)
    n_bytes = 4 * (tables * T * C + (0 if solve else C) + 4 * C + S
                   + len(DoubleIntegratorCircleCost.PARAM_NAMES) + 1 + 2 * K
                   + K * T * C * (int(emit_u) + int(emit_w)))
    n_ops = K * T * sampling_ops(kind, solve) + 2 * K
    if epilogue:
        n_bytes += 4 * nb * (2 + T * C)
        n_ops += 5 * K + 2 * K * T * C
    return n_bytes, n_ops


def make_sampler(kind, dev=None, p=0.0):
    """The JAX suite's samplers (bench.py:31-50, :619-638): std 1; the
    Gaussian flagship's coefficient 0.01, NLN and Smooth-MPPI the default 1."""
    kw = dict(std_dev=[1.0, 1.0], pure_noise_percentage=p)
    if dev is not None:
        kw["device"] = dev
    if kind == "nln":
        return NLNDistribution.create(**kw)
    if kind == "smooth":
        return SmoothMPPIDistribution.create(num_timesteps=T, dt=DT_SMOOTH, **kw)
    return GaussianDistribution.create(control_cost_coeff=[0.01, 0.01], **kw)


def same(what, a, b):
    if not torch.equal(a, b):
        raise AssertionError(f"{what} differ from the plain version")


def philox_phase(dev):
    """The in-kernel draw alone: the sampling kernel with a zero mean, unit
    sigma and no constraints emits its raw Philox normals, which must equal
    the plain draw bit for bit and pass the statistics battery of
    scripts/tpu_selfcheck.py:86-118; NLN's draw passes its moment checks
    (:121-149)."""
    dyn = DoubleIntegratorDynamics.create(device=dev)  # no constraints
    cost = DoubleIntegratorCircleCost(device=dev)
    x0 = torch.tensor(X0, device=dev)
    unit = GaussianDistribution.create(std_dev=[1.0, 1.0], device=dev)
    seed = torch.tensor(99, dtype=torch.int32, device=dev)
    _, _, U, _ = fr.fused_sample_rollout_costs(
        dyn, cost, unit, x0, torch.zeros((T, C), device=dev), seed, DT, LAM, ALPHA,
        K_MAIN)
    z = philox.normals(seed, K_MAIN, T, C)[0]
    torch.cuda.synchronize()
    err = float((U[1:] - z[1:]).abs().max())
    same("the kernel's Philox normals", U[1:], z[1:])  # sample 0 is the mean
    stats = philox.normal_battery(U[1:])
    bad = philox.normal_battery_failures(stats)
    s = 0.4
    nln = NLNDistribution.create(std_dev=[s, s], control_cost_coeff=[0.01, 0.02],
                                 pure_noise_percentage=0.1, device=dev)
    mean = torch.tensor([0.3, -0.2], device=dev).expand(T, C).contiguous()
    _, _, Un, _ = fr.fused_sample_rollout_costs(
        dyn, cost, nln, x0, mean, torch.tensor(77, dtype=torch.int32, device=dev), DT,
        LAM, ALPHA, K_MAIN, optimization_stride=3)
    same("NLN sample 0", Un[0], mean)
    same("NLN frozen head", Un[5, :3], mean[:3])
    moments = philox.nln_moments((Un[1: int(0.9 * K_MAIN), 10:] - mean[10:]) / s, s)
    bad += philox.nln_moment_failures(moments)
    if bad:
        raise AssertionError(f"the in-kernel draw fails its statistics: {bad}")
    emit("philox", K=K_MAIN, T=T, C=C, max_abs_err=err, battery=stats, nln=moments)
    return err


def fused_kernel_phase(dev, K, p, stride, seed):
    """B3 (Gaussian, NLN) and B4 (Gaussian, NLN, Smooth-MPPI; and Smooth-
    MPPI with its epilogue) against their plain versions; at K_MAIN also
    their times and bounds, and torch.randn at the same size."""
    g = torch.Generator(device=dev).manual_seed(seed)
    # the main path's unconstrained DI; the ragged case adds a clamp
    cons = ({} if K == K_MAIN else
            dict(control_ranges=[[-2.0, 2.0], [-1.5, 1.5]], control_deadband=[0.05, 0.0]))
    dyn = DoubleIntegratorDynamics.create(device=dev, **cons)
    cost = DoubleIntegratorCircleCost(device=dev)
    x0 = torch.tensor(X0, device=dev)
    mean = 0.3 * torch.randn((T, C), generator=g, device=dev)
    dmean = 0.3 * torch.randn((T, C), generator=g, device=dev)
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    b3, b4, times = [], [], {}
    for kind in ("gaussian", "nln"):
        args = (dyn, cost, make_sampler(kind, dev, p), x0, mean, seed_t, DT, LAM,
                ALPHA, K)
        kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(
            *args, optimization_stride=stride)
        pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(
            *args, optimization_stride=stride)
        km, kb, ke = fr.flash_combine(kcarry, T, C, LAM)
        pm, pb, pe = fr.flash_combine_plain(pcarry, T, C, LAM)
        torch.cuda.synchronize()
        same(f"B3 {kind} crash flags", kcrash, pcrash)
        b3 += [check(f"B3 {kind} U", kU, pU, "exact"),
               check(f"B3 {kind} costs", kc, pc, "costs"),
               check(f"B3 {kind} carry", kcarry, pcarry, "carry",
                     fr.block_carries_plain(pc, pU.abs(), LAM).abs()),
               check(f"B3 {kind} new_mean", km, pm, "new_mean"),
               check(f"B3 {kind} baseline", kb, pb, "baseline"),
               check(f"B3 {kind} eta", ke, pe, "eta")]
        if K == K_MAIN:
            t = timed(lambda: fused_solve.fused_solve_carries(*args),
                      lambda: fused_solve.fused_solve_plain(*args))
            t["bound_ms"], t["bound_by"] = bound_ms(
                *sampling_work(K, kind, True, True, False, False))
            times[f"solve {kind}"] = t
    for kind, epilogue in (("gaussian", False), ("nln", False), ("smooth", False),
                           ("smooth", True)):
        samp = make_sampler(kind, dev, p)
        state = dmean if kind == "smooth" else None
        args = (dyn, cost, samp, x0, mean, seed_t, DT, LAM, ALPHA, K)
        kout = fr.fused_sample_rollout_costs(*args, optimization_stride=stride,
                                             sampler_state=state, epilogue=epilogue)
        pc, pcrash, pU, pW = fr.sample_rollout_plain(
            *args, optimization_stride=stride, sampler_state=state)
        torch.cuda.synchronize()
        name = f"B4 {kind}{' epilogue' if epilogue else ''}"
        same(f"{name} crash flags", kout[1], pcrash)
        b4 += [check(f"{name} U", kout[2], pU, "exact"),
               check(f"{name} costs", kout[0], pc, "costs")]
        if epilogue:
            pm, pb, pe = fr.flash_combine_plain(fr.block_carries_plain(pc, pW, LAM),
                                                T, C, LAM)
            b4 += [check(f"{name} new_deriv_mean", kout[3], pm, "new_mean"),
                   check(f"{name} baseline", kout[4], pb, "baseline"),
                   check(f"{name} eta", kout[5], pe, "eta")]
        elif kind == "smooth":
            b4.append(check(f"{name} W", kout[3], pW, "exact"))
        if K == K_MAIN:
            kid = fr.noise_kind(samp)

            def kernel(epilogue=epilogue, samp=samp, state=state, kid=kid):
                # the kernel alone, as the main path launches it (U not kept)
                return fr._sample_rollout_cuda(
                    dyn, cost, samp, kid, x0, mean, seed_t, DT, LAM, ALPHA, K, 0, 0,
                    state, epilogue, False, None)

            def plain(epilogue=epilogue, args=args, state=state):
                out = fr.sample_rollout_plain(*args, sampler_state=state)
                return fr.block_carries_plain(out[0], out[3], LAM) if epilogue else out

            t = timed(kernel, plain)
            t["bound_ms"], t["bound_by"] = bound_ms(*sampling_work(
                K, kind, False, epilogue, not epilogue, kind == "smooth" and not epilogue))
            times[name[3:]] = t
    if K == K_MAIN:
        # the draw alone, as one library call: a yardstick, not the function
        times["randn_reference_ms"] = time_ms(
            lambda: torch.randn((K, T, C), device=dev), N_TIMED)
    emit("fused_solve_kernels", K=K, T=T, pure_noise_percentage=p, stride=stride,
         checks=b3 + b4, times=times)
    return b3, b4, times


def make_inputs(dev, K, p, seed):
    """The main path's kernel inputs: samples drawn by the port's sampler
    around a random mean, clamped, and its LR tables."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dyn = DoubleIntegratorDynamics.create(device=dev)
    cost = DoubleIntegratorCircleCost(device=dev)
    sampler = GaussianDistribution.create(std_dev=[1.0, 1.0],
                                          control_cost_coeff=[0.01, 0.01],
                                          pure_noise_percentage=p, device=dev)
    mean = 0.3 * torch.randn((T, C), generator=g, device=dev)
    U, _ = sampler.sample(g, mean, K)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    x0 = torch.tensor([2.0, 0.0, 0.0, 1.0], device=dev)
    lr = (mean, sampler._sigma(T, 0).contiguous(), sampler.control_cost_coeff,
          LAM, ALPHA, sampler.pure_threshold(K))
    return dyn, cost, x0, U, lr


def kernel_phase(dev, K, p, seed):
    dyn, cost, x0, U, lr = make_inputs(dev, K, p, seed)
    checks, times = [], {}
    # kernel 1, plain-costs mode, without and with the LR cost
    for with_lr in (False, True):
        lrp = lr if with_lr else None
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp)
        pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
        torch.cuda.synchronize()
        checks.append(check(f"costs(lr={with_lr})", kc, pc, "costs"))
        if not torch.equal(kcrash, pcrash):
            raise AssertionError("crash flags differ from the plain version")
        mode = f"costs{'+lr' if with_lr else ''}"
        times[mode] = {
            "ms": time_ms(lambda: fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp), N_TIMED),
            "plain_ms": time_ms(lambda: fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp),
                                N_TIMED_PLAIN),
        }
        times[mode]["bound_ms"], times[mode]["bound_by"] = bound_ms(
            *rollout_work(K, False, with_lr))
    # kernel 1, exp-epilogue mode, with LR (the main path's mode)
    kc, kcrash, kcarry = fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr)
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    pcarry = fr.block_carries_plain(pc, U, LAM)
    checks.append(check("epilogue costs", kc, pc, "costs"))
    # m, d and sum_k w_k |U_kj|: the magnitude each carry entry is summed from
    carry_scale = fr.block_carries_plain(pc, U.abs(), LAM).abs()
    checks.append(check("epilogue carry", kcarry, pcarry, "carry", carry_scale))
    if not torch.equal(kcrash, pcrash):
        raise AssertionError("epilogue crash flags differ from the plain version")
    times["epilogue+lr"] = {
        "ms": time_ms(lambda: fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr),
                      N_TIMED),
        "plain_ms": time_ms(
            lambda: fr.block_carries_plain(
                fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)[0], U, LAM),
            N_TIMED_PLAIN),
        # one-call yardstick for the weighting + weighted sum (not used by the port)
        "library_ms": time_ms(
            lambda: torch.softmax(-pc / LAM, 0) @ U.view(K, -1), N_TIMED),
    }
    times["epilogue+lr"]["bound_ms"], times["epilogue+lr"]["bound_by"] = bound_ms(
        *rollout_work(K, True, True))
    # kernel 2 on the same (plain) carries, then the whole kernel chain
    km, kb, ke = fr.flash_combine(pcarry, T, C, LAM)
    pm, pb, pe = fr.flash_combine_plain(pcarry, T, C, LAM)
    checks.append(check("flash_combine new_mean", km, pm, "new_mean"))
    checks.append(check("flash_combine baseline", kb, pb, "baseline"))
    checks.append(check("flash_combine eta", ke, pe, "eta"))
    nb = pcarry.shape[0]
    times["flash_combine"] = {
        "ms": time_ms(lambda: fr.flash_combine(pcarry, T, C, LAM), N_TIMED),
        "plain_ms": time_ms(lambda: fr.flash_combine_plain(pcarry, T, C, LAM), N_TIMED),
    }
    times["flash_combine"]["bound_ms"], times["flash_combine"]["bound_by"] = bound_ms(
        *combine_work(nb))
    _, _, fm, fb, fe = fr.fused_weighted_rollout(dyn, cost, x0, U, DT, LAM, lr)
    checks.append(check("fused_weighted_rollout new_mean", fm, pm, "new_mean"))
    checks.append(check("fused_weighted_rollout baseline", fb, pb, "baseline"))
    checks.append(check("fused_weighted_rollout eta", fe, pe, "new_mean"))
    emit("kernels", K=K, T=T, pure_noise_percentage=p, checks=checks, times=times)
    return checks, times


def reference_phase(dev):
    """One full-width solve through the kernels against the eager oracle
    (kernel="combined") on the same injected noise."""
    fused, combined = build_vanilla("gaussian", "fused"), build_vanilla("gaussian", "combined")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    eps = torch.randn((K_MAIN, T, C), generator=g, device=dev)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0], device=dev)
    state = fused.init_state(seed=0)
    rf, _ = fused.solve(x, state, injected_noise=eps)
    rc, _ = combined.solve(x, state, injected_noise=eps)
    checks = [
        check("solve control_mean vs combined", rf.control_mean, rc.control_mean,
              "new_mean"),
        check("solve costs vs combined", rf.costs, rc.costs, "new_mean"),
        check("solve baseline vs combined", rf.baseline, rc.baseline, "eta"),
        check("solve state_trajectory vs combined", rf.state_trajectory,
              rc.state_trajectory, "new_mean"),
    ]
    emit("reference", K=K_MAIN, T=T, checks=checks)


def build_vanilla(kind, kernel):
    """The flagship (bench.py:31-50) or the NLN / Smooth-MPPI rows
    (bench.py:619-638) on the card (the controller's default device)."""
    return VanillaMPPI(
        DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
        make_sampler(kind), dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T,
        num_rollouts=K_MAIN, num_iters=1, kernel=kernel)


def vanilla_loop_phase(path, ctrl, want, settle):
    """100 closed-loop steps from X0 through the entry points: slide, solve,
    plant step with the first control, then a profiler window. ``settle``:
    the flagship's bar (radius in [1.8, 2.2], baseline < 2 at the end), else
    fewer than MAX_OUT_OF_BAND steps outside BAND. Nothing in the loop
    waits on the device."""
    if ctrl.device.type != "cuda":
        raise AssertionError("the controller did not default to the card")
    cs = ctrl.init_state(seed=0)
    x = torch.tensor(X0, device=ctrl.device)
    n = CLOSED_LOOP_STEPS
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(n)]
    radii = []
    torch.cuda.synchronize()
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(n):
        ev[i][0].record()
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        ev[i][1].record()
        x, _ = ctrl.dynamics.step(x, res.control_mean[0], 0.0, ctrl.dt)
        ev[i][2].record()
        radii.append(torch.hypot(x[0], x[1]))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(fr.launch_counts)
    expect_launches(launches, want, path)
    r = torch.stack(radii).cpu()
    radius, baseline = float(r[-1]), float(res.baseline)
    out_of_band = int(((r <= BAND[0]) | (r >= BAND[1])).sum())
    for name, t in (("control_mean", res.control_mean), ("costs", res.costs),
                    ("state_trajectory", res.state_trajectory), ("radius", r)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{path}: {name} is not finite")
    if res.control_mean.shape != (T, C) or res.costs.shape != (K_MAIN,):
        raise AssertionError(f"{path}: unexpected result shapes")
    if settle and (not 1.8 <= radius <= 2.2 or not baseline < 2.0):
        raise AssertionError(f"{path}: closed loop did not settle: radius {radius}, "
                             f"baseline {baseline}")
    if not settle and out_of_band >= MAX_OUT_OF_BAND:
        raise AssertionError(f"{path}: {out_of_band} of {n} steps outside "
                             f"{BAND[0]} < r < {BAND[1]}")
    steady = ev[5:]  # the first solves include one-time allocations
    emit("main_path" if path == "vanilla" else f"{path}_main_path", K=K_MAIN, T=T,
         kernel=ctrl.kernel, sampler=type(ctrl.sampler).__name__,
         weight_transform=ctrl.weight_transform, steps=n,
         launches=launches, final_radius=radius, final_baseline=baseline,
         radius_range=[float(r.min()), float(r.max())], out_of_band_steps=out_of_band,
         solve_ms_median=statistics.median(e[0].elapsed_time(e[1]) for e in steady),
         step_ms_median=statistics.median(e[0].elapsed_time(e[2]) for e in steady),
         host_wall_ms_per_step=1e3 * wall_s / n)

    def step():
        s = ctrl.slide_control_sequence(cs, 1)
        res, _ = ctrl.solve(x, s)
        ctrl.dynamics.step(x, res.control_mean[0], 0.0, ctrl.dt)

    profile_steps(path, step)
    return launches


def fused_loop_phase(kind):
    """The fused solve's closed loop of one sampler."""
    kernel = "fused_sample_rollout_kernel" if kind == "smooth" else "fused_solve_kernel"
    n = CLOSED_LOOP_STEPS
    return vanilla_loop_phase(
        "vanilla_fused_solve" if kind == "gaussian" else kind,
        build_vanilla(kind, "fused_solve"), {kernel: n, "flash_combine_kernel": n},
        settle=kind == "gaussian")


def fused_reference_phase(dev):
    """One full-width kernel="fused_solve" solve per sampler against the
    eager oracle (kernel="combined") on the same injected normals; then one
    fused solve per sampler under torch.cuda.set_sync_debug_mode("error"),
    which raises on any host synchronisation."""
    g = torch.Generator(device=dev).manual_seed(31)
    x = torch.tensor(X0, device=dev)
    checks = []
    for kind in SAMPLERS:
        fused, combined = build_vanilla(kind, "fused_solve"), build_vanilla(kind, "combined")
        z = torch.randn((2 if kind == "nln" else 1, K_MAIN, T, C), generator=g,
                        device=dev)
        z = z if kind == "nln" else z[0]
        state = fused.init_state(seed=0)
        if kind == "smooth":
            state = state.replace(
                sampler_state=0.3 * torch.randn((T, C), generator=g, device=dev))
        rf, nf = fused.solve(x, state, injected_noise=z)
        rc, nc = combined.solve(x, state, injected_noise=z)
        for field in ("control_mean", "costs", "baseline", "state_trajectory"):
            checks.append(check(f"{kind} {field} vs combined", getattr(rf, field),
                                getattr(rc, field), "solve"))
        if kind == "smooth":
            checks.append(check("smooth derivative mean vs combined",
                                nf.sampler_state, nc.sampler_state, "solve"))
        same(f"{kind} crash flags of the fused and the eager solve", rf.crash, rc.crash)
        cs = fused.slide_control_sequence(nf, 1)
        fused.solve(x, cs)  # warm: one-time copies and the kernels' first load
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cs = fused.slide_control_sequence(cs, 1)
            fused.solve(x, cs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    emit("fused_solve_reference", K=K_MAIN, T=T, checks=checks,
         no_host_sync=list(SAMPLERS))


def expect_launches(launches, want, path):
    """Fail unless every kernel launched exactly as often as ``want`` says
    (kernels not named there: never)."""
    for name, count in launches.items():
        if count != want.get(name, 0):
            raise AssertionError(
                f"{path}: {name} launched {count} times, expected {want.get(name, 0)}")


def timed(fn, plain):
    return {"ms": time_ms(fn, N_TIMED), "plain_ms": time_ms(plain, N_TIMED_PLAIN)}


def riccati_ops(T_, S_=S, C_=C, n_alpha=0):
    """Floating-point operations of the backward recursion (T-1 steps) and,
    with n_alpha, the ladder's forward passes (csrc/riccati.cu)."""
    n = S_ + 1  # right-hand sides of the (C, C) solve
    solve = sum(1 + (C_ - p - 1) * (1 + 2 * (C_ - p - 1) + 2 * n) for p in range(C_))
    solve += n * sum(2 * (C_ - r - 1) + 1 for r in range(C_))
    step = (S_ * S_ * (2 * S_ - 1) + S_ * C_ * (2 * S_ - 1)  # Vxx A, Vxx B
            + S_ * (2 * S_ + 1) + C_ * (2 * S_ + 1)  # qx, qu
            + S_ * S_ * 2 * S_ + C_ * S_ * (2 * S_ - 1) + C_ * C_ * 2 * S_ + C_  # qxx, qux, quu
            + solve + C_ * n  # solve, negate
            + S_ * S_ * 2 * C_ + 2 * S_ * S_ + S_ * 2 * C_)  # Vxx, symmetrise, Vx
    fwd = (S_ + C_ * (2 + 2 * S_ + 2)  # dx, u, clamp
           + S_ + C_ + 3 * S_ * S_ + 3 * C_ * C_ + 2  # tracking cost, dt, acc
           + 2 * S_)  # Euler step
    return (T_ - 1) * step + n_alpha * T_ * fwd


def di_linearisation(dev, T_):
    """ilqr_tracking's first iteration on the DI task: u_init from a seed,
    xs rolled from X0, the goal a circle of radius 2 at speed 2."""
    g = torch.Generator(device=dev).manual_seed(5)
    dyn = DoubleIntegratorDynamics.create(device=dev)
    us = 0.3 * torch.randn((T_, C), generator=g, device=dev)
    xs = rollout_single(dyn, torch.tensor(X0, device=dev), us, DT)[0][:-1].contiguous()
    ang = 2.0 * DT / 2.0 * torch.arange(T_, device=dev)
    goal_x = torch.stack([2 * torch.cos(ang), 2 * torch.sin(ang),
                          -2 * torch.sin(ang), 2 * torch.cos(ang)], dim=1)
    goal_u = torch.zeros((T_, C), device=dev)
    fb = DDPFeedback.create(dyn, DT)
    lin = linearize(dyn, xs, us, goal_x, goal_u, fb.Q, fb.R, fb.Q_f, DT)
    return dyn, fb, xs, us, goal_x, goal_u, lin


def riccati_phase(dev):
    """B6 and B7 at T=50, S=4, C=2, 14 alphas on a real DI linearisation."""
    dyn, fb, xs, us, goal_x, goal_u, lin = di_linearisation(dev, T_R)
    As, Bs, dLx, dLu, Vxx_T, Vx_T = lin
    Q, R, Qf = fb.Q, fb.R, fb.Q_f
    Qdt, Rdt = Q * DT, R * DT
    alphas = _alpha_ladder(N_ALPHA, device=dev)
    lo = torch.nan_to_num(dyn.control_ranges[:, 0], neginf=-1e30)
    hi = torch.nan_to_num(dyn.control_ranges[:, 1], posinf=1e30)
    ulim = torch.stack([lo, hi])
    back = (As, Bs, dLx, dLu, Q, R, Vxx_T, Vx_T)

    def plain_backward():
        return riccati.riccati_backward_plain(As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T,
                                              Vx_T, DT, 1e-6)

    def kernel_ladder():
        return riccati.riccati_ladder_solve(dyn, xs, us, As, Bs, dLx, dLu, Q, R, Qf,
                                            Vxx_T, Vx_T, goal_x, goal_u, alphas,
                                            lo, hi, DT)

    def plain_ladder():
        Ks, ks = plain_backward()
        return (Ks, ks) + riccati.ladder_forward_plain(
            dyn, xs, us, Ks, ks, goal_x, goal_u, Q, R, Qf, alphas, ulim, DT)

    kK, kk = riccati.riccati_backward(*back, DT)
    pK, pk = plain_backward()
    kl, pl = kernel_ladder(), plain_ladder()
    torch.cuda.synchronize()
    checks_b = [check("riccati_backward gains", kK, pK, "exact"),
                check("riccati_backward feedforward", kk, pk, "exact")]
    checks_l = [check(f"riccati_ladder {n}", a, b, "exact")
                for n, a, b in zip(("gains", "feedforward", "costs", "xs_new",
                                    "us_new"), kl, pl)]
    n_in = (As.numel() + Bs.numel() + dLx.numel() + dLu.numel() + 2 * S * S + C * C + S)
    n_out = T_R * C * S + T_R * C
    times = {
        "riccati_backward": timed(lambda: riccati.riccati_backward(*back, DT),
                                  plain_backward),
        "riccati_ladder": timed(kernel_ladder, plain_ladder),
    }
    times["riccati_backward"]["bound_ms"], times["riccati_backward"]["bound_by"] = (
        bound_ms(4 * (n_in + n_out), riccati_ops(T_R)))
    n_in_l = n_in + 2 * T_R * (S + C) + S * S + C * C + S * S + 2 * C + N_ALPHA
    n_out_l = n_out + N_ALPHA * (1 + T_R * (S + C))
    times["riccati_ladder"]["bound_ms"], times["riccati_ladder"]["bound_by"] = (
        bound_ms(4 * (n_in_l + n_out_l), riccati_ops(T_R, n_alpha=N_ALPHA)))
    for t in times.values():
        t["chain_steps"] = T_R - 1  # dependent Riccati steps on one thread
    emit("riccati_kernels", T=T_R, S=S, C=C, n_alpha=N_ALPHA,
         checks=checks_b + checks_l, times=times)
    return checks_b, checks_l, times


def rmppi_inputs(dev, K, seed):
    """Raw samples around a mean, DDP gains of the DI task, the sampler's
    sigma and coefficients: the RMPPI kernel's inputs on the main path."""
    g = torch.Generator(device=dev).manual_seed(seed)
    _, fb, xs, us, goal_x, goal_u, _ = di_linearisation(dev, T_R)
    gains = fb.compute_feedback(xs[0], goal_x, us).gains
    sampler = GaussianDistribution.create(std_dev=[1.0, 1.0], device=dev)
    mean = 0.3 * torch.randn((T_R, C), generator=g, device=dev)
    U, _ = sampler.sample(g, mean, K)
    x_nom = torch.tensor(X0, device=dev)
    x_real = x_nom + torch.tensor([0.08, -0.05, 0.1, -0.1], device=dev)
    return (fb.dynamics, DoubleIntegratorCircleCost(device=dev), x_nom, x_real, U,
            gains, sampler._sigma(T_R, 0), sampler.control_cost_coeff, DT, LAM_R, ALPHA)


def rmppi_phase(dev, K, seed):
    args = rmppi_inputs(dev, K, seed)
    kout = fr.fused_rmppi_rollout(*args)
    pout = fr.rmppi_rollout_plain(*args)
    torch.cuda.synchronize()
    checks = [check(f"rmppi {n}", a, b, "exact")
              for n, a, b in zip(("s_nom", "j_real", "s_fb"), kout[:3], pout[:3])]
    checks.append(check("rmppi U_real", kout[4], pout[4], "exact"))
    if not torch.equal(kout[3], pout[3]):
        raise AssertionError("RMPPI crash flags differ from the plain version")
    t = timed(lambda: fr.fused_rmppi_rollout(*args), lambda: fr.rmppi_rollout_plain(*args))
    n_bytes = 4 * (2 * K * T_R * C + 4 * K + T_R * C * S + T_R * C + C + 4 * C + 2 * S
                   + len(DoubleIntegratorCircleCost.PARAM_NAMES))
    t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, K * T_R * OPS_RMPPI + 3 * K)
    emit("rmppi_kernel", K=K, T=T_R, checks=checks, times=t)
    return checks, t


def x0_phase(dev):
    """The rollout kernel with one initial state per sample, at RMPPI's
    candidate evaluation (9 candidates x 256 samples, T=50)."""
    g = torch.Generator(device=dev).manual_seed(6)
    dyn = DoubleIntegratorDynamics.create(device=dev)
    cost = DoubleIntegratorCircleCost(device=dev)
    K = N_CAND * S_PER
    w = torch.linspace(0.0, 1.0, N_CAND, device=dev)[:, None]
    x0 = torch.tensor(X0, device=dev)
    cands = (1 - w) * x0 + w * (x0 + torch.tensor([0.1, 0.05, 0.0, 0.1], device=dev))
    x0s = cands.repeat_interleave(S_PER, dim=0).contiguous()
    sampler = GaussianDistribution.create(std_dev=[1.0, 1.0], device=dev)
    U, _ = sampler.sample(g, 0.3 * torch.randn((T_R, C), generator=g, device=dev), K)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0s, U, DT)
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0s, U, DT)
    torch.cuda.synchronize()
    checks = [check("costs(x0 per sample)", kc, pc, "costs")]
    if not torch.equal(kcrash, pcrash):
        raise AssertionError("x0-mode crash flags differ from the plain version")
    t = timed(lambda: fr.fused_rollout_costs(dyn, cost, x0s, U, DT),
              lambda: fr.rollout_costs_plain(dyn, cost, x0s, U, DT))
    n_bytes = 4 * (K * T_R * C + K * S + len(DoubleIntegratorCircleCost.PARAM_NAMES)
                   + 2 * K)
    t["bound_ms"], t["bound_by"] = bound_ms(
        n_bytes, K * T_R * (OPS_STEP + OPS_COST + OPS_ACC) + 2 * K)
    emit("x0_kernel", K=K, T=T_R, checks=checks, times=t)
    return checks, t


def build_robust(kernel="fused"):
    """bench.py:809-825 on the card (the controller's default device)."""
    dyn = DoubleIntegratorDynamics.create()
    return RobustMPPI(
        dyn, DoubleIntegratorCircleCost(), GaussianDistribution.create(std_dev=[1.0, 1.0]),
        feedback=DDPFeedback.create(dyn, DT), dt=DT, lam=LAM_R, alpha=ALPHA,
        num_timesteps=T_R, num_rollouts=K_R, num_candidates=N_CAND,
        samples_per_condition=S_PER, value_function_threshold=THRESH_R, kernel=kernel)


def build_tube(kernel="fused"):
    """bench.py:827-840 on the card."""
    dyn = DoubleIntegratorDynamics.create()
    return TubeMPPI(
        dyn, DoubleIntegratorCircleCost(), GaussianDistribution.create(std_dev=[1.0, 1.0]),
        feedback=DDPFeedback.create(dyn, DT), dt=DT, lam=LAM_R, alpha=ALPHA,
        num_timesteps=T_R, num_rollouts=K_R, nominal_threshold=THRESH_R, kernel=kernel)


def compare_systems(name, rf, rc, checks):
    for system in ("real", "nominal"):
        a, b = getattr(rf, system), getattr(rc, system)
        checks.append(check(f"{name} {system} control_mean", a.control_mean,
                            b.control_mean, "solve"))
        checks.append(check(f"{name} {system} costs", a.costs, b.costs, "solve"))
        checks.append(check(f"{name} {system} baseline", a.baseline, b.baseline,
                            "solve"))


def robust_reference_phase(dev):
    """Full-width RMPPI stage 1 + solve and one Tube solve through the
    kernels (kernel="fused") against the eager oracle (kernel="combined")
    on the same injected noise."""
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.tensor(X0, device=dev)
    fused, combined = build_robust("fused"), build_robust("combined")
    # a warm state with an initialized nominal system, so stage 1 evaluates
    # its candidates
    warm = fused.init_state(seed=0)
    warm, _ = fused.update_importance_sampling(x, warm, 1)
    _, warm = fused.solve(x, warm)
    x1 = x + torch.tensor([0.02, 0.04, -0.02, 0.0], device=dev)
    e1 = torch.randn((S_PER, T_R, C), generator=g, device=dev)
    e2 = torch.randn((K_R, T_R, C), generator=g, device=dev)
    outs = []
    for ctrl in (fused, combined):
        s1, fe = ctrl.update_importance_sampling(x1, warm, 1, injected_noise=e1)
        res, _ = ctrl.solve(x1, s1, injected_noise=e2)
        outs.append((s1, fe, res))
    (sf, fef, rf), (sc, fec, rc) = outs
    if int(sf.best_index) != int(sc.best_index) or (
            int(sf.nominal_stride) != int(sc.nominal_stride)):
        raise AssertionError("fused and combined RMPPI chose different candidates")
    checks = [check("rmppi candidate free energy", fef, fec, "solve"),
              check("rmppi gains", sf.feedback_state.gains, sc.feedback_state.gains,
                    "solve")]
    compare_systems("rmppi", rf, rc, checks)

    tf, tc = build_tube("fused"), build_tube("combined")
    eps = torch.randn((K_R, T_R, C), generator=g, device=dev)
    state = tf.init_state(seed=0)
    rtf, ntf = tf.solve(x1, state, injected_noise=eps)
    rtc, ntc = tc.solve(x1, state, injected_noise=eps)
    compare_systems("tube", rtf, rtc, checks)
    checks.append(check("tube gains", ntf.feedback_state.gains,
                        ntc.feedback_state.gains, "solve"))
    emit("robust_reference", K=K_R, T=T_R, best_index=int(sf.best_index),
         nominal_stride=int(sf.nominal_stride), checks=checks)


def robust_loop_phase(kind):
    """The closed loop of bench.py:457-465 from X0, 100 steps: stage 1
    (RMPPI only), slide, solve, plant step with the real system's first
    control. Nothing inside the loop waits on the device."""
    ctrl = build_robust() if kind == "rmppi" else build_tube()
    if ctrl.device.type != "cuda":
        raise AssertionError("the controller did not default to the card")
    cs = ctrl.init_state(seed=0)
    x = torch.tensor(X0, device=ctrl.device)
    n = CLOSED_LOOP_STEPS
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(n)]
    radii = []
    torch.cuda.synchronize()
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(n):
        ev[i][0].record()
        if kind == "rmppi":
            cs, _ = ctrl.update_importance_sampling(x, cs, 1)
        ev[i][1].record()
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        ev[i][2].record()
        x, _ = ctrl.dynamics.step(x, res.real.control_mean[0], 0.0, ctrl.dt)
        ev[i][3].record()
        radii.append(torch.hypot(x[0], x[1]))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(fr.launch_counts)
    if kind == "rmppi":
        # stage 1 of the first step has no nominal system to evaluate yet
        want = {"rollout_costs_kernel": n - 1, "rmppi_rollout_kernel": n,
                "riccati_ladder_kernel": n}
    else:
        want = {"rollout_costs_kernel": 2 * n, "flash_combine_kernel": 2 * n,
                "riccati_ladder_kernel": n}
    expect_launches(launches, want, kind)
    r = torch.stack(radii).cpu()
    out_of_band = int(((r <= BAND[0]) | (r >= BAND[1])).sum())
    for name, t in (("control_mean", res.real.control_mean), ("costs", res.real.costs),
                    ("nominal costs", res.nominal.costs),
                    ("state_trajectory", res.real.state_trajectory),
                    ("gains", cs.feedback_state.gains), ("radius", r)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{kind}: {name} is not finite")
    if res.real.control_mean.shape != (T_R, C) or res.real.costs.shape != (K_R,):
        raise AssertionError(f"{kind}: unexpected result shapes")
    if out_of_band >= MAX_OUT_OF_BAND:
        raise AssertionError(f"{kind}: {out_of_band} of {n} steps outside "
                             f"{BAND[0]} < r < {BAND[1]}")
    steady = ev[5:]  # the first steps include one-time allocations
    med = lambda a, b: statistics.median(e[a].elapsed_time(e[b]) for e in steady)
    emit(f"{kind}_main_path", K=K_R, T=T_R, steps=n, launches=launches,
         out_of_band_steps=out_of_band, final_radius=float(r[-1]),
         final_baseline_real=float(res.real.baseline),
         stage1_ms_median=med(0, 1) if kind == "rmppi" else None,
         solve_ms_median=med(1, 2), step_ms_median=med(0, 3),
         host_wall_ms_per_step=1e3 * wall_s / n)
    if kind == "rmppi":
        rmppi_breakdown(ctrl, cs, x)

    def step():
        s = cs
        if kind == "rmppi":
            s, _ = ctrl.update_importance_sampling(x, s, 1)
        s = ctrl.slide_control_sequence(s, 1)
        res, _ = ctrl.solve(x, s)
        ctrl.dynamics.step(x, res.real.control_mean[0], 0.0, ctrl.dt)

    profile_steps(kind, step)
    return launches


def profile_steps(kind, step, n=10, warmup=3):
    """A torch.profiler window over n calls of ``step`` (closed-loop steps
    from one state, after the launch counts were read): kernel launches and
    device time per step, the device's idle share of the window, the
    largest kernels. The loops with thousands of launches per step take a
    shorter window (the profiler costs about 2 s per such step)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        count, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, total + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    emit(f"{kind}_profile", steps=n,
         kernel_launches_per_step=len(kernels) / n,
         device_busy_us_per_step=busy_us / n if kernels else "not measured",
         wall_us_per_step=window_us / n,
         device_idle_share=1.0 - busy_us / window_us if kernels else "not measured",
         top_kernels=[{"name": name[:80], "launches_per_step": c / n,
                       "device_us_per_step": t / n} for name, (c, t) in top])


def rmppi_breakdown(ctrl, cs, x, n=10):
    """Where an RMPPI step's time goes: each part run alone, synchronized,
    median host wall of n runs (ms)."""
    def wall(fn):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(out)

    T_, C_ = ctrl.num_timesteps, ctrl.dynamics.CONTROL_DIM
    U = ctrl._clamp_controls(ctrl.sampler.sample(cs.generator, cs.nominal_mean, S_PER)[0])
    W = ctrl.line_search_w
    points = torch.stack([cs.nominal_traj[0], cs.nominal_traj[1], x], dim=1)
    cands = (points @ W).T.contiguous()
    strides = ctrl._candidate_strides(1)
    mean = cs.nominal_mean
    parts = {
        "stage1 whole": lambda: ctrl.update_importance_sampling(x, cs, 1),
        "stage1 candidate costs (rollout kernel in x0 mode + LR)":
            lambda: ctrl._candidate_costs(cands, strides, U, mean),
        "stage1 nominal re-rollout (rollout_single, eager)":
            lambda: rollout_single(ctrl.dynamics, x, mean, ctrl.dt),
        "stage1 DDP gains (linearize + ladder kernel)":
            lambda: ctrl.feedback.compute_feedback(x, cs.nominal_traj, mean),
        "stage2 solve whole": lambda: ctrl.solve(x, cs),
        "stage2 RMPPI rollout kernel": lambda: fr.fused_rmppi_rollout(
            ctrl.dynamics, ctrl.cost, cs.nominal_state, x,
            torch.zeros((K_R, T_, C_), device=x.device), cs.feedback_state.gains,
            ctrl.sampler._sigma(T_, 0), ctrl.sampler.control_cost_coeff, ctrl.dt,
            ctrl.lam, ctrl.alpha),
        "stage2 two mean re-rollouts (eager)": lambda: [
            rollout_single(ctrl.dynamics, x, mean, ctrl.dt) for _ in range(2)],
    }
    emit("rmppi_breakdown", unit="ms host wall, synchronized, median of 10",
         parts={name: wall(fn) for name, fn in parts.items()})


# ---------------------------------------------------------------------------
# AutoRally: B3 and B1 with the FNN step (B10) and the costmap query (B9)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def ar_map_data(kind):
    """(data, origin, resolution, channel_major) of the bench's maps, made on
    the host from their numpy seeds: the 128^2 abs-normal map (seed 0, 1 m
    texels, bench.py:641-644) or the 4 x 1024^2 channel-major map whose
    channel 0 is the track (seed 3, 0.1 m texels, :773-778)."""
    if kind == "128":
        data = np.abs(np.random.default_rng(0).normal(size=(128, 128))).astype("f")
        return data, (-64.0, -64.0, 0.0), 1.0, False
    chw = np.random.default_rng(3).normal(size=(4, 1024, 1024)).astype("f")
    chw[0] = np.abs(chw[0])
    return chw, (-51.2, -51.2, 0.0), 0.1, True


def ar_parts(kind, dev="cpu"):
    data, origin, res, channel_major = ar_map_data(kind)
    tex = MapTexture2D(data, origin=origin, resolution=res, channel_major=channel_major,
                       device=dev)
    return (AutorallyNNDynamics.create(seed=0, device=dev),
            ARStandardCost(costmap=tex, device=dev))


def ar_sampler(kind, dev="cpu", p=0.0):
    kw = dict(std_dev=AR_STD, pure_noise_percentage=p, device=dev)
    return NLNDistribution.create(**kw) if kind == "nln" else GaussianDistribution.create(**kw)


def ar_x0(dev):
    return torch.tensor([0.0, 0.0, 0.0, 0.0, 3.0, 0.0, 0.0], device=dev)


def build_autorally(map_kind, kernel, return_samples=False):
    """bench.py:704-717 (or :775-789 on the 1024^2 map) on the card."""
    dyn, cost = ar_parts(map_kind)
    return VanillaMPPI(dyn, cost, ar_sampler("gaussian"), dt=DT, lam=LAM, alpha=ALPHA,
                       num_timesteps=T_AR, num_rollouts=K_AR, num_iters=1, kernel=kernel,
                       return_samples=return_samples)


def ar_fixed_bytes(cost):
    """The network (weights and biases), the cost's table and its whole map,
    read once."""
    return 4 * (FNN_MACS + 32 + 32 + 4 + cost.params.numel() + cost.costmap.data.numel())


def ar_rollout_work(cost, K, epilogue, with_lr):
    """(bytes, operations) of B1's function for the AutoRally pair."""
    nb = -(-K // fr.BLOCK)
    n_bytes = ar_fixed_bytes(cost) + 4 * (K * T_AR * C + S_AR + 2 * K)
    n_ops = K * T_AR * (OPS_AR_STEP + OPS_AR_COST + OPS_ACC + (OPS_LR if with_lr else 0))
    n_ops += 2 * K
    if with_lr:
        n_bytes += 4 * (2 * T_AR * C + C)
    if epilogue:
        n_bytes += 4 * nb * (2 + T_AR * C)
        n_ops += 5 * K + 2 * K * T_AR * C
    return n_bytes, n_ops


def ar_solve_work(cost, K, kind):
    """(bytes, operations) of B3's function for the AutoRally pair: the
    tables, constraints, x0 and seed read once; costs, crash, U and the
    carry rows written once."""
    nb = -(-K // fr.BLOCK)
    tables = 3 + (kind == "nln")  # mean, sigma, coeff / sigma^2, NLN's std
    n_bytes = ar_fixed_bytes(cost) + 4 * (tables * T_AR * C + 4 * C + S_AR + 1 + 2 * K
                                          + K * T_AR * C + nb * (2 + T_AR * C))
    draw = OPS_PHILOX + (2 if kind == "nln" else 1) * OPS_BOX_MULLER
    per_channel = 4 + 7 + 5 + (OPS_TRANSCENDENTAL + 2 if kind == "nln" else 0)
    per_step = draw + C * per_channel + OPS_AR_STEP + OPS_AR_COST + OPS_ACC
    return n_bytes, K * T_AR * per_step + 2 * K + 5 * K + 2 * K * T_AR * C


def ar_kernel_phase(dev, map_kind, K, p, stride, seed, timed_plain):
    """B3 (Gaussian, NLN) and B1 (its four modes) with the AutoRally entry
    against their plain versions: U, costs and crash flags to the last bit,
    the carries and the merge as the DI kernels'. Times by CUDA events; the
    plain versions' only where ``timed_plain``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn, cost = ar_parts(map_kind, dev)
    x0 = ar_x0(dev)
    mean = 0.2 * torch.randn((T_AR, C), generator=g, device=dev)
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    checks, times, crashed = [], {}, {}

    def timing(kernel, plain, work):
        t = {"ms": time_ms(kernel, N_TIMED),
             "plain_ms": time_ms(plain, N_TIMED_PLAIN_AR) if timed_plain else None}
        t["bound_ms"], t["bound_by"] = bound_ms(*work)
        return t

    def merge_checks(name, kcarry, pcarry, pc, U):
        km, kb, ke = fr.flash_combine(kcarry, T_AR, C, LAM)
        pm, pb, pe = fr.flash_combine_plain(pcarry, T_AR, C, LAM)
        return [check(f"{name} carry", kcarry, pcarry, "carry",
                      fr.block_carries_plain(pc, U.abs(), LAM).abs()),
                check(f"{name} new_mean", km, pm, "new_mean"),
                check(f"{name} baseline", kb, pb, "baseline"),
                check(f"{name} eta", ke, pe, "eta")]

    for kind in ("gaussian", "nln"):
        args = (dyn, cost, ar_sampler(kind, dev, p), x0, mean, seed_t, DT, LAM, ALPHA, K)
        kw = dict(optimization_stride=stride)
        kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, **kw)
        pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, **kw)
        torch.cuda.synchronize()
        name = f"B3 {kind}"
        same(f"{name} crash flags", kcrash, pcrash)
        checks += [check(f"{name} U", kU, pU, "bitwise"),
                   check(f"{name} costs", kc, pc, "bitwise"),
                   *merge_checks(name, kcarry, pcarry, pc, pU)]
        crashed[name] = float(kcrash.float().mean())
        times[name] = timing(lambda: fused_solve.fused_solve_carries(*args, **kw),
                             lambda: fused_solve.fused_solve_plain(*args, **kw),
                             ar_solve_work(cost, K, kind))
        if kind == "gaussian":  # the merge at this path's shapes
            times["flash_combine"] = timing(
                lambda: fr.flash_combine(kcarry, T_AR, C, LAM),
                lambda: fr.flash_combine_plain(kcarry, T_AR, C, LAM),
                combine_work(kcarry.shape[0], T_AR))
    samp = ar_sampler("gaussian", dev, p)
    U, _ = samp.sample(g, mean, K, optimization_stride=stride)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    lr = (mean, samp._sigma(T_AR, 0).contiguous(), samp.control_cost_coeff, LAM, ALPHA,
          samp.pure_threshold(K))
    for mode in ("costs", "costs+lr", "epilogue", "epilogue+lr"):
        lrp = lr if mode.endswith("+lr") else None
        epilogue = mode.startswith("epilogue")
        name = f"B1 {mode}"

        def kernel(lrp=lrp, epilogue=epilogue):
            if epilogue:
                return fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lrp)
            return fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp)

        def plain(lrp=lrp, epilogue=epilogue):
            pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
            return fr.block_carries_plain(pc, U, LAM) if epilogue else (pc, pcrash)

        kout = kernel()
        pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
        torch.cuda.synchronize()
        same(f"{name} crash flags", kout[1], pcrash)
        checks.append(check(f"{name} costs", kout[0], pc, "bitwise"))
        if epilogue:
            checks += merge_checks(name, kout[2], fr.block_carries_plain(pc, U, LAM), pc, U)
        times[name] = timing(kernel, plain, ar_rollout_work(cost, K, epilogue, lrp is not None))
        if mode == "epilogue+lr":
            # one-call yardstick for the weighting + weighted sum (not used by the port)
            times[name]["library_ms"] = time_ms(
                lambda: torch.softmax(-pc / LAM, 0) @ U.view(K, -1), N_TIMED)
        crashed[name] = float(kout[1].float().mean())
    emit("autorally_kernels", map=map_kind, K=K, T=T_AR, pure_noise_percentage=p,
         stride=stride, crashed_share=crashed, checks=checks, times=times)
    return checks, times


def near_threshold(cost, Y, samples):
    """Per sample in ``samples``: the smallest distance of a front or back
    map value along its trajectory Y (K, T, O) to the crash threshold."""
    y = Y[samples].permute(2, 0, 1).reshape(Y.shape[2], -1)
    cos_y, sin_y = torch.cos(y[2]), torch.sin(y[2])
    thr = cost.boundary_threshold
    d = torch.minimum(
        (cost._track_value(y[0] + 0.5 * cos_y, y[1] + 0.5 * sin_y) - thr).abs(),
        (cost._track_value(y[0] - 0.5 * cos_y, y[1] - 0.5 * sin_y) - thr).abs())
    return d.reshape(len(samples), -1).amin(dim=1)


def ar_reference_phase(dev):
    """One full-width solve of the 128^2 configuration on kernel="fused_solve"
    and on kernel="fused" against kernel="combined" on the same normals, each
    of the two under set_sync_debug_mode("error") after a warm solve.

    The eager network sums with a matmul and the kernels left to right, so
    the costs sit an ulp or so apart (about 1e-3 at J = 1e4, where every
    sample has crashed). A cost or crash flag may differ beyond the costs'
    tolerance only for a sample whose map value comes within 1e-4 of the
    crash threshold on the way (the distance is printed) and whose weight
    is below 1e-6; the mean's tolerance follows from the other costs: a
    weight moves by at most 2 max|dJ| / lambda relative, so the mean by that
    times max|U_k - mean|."""
    g = torch.Generator(device=dev).manual_seed(41)
    x = ar_x0(dev)
    eps = torch.randn((K_AR, T_AR, C), generator=g, device=dev)
    combined = build_autorally("128", "combined", return_samples=True)
    state = combined.init_state(seed=0).replace(
        control_mean=0.1 * torch.randn((T_AR, C), generator=g, device=dev))
    rc, _ = combined.solve(x, state, injected_noise=eps)
    U = rc.sampled_controls
    w_c = torch.exp(-(rc.costs - rc.baseline) / LAM)
    checks, odd_samples = [], {}
    for kernel in ("fused_solve", "fused"):
        ctrl = build_autorally("128", kernel)
        ctrl.solve(x, state, injected_noise=eps)  # one-time copies
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rf, _ = ctrl.solve(x, state, injected_noise=eps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rtol, atol = TOL["costs"]
        dJ = (rf.costs - rc.costs).abs()
        odd = (dJ > atol + rtol * rc.costs.abs()) | (rf.crash != rc.crash)
        idx = torch.nonzero(odd).flatten()
        if len(idx):
            Y = rollout_combined(combined.dynamics, combined.cost, x, U, DT)[1]
            dist = near_threshold(combined.cost, Y, idx)
            odd_samples[kernel] = [{"sample": int(k), "threshold_distance": float(d),
                                    "cost_diff": float(dJ[k]), "weight": float(w_c[k])}
                                   for k, d in zip(idx.tolist(), dist)]
            if float(dist.max()) > 1e-4 or float(w_c[idx].max()) > 1e-6:
                raise AssertionError(f"{kernel}: costs differ from combined away from "
                                     f"the crash threshold: {odd_samples[kernel]}")
        ok = ~odd
        checks.append(check(f"{kernel} costs vs combined", rf.costs[ok], rc.costs[ok],
                            "costs"))
        spread = float((U - rc.control_mean).abs().max())
        mean_atol = 2 * float(dJ[ok].max()) / LAM * spread + 1e-5
        for field, tol in (("control_mean", mean_atol), ("state_trajectory",
                                                         T_AR * DT * mean_atol + 1e-5)):
            got, want = getattr(rf, field), getattr(rc, field)
            err = float((got - want).abs().max())
            if not err <= tol:
                raise AssertionError(f"{kernel} {field} vs combined: {err} > {tol}")
            checks.append({"check": f"{kernel} {field} vs combined", "max_abs_err": err,
                           "atol": tol})
        checks.append(check(f"{kernel} baseline vs combined", rf.baseline, rc.baseline,
                            "costs"))
    emit("autorally_reference", K=K_AR, T=T_AR, map="128",
         crashed_share=float(rc.crash.float().mean()), checks=checks,
         samples_off_tolerance=odd_samples, no_host_sync=["fused_solve", "fused"])


# ---------------------------------------------------------------------------
# Colored noise: B1's Tsallis mode, B5 and the merge; B1's bicycle-slip entry
# ---------------------------------------------------------------------------
def colored_sampler(dev=None, p=0.0, std=COLORED_STD, exponents=COLORED_EXPONENTS):
    kw = dict(exponents=exponents, std_dev=std, pure_noise_percentage=p)
    if dev is not None:
        kw["device"] = dev
    return ColoredNoiseDistribution.create(**kw)


def colored_inputs(dev, K, p, seed, stride):
    """The colored rows' kernel inputs: colored samples (std [1, 1],
    exponents [1, 2]) around a random mean, and their LR tables."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn = DoubleIntegratorDynamics.create(device=dev)
    cost = DoubleIntegratorCircleCost(device=dev)
    sampler = colored_sampler(dev, p)
    mean = 0.3 * torch.randn((T, C), generator=g, device=dev)
    U, _ = sampler.sample(g, mean, K, optimization_stride=stride)
    lr = (mean, sampler._sigma(T, 0).contiguous(), sampler.control_cost_coeff, LAM, ALPHA,
          sampler.pure_threshold(K))
    return dyn, cost, torch.tensor(X0, device=dev), U.contiguous(), lr


def pass1_work(K):
    """(bytes, operations) of B1's Tsallis pass 1 with the LR cost: the
    rollout's, plus one minimum per sample and one float per block."""
    n_bytes, n_ops = rollout_work(K, False, True)
    return n_bytes + 4 * -(-K // fr.BLOCK), n_ops + K


def tsallis_reduce_work(K, T_=T):
    """(bytes, operations) of B5's function: U, the costs and the block
    minima read once, the rows and rho written once; the minimum, the
    weights, the sums of w and of w U."""
    nb, TC = -(-K // fr.BLOCK), T_ * C
    n_bytes = 4 * (K * TC + K + nb + nb * (2 + TC) + 1)
    return n_bytes, nb + K * OPS_TSALLIS_W + K + 2 * K * TC


def tsallis_kernel_phase(dev, K, p, stride, seed):
    """B1's Tsallis mode (costs and block minima), B5 (rho and the rows)
    and the merge against their plain versions, for gamma 10 / r 2 and a
    gamma that zeros some weights; costs, crash flags, minima and rho to the
    last bit, the rows, eta and the new mean at the exp epilogue's
    tolerances; the tsallis_reduce entry alone with a given device rho. At
    K_MAIN also the times, bounds and the eager weights + matmul."""
    dyn, cost, x0, U, lr = colored_inputs(dev, K, p, seed, stride)
    by_kernel = {"rollout_costs_kernel": [], "tsallis_reduce_kernel": [],
                 "flash_combine_kernel": []}
    times, zero_weights = {}, {}
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    pmin = fr.block_minima_plain(pc)
    prho = torch.amin(pmin)
    for gamma, r in ((GAMMA, R_TS), (GAMMA_SMALL, R_SMALL)):
        name = f"gamma {gamma} r {r}"
        kc, kcrash, kmin = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr)
        krows, krho = fr.tsallis_block_rows(U, kc, kmin, gamma, r)
        km, _, ke = fr.flash_combine(krows, T, C, 1.0)
        _, _, fm, frho, fe = fr.fused_weighted_rollout(
            dyn, cost, x0, U, DT, LAM, lr, weight_kind="tsallis", weight_params=(gamma, r))
        knum, keta = fr.tsallis_reduce(U, pc, prho, gamma, r)
        prows = fr.tsallis_rows_plain(U, pc, prho, fr._f32(gamma), fr._tsallis_pw(r))
        pm, _, pe, pnum = fr.flash_combine_plain(prows, T, C, 1.0, with_num=True)
        torch.cuda.synchronize()
        same(f"{name} crash flags", kcrash, pcrash)
        same(f"{name} block minima", kmin, pmin)
        same(f"{name} rho", krho, prho)
        same(f"{name} fused_weighted_rollout rho", frho, prho)
        by_kernel["rollout_costs_kernel"].append(check(f"{name} costs", kc, pc, "bitwise"))
        by_kernel["tsallis_reduce_kernel"].append(
            check(f"{name} rows", krows, prows, "carry",
                  fr.tsallis_rows_plain(U.abs(), pc, prho, fr._f32(gamma),
                                        fr._tsallis_pw(r)).abs()))
        by_kernel["flash_combine_kernel"] += [
            check(f"{name} new_mean", km, pm, "new_mean"),
            check(f"{name} eta", ke, pe, "eta"),
            check(f"{name} fused_weighted_rollout new_mean", fm, pm, "new_mean"),
            check(f"{name} fused_weighted_rollout eta", fe, pe, "eta"),
            check(f"{name} tsallis_reduce(rho given) num", knum, pnum, "new_mean"),
            check(f"{name} tsallis_reduce(rho given) eta", keta, pe, "eta")]
        w = weights.tsallis_weights(pc, gamma, r, prho)
        zero_weights[name] = int((w == 0).sum())
        if gamma == GAMMA_SMALL and not 0 < zero_weights[name] < K - 1:
            raise AssertionError(f"{name}: {zero_weights[name]} of {K} weights are 0; "
                                 "the small gamma must zero some and keep some")
        if K == K_MAIN and gamma == GAMMA:
            g32, pw = fr._f32(gamma), fr._tsallis_pw(r)
            times["pass1"] = timed(
                lambda: fr.rollout_block_minima(dyn, cost, x0, U, DT, lr),
                lambda: fr.block_minima_plain(
                    fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)[0]))
            times["pass1"]["bound_ms"], times["pass1"]["bound_by"] = bound_ms(
                *pass1_work(K))
            t = timed(lambda: fr.tsallis_block_rows(U, kc, kmin, gamma, r),
                      lambda: fr.tsallis_rows_plain(U, pc, prho, g32, pw))
            t["bound_ms"], t["bound_by"] = bound_ms(*tsallis_reduce_work(K))
            # the eager weights and their weighted sum of U: several calls,
            # a yardstick that the port does not use
            t["library_ms"] = time_ms(
                lambda: weights.tsallis_weights(pc, gamma, r, prho) @ U.view(K, -1),
                N_TIMED)
            t["library_calls"] = ("weights.tsallis_weights(costs) @ U.view(K, T*C), "
                                  "several calls")
            times["tsallis_reduce"] = t
            times["merge"] = timed(lambda: fr.flash_combine(krows, T, C, 1.0),
                                   lambda: fr.flash_combine_plain(krows, T, C, 1.0))
            times["merge"]["bound_ms"], times["merge"]["bound_by"] = bound_ms(
                *combine_work(krows.shape[0]))
            times["tsallis_reduce entry (rho given, with the merge)"] = {
                "ms": time_ms(lambda: fr.tsallis_reduce(U, pc, prho, gamma, r), N_TIMED)}
            times["chain (pass 1, B5, merge)"] = {"ms": time_ms(
                lambda: fr.fused_weighted_rollout(dyn, cost, x0, U, DT, LAM, lr,
                                                  weight_kind="tsallis",
                                                  weight_params=(gamma, r)), N_TIMED)}
    emit("tsallis_kernels", K=K, T=T, pure_noise_percentage=p, stride=stride,
         rho=float(prho), zero_weights=zero_weights,
         checks=[c for cs in by_kernel.values() for c in cs], times=times)
    return by_kernel, times


def bicycle_parts(dev="cpu"):
    """The bicycle-slip model and ARStandardCost on the bench's 128^2 map
    with the bicycle's output layout (bench.py:641-651)."""
    data, origin, res, channel_major = ar_map_data("128")
    tex = MapTexture2D(data, origin=origin, resolution=res, channel_major=channel_major,
                       device=dev)
    return (BicycleSlipDynamics.create(device=dev),
            ARStandardCost(costmap=tex, output_indices=BI_OUTPUT_INDICES, device=dev))


def build_bicycle(kernel):
    """bench.py:641-665 on the card."""
    dyn, cost = bicycle_parts()
    return VanillaMPPI(dyn, cost, colored_sampler(None, 0.0, BI_STD, BI_EXPONENTS), dt=DT,
                       lam=LAM, alpha=ALPHA, num_timesteps=T_BI, num_rollouts=K_BI,
                       num_iters=1, kernel=kernel, return_samples=kernel == "combined")


def build_colored(transform, kernel):
    """bench.py:671-702 on the card: ColoredMPPI, normExp or Tsallis."""
    return ColoredMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                       colored_sampler(), dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T,
                       num_rollouts=K_MAIN, num_iters=1, kernel=kernel,
                       weight_transform=transform, tsallis_gamma=GAMMA, tsallis_r=R_TS,
                       return_samples=kernel == "combined")


def bicycle_work(cost, K, mode):
    """(bytes, operations) of B1's function for the bicycle pair: the
    model's table, the cost's table and its whole map read once, U, x0 and
    the LR tables read once, costs, crash and the carry rows or block minima
    written once."""
    nb = -(-K // fr.BLOCK)
    with_lr = mode.endswith("+lr")
    n_bytes = 4 * (BicycleSlipDynamics.create().params.numel() + cost.params.numel()
                   + cost.costmap.data.numel() + K * T_BI * C + S_BI + 2 * K)
    n_ops = K * T_BI * (OPS_BI_STEP + OPS_AR_COST + OPS_ACC + (OPS_LR if with_lr else 0))
    n_ops += 2 * K
    if with_lr:
        n_bytes += 4 * (2 * T_BI * C + C)
    if mode.startswith("epilogue"):
        n_bytes += 4 * nb * (2 + T_BI * C)
        n_ops += 5 * K + 2 * K * T_BI * C
    if mode.startswith("tsallis"):
        n_bytes += 4 * nb
        n_ops += K
    return n_bytes, n_ops


def bicycle_kernel_phase(dev, K, p, stride, seed, timed_plain):
    """B1's bicycle-slip entry in its four modes (costs, costs + LR, the exp
    epilogue, Tsallis pass 1; the last two with the LR cost, as the main path
    runs them) against its plain version on the 128^2 map: costs, crash
    flags and block minima to the last bit; the carries, the Tsallis rows
    and the merges at the DI kernels' tolerances. Times by CUDA events; the
    plain versions' only where ``timed_plain``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn, cost = bicycle_parts(dev)
    x0 = torch.zeros(S_BI, device=dev)
    samp = colored_sampler(dev, p, BI_STD, BI_EXPONENTS)
    mean = 0.2 * torch.randn((T_BI, C), generator=g, device=dev)
    U, _ = samp.sample(g, mean, K, optimization_stride=stride)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    lr = (mean, samp._sigma(T_BI, 0).contiguous(), samp.control_cost_coeff, LAM, ALPHA,
          samp.pure_threshold(K))
    by_kernel = {"rollout_costs_kernel": [], "tsallis_reduce_kernel": [],
                 "flash_combine_kernel": []}
    times, crashed = {}, {}
    for mode in ("costs", "costs+lr", "epilogue+lr", "tsallis+lr"):
        lrp = lr if mode.endswith("+lr") else None

        def kernel(mode=mode, lrp=lrp):
            if mode.startswith("epilogue"):
                return fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lrp)
            if mode.startswith("tsallis"):
                return fr.rollout_block_minima(dyn, cost, x0, U, DT, lrp)
            return fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp)

        def plain(mode=mode, lrp=lrp):
            pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
            if mode.startswith("epilogue"):
                return fr.block_carries_plain(pc, U, LAM)
            return fr.block_minima_plain(pc) if mode.startswith("tsallis") else pc

        kout = kernel()
        pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
        torch.cuda.synchronize()
        name = f"bicycle {mode}"
        same(f"{name} crash flags", kout[1], pcrash)
        by_kernel["rollout_costs_kernel"].append(
            check(f"{name} costs", kout[0], pc, "bitwise"))
        if mode.startswith("epilogue"):
            pcarry = fr.block_carries_plain(pc, U, LAM)
            by_kernel["rollout_costs_kernel"].append(check(
                f"{name} carry", kout[2], pcarry, "carry",
                fr.block_carries_plain(pc, U.abs(), LAM).abs()))
            km, kb, ke = fr.flash_combine(kout[2], T_BI, C, LAM)
            pm, pb, pe = fr.flash_combine_plain(pcarry, T_BI, C, LAM)
            by_kernel["flash_combine_kernel"] += [
                check(f"{name} new_mean", km, pm, "new_mean"),
                check(f"{name} baseline", kb, pb, "baseline"),
                check(f"{name} eta", ke, pe, "eta")]
        if mode.startswith("tsallis"):
            pmin = fr.block_minima_plain(pc)
            same(f"{name} block minima", kout[2], pmin)
            krows, krho = fr.tsallis_block_rows(U, kout[0], kout[2], GAMMA, R_TS)
            prows = fr.tsallis_rows_plain(U, pc, torch.amin(pmin), fr._f32(GAMMA),
                                          fr._tsallis_pw(R_TS))
            km, _, ke = fr.flash_combine(krows, T_BI, C, 1.0)
            pm, _, pe = fr.flash_combine_plain(prows, T_BI, C, 1.0)
            torch.cuda.synchronize()
            same(f"{name} rho", krho, torch.amin(pmin))
            by_kernel["tsallis_reduce_kernel"].append(check(
                f"{name} rows", krows, prows, "carry",
                fr.tsallis_rows_plain(U.abs(), pc, torch.amin(pmin), fr._f32(GAMMA),
                                      fr._tsallis_pw(R_TS)).abs()))
            by_kernel["flash_combine_kernel"] += [
                check(f"{name} new_mean", km, pm, "new_mean"),
                check(f"{name} eta", ke, pe, "eta")]
        t = {"ms": time_ms(kernel, N_TIMED),
             "plain_ms": time_ms(plain, N_TIMED_PLAIN_AR) if timed_plain else None}
        t["bound_ms"], t["bound_by"] = bound_ms(*bicycle_work(cost, K, mode))
        if mode == "epilogue+lr":
            # one-call yardstick for the weighting + weighted sum (not used by the port)
            t["library_ms"] = time_ms(lambda: torch.softmax(-pc / LAM, 0) @ U.view(K, -1),
                                      N_TIMED)
        times[mode] = t
        crashed[mode] = float(kout[1].float().mean())
    emit("bicycle_kernels", map="128", K=K, T=T_BI, pure_noise_percentage=p, stride=stride,
         crashed_share=crashed, checks=[c for cs in by_kernel.values() for c in cs],
         times=times)
    return by_kernel, times


def colored_reference_phase(dev):
    """One full-width solve of each colored configuration on kernel="fused"
    against kernel="combined" on the same frequency normals (stride 1, a
    warm mean), the fused one under set_sync_debug_mode("error") after a
    warm solve. The costs differ by the LR sum's order; a weight moves by at
    most 2 max|dJ| / lambda relative (normExp) or 2 max|dJ| / gamma (Tsallis,
    r = 2) and the mean by that times max|U_k - mean| over the weighted
    samples, which sets the mean's tolerance (where J is large, as on the
    bicycle's map where every sample crashes, that is what dominates)."""
    g = torch.Generator(device=dev).manual_seed(61)
    checks = []
    cases = (("exp", build_colored("exp", "fused"), build_colored("exp", "combined"),
              torch.tensor(X0, device=dev), K_MAIN, T),
             ("tsallis", build_colored("tsallis", "fused"),
              build_colored("tsallis", "combined"), torch.tensor(X0, device=dev),
              K_MAIN, T),
             ("bicycle", build_bicycle("fused"), build_bicycle("combined"),
              torch.zeros(S_BI, device=dev), K_BI, T_BI))
    for name, fused, combined, x, K, T_ in cases:
        z = torch.randn((2, K, C, T_ + 1), generator=g, device=dev)
        state = fused.init_state(seed=0).replace(
            control_mean=0.2 * torch.randn((T_, C), generator=g, device=dev))
        rc, _ = combined.solve(x, state, 1, injected_noise=z)
        fused.solve(x, state, 1, injected_noise=z)  # one-time copies
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rf, _ = fused.solve(x, state, 1, injected_noise=z)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        same(f"{name} crash flags of the fused and the eager solve", rf.crash, rc.crash)
        checks.append(check(f"{name} costs vs combined", rf.costs, rc.costs, "costs"))
        checks.append(check(f"{name} baseline vs combined", rf.baseline, rc.baseline,
                            "costs"))
        dJ = float((rf.costs - rc.costs).abs().max())
        used = rc.weights > 0
        spread = float((rc.sampled_controls[used] - rc.control_mean).abs().max())
        if name == "tsallis":
            # each weight moves by at most 2 dJ / gamma (r = 2), eta by the sum
            eta_move = 2 * dJ / GAMMA * int(used.sum())
            checks.append(within(f"{name} eta vs combined", rf.normalizer, rc.normalizer,
                                 1e-5 * float(rc.normalizer) + eta_move))
            move = eta_move / float(rc.normalizer)
        else:
            move = 2 * dJ / LAM
        mean_atol = move * spread + 1e-5
        checks.append(within(f"{name} control_mean vs combined", rf.control_mean,
                             rc.control_mean, mean_atol))
        checks.append(within(f"{name} state_trajectory vs combined", rf.state_trajectory,
                             rc.state_trajectory, T_ * DT * mean_atol + 1e-5))
    emit("colored_reference", checks=checks, no_host_sync=["exp", "tsallis", "bicycle"])


def ar_loop_phase(path, map_kind, kernel, steps, want):
    """The AutoRally configuration's closed loop from x0 (v_x = 3)."""
    ctrl = build_autorally(map_kind, kernel)
    return model_loop_phase(path, ctrl, ar_x0(ctrl.device), steps, want, map=map_kind)[0]


# ---------------------------------------------------------------------------
# The analytic model zoo: cartpole (the bench row cartpole_example_K8192,
# bench.py:599-608), the quadrotor with its quadratic cost
# (tests/test_model_zoo.py:60-92) or its map cost
# (examples/quadrotor_waypoint_example.py), the Dubins car and the double
# integrator with QuadraticCost (examples/double_integrator_example.py).
# ---------------------------------------------------------------------------
K_ZOO, K_ZOO_RAGGED, T_ZOO = 8192, 8000, 100
CART_RANGE, CART_STD, CART_COEFFS = [[-5.0, 5.0]], [5.0], [100.0, 10.0, 200.0, 20.0]
QUAD_RANGE, QUAD_STD, HOVER_THRUST = [[-3.0, 3.0]] * 3 + [[0.0, 20.0]], [0.5, 0.5, 0.5, 2.0], 9.81
K_HOVER, T_HOVER, HOVER_STEPS = 512, 48, 150
K_WAYPOINT, WAYPOINT_STEPS = 1024, 100
WAYPOINTS = [(1.5, 0.0, 0.0, np.pi / 2), (3.0, 0.8, 0.0, np.pi / 2), (4.5, 1.5, 0.0, np.pi / 2)]
SWINGUP_STEPS = 500
ZOO_B1_STEPS = 20  # the kernel="fused" and Tsallis loops: the entry on a main path
LAM_DIVISION = 0.3  # an inexact reciprocal, for the host-scalar division check
# Operations per sample-step of each model and cost (csrc/*.cuh; a
# transcendental, sqrtf and fmodf as OPS_TRANSCENDENTAL, powf as two):
# the cartpole step sinf, cosf and 32 (the two accelerations with their two
# divisions 24, the Euler update 8); its cost 4 x 3 + 3.
OPS_CART_STEP, OPS_CART_COST = 32 + 2 * OPS_TRANSCENDENTAL, 15
# The quadrotor step: the DCM column 10, thrust / m and v_d 5, q_d 28, w_d 6,
# the Euler update 26, the norm 7 and sqrtf, the scale 2 and four divisions.
OPS_QUAD_STEP = 88 + OPS_TRANSCENDENTAL
# QuadrotorQuadraticCost: three squared errors 24, q_diff 31, the Euler
# arguments 22, two atan2_approx (20 each) and asin_approx (25 and sqrtf),
# the weighted sum 14, the saturation 2.
OPS_QQ_COST = 158 + OPS_TRANSCENDENTAL
# QuadrotorMapCost: distance 8, gate band 25, speed 6, roll and pitch (args
# 13, atan2 20, asin 25), the height term 26, the heading (the rotated
# velocity 30, two atan2 40, the wrap 4, the rest 6), the map (world -> tex
# 17, the query 37, its terms 8), sums 12; sqrtf x 5, fmodf and powf (two).
OPS_QMAP_COST = 317 + 8 * OPS_TRANSCENDENTAL
# Dubins: cosf, sinf, 8 and the yaw wrap (fmodf and 4).
OPS_DUBINS_STEP = 12 + 3 * OPS_TRANSCENDENTAL


def ops_quadratic(O, trajectory):
    """QuadraticCost: O errors, squares and weights, O - 1 adds; the
    trajectory's row index 3."""
    return 4 * O - 1 + (3 if trajectory else 0)


def zoo_map(dev):
    """The quadrotor map: 512^2 texels of 0.05 m over [-12.8, 12.8]^2, a low
    abs-normal floor (numpy seed 4) and a high block (the track boundary)
    beyond x, y >= 6.4 m; one gate from update_waypoint."""
    data = (0.2 * np.abs(np.random.default_rng(4).normal(size=(512, 512)))).astype("f")
    data[384:, 384:] = 3.0
    return MapTexture2D(data, origin=(-12.8, -12.8, 0.0), resolution=0.05, device=dev)


def zoo_parts(pair, dev=None):
    """(dynamics, cost, x0, std, mean offset of the last channel, ops per
    sample-step of the step and the cost) of one zoo pair on ``dev`` (the
    controllers' default device when None)."""
    kw = {} if dev is None else {"device": dev}
    x0dev = dev if dev is not None else "cuda"
    if pair == "cartpole":
        return (CartpoleDynamics.create(control_ranges=CART_RANGE, **kw),
                CartpoleQuadraticCost(coeffs=CART_COEFFS, **kw),
                torch.zeros(4, device=x0dev), CART_STD, 0.0, OPS_CART_STEP + OPS_CART_COST)
    if pair.startswith("quadrotor"):
        x0 = torch.zeros(13, device=x0dev)
        x0[6] = 1.0
        if pair == "quadrotor_quadratic":
            x0[0], x0[2] = 1.0, -0.5  # the hover test's offset start
            cost, ops = QuadrotorQuadraticCost(x_coeff=50.0, v_coeff=5.0, **kw), OPS_QQ_COST
        else:
            x0[0], x0[1] = 0.9, -2.3  # beside the gate's right post: a share crashes
            cost = QuadrotorMapCost(costmap=zoo_map(dev), dist_to_waypoint_coeff=12.0,
                                    desired_speed=1.0, heading_coeff=0.0, speed_coeff=1.0,
                                    **kw).update_waypoint(*WAYPOINTS[0])
            ops = OPS_QMAP_COST
        return (QuadrotorDynamics.create(control_ranges=QUAD_RANGE, **kw), cost, x0,
                QUAD_STD, HOVER_THRUST, OPS_QUAD_STEP + ops)
    if pair.startswith("dubins"):
        traj = pair == "dubins_trajectory"
        goal = (np.random.default_rng(5).normal(size=(T_ZOO, 3)).astype("f") if traj
                else [1.0, 2.0, 0.5])
        return (DubinsDynamics.create(**kw),
                QuadraticCost(goal, [1.0, 2.0, 0.3], current_time=3 if traj else 0, **kw),
                torch.tensor([0.0, 0.0, 3.0], device=x0dev), [1.0, 1.0], 0.0,
                OPS_DUBINS_STEP + ops_quadratic(3, traj))
    return (DoubleIntegratorDynamics.create(**kw),
            QuadraticCost([-4.0, -4.0, 0.0, 0.0], [5.0, 5.0, 0.5, 0.5], output_dim=4, **kw),
            torch.tensor([-9.0, -9.0, 0.1, 0.1], device=x0dev), [0.5, 0.5], 0.0,
            OPS_STEP + ops_quadratic(4, False))


ZOO_PAIRS = ("cartpole", "quadrotor_quadratic", "quadrotor_map", "dubins_quadratic",
             "dubins_trajectory", "di_quadratic")


def zoo_fixed_bytes(dyn, cost):
    """The model's and the cost's tables, the cost's map (or goal rows) and
    the constraints, read once."""
    table = dyn.kernel_params()
    cmap = cost.kernel_map()
    return 4 * ((0 if table is None else table.numel()) + cost.params.numel()
                + (0 if cmap is None else cmap.numel()) + 4 * dyn.CONTROL_DIM)


def zoo_rollout_work(dyn, cost, ops, K, T_, mode):
    """(bytes, operations) of B1's function for a zoo pair in ``mode``."""
    S_, C_ = dyn.STATE_DIM, dyn.CONTROL_DIM
    nb = -(-K // fr.BLOCK)
    with_lr = mode.endswith("+lr")
    n_bytes = zoo_fixed_bytes(dyn, cost) + 4 * (K * T_ * C_ + S_ + 2 * K)
    n_ops = K * T_ * (ops + OPS_ACC + (8 * C_ if with_lr else 0)) + 2 * K
    if with_lr:
        n_bytes += 4 * (2 * T_ * C_ + C_)
    if mode.startswith("epilogue"):
        n_bytes += 4 * nb * (2 + T_ * C_)
        n_ops += 5 * K + 2 * K * T_ * C_
    if mode.startswith("tsallis"):
        n_bytes += 4 * nb
        n_ops += K
    return n_bytes, n_ops


def zoo_sampling_work(dyn, cost, ops, K, T_, kind, solve, epilogue=False):
    """(bytes, operations) of B3 (``solve``) or B4 for a zoo pair: the
    tables, constraints, x0 and seed read once; costs, crash, U (B3 and B4
    without an epilogue), W (Smooth-MPPI) and the carry rows written once."""
    S_, C_ = dyn.STATE_DIM, dyn.CONTROL_DIM
    nb = -(-K // fr.BLOCK)
    tables = 2 + (kind != "gaussian") + (1 if solve else 0)
    emitted = (1 if solve or not epilogue else 0) + (1 if kind == "smooth" else 0)
    n_bytes = zoo_fixed_bytes(dyn, cost) + 4 * (tables * T_ * C_ + (0 if solve else C_)
                                                + S_ + 1 + 2 * K + emitted * K * T_ * C_)
    draw = OPS_PHILOX * (-(-C_ // 2)) + (2 if kind == "nln" else 1) * OPS_BOX_MULLER * (-(-C_ // 2))
    per_channel = 4 + 7 + (5 if solve else 7) + (OPS_TRANSCENDENTAL + 2 if kind == "nln" else 0)
    per_channel += 3 if kind == "smooth" else 0
    n_ops = K * T_ * (draw + C_ * per_channel + ops + OPS_ACC) + 2 * K
    if solve or epilogue:
        n_bytes += 4 * nb * (2 + T_ * C_)
        n_ops += 5 * K + 2 * K * T_ * C_
    return n_bytes, n_ops


def zoo_sampler(kind, C_, std, dev=None, p=0.0, T_=T_ZOO):
    kw = dict(std_dev=std, control_cost_coeff=[1.0] * C_, pure_noise_percentage=p)
    if dev is not None:
        kw["device"] = dev
    if kind == "nln":
        return NLNDistribution.create(**kw)
    if kind == "smooth":
        return SmoothMPPIDistribution.create(num_timesteps=T_, dt=DT_SMOOTH, **kw)
    return GaussianDistribution.create(**kw)


def zoo_kernel_phase(dev, pair, K, p, stride, seed, timed_plain):
    """A zoo pair's B1 entry in its four modes (costs, costs + LR, the exp
    epilogue + LR, Tsallis pass 1 + LR), its B3 entry (Gaussian; the
    cartpole also NLN) and, for the cartpole, its B4 entry (Gaussian, NLN,
    Smooth-MPPI, Smooth-MPPI with its epilogue), each against its plain
    version: U, costs, crash flags and block minima to the last bit, carries
    at rtol 1e-5, merged means at rtol 1e-4 / atol 1e-5. Times by CUDA
    events against the bound from the .cuh operation counts; the plain
    versions' times where ``timed_plain`` (the epilogue mode, B3 Gaussian,
    B4 Smooth with its epilogue), the library yardstick softmax(-J / lambda)
    @ U beside the epilogue."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn, cost, x0, std, offset, ops = zoo_parts(pair, dev)
    C_, T_ = dyn.CONTROL_DIM, T_ZOO
    mean = 0.3 * torch.randn((T_, C_), generator=g, device=dev)
    mean[:, -1] += offset
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    by_kernel = {"rollout_costs_kernel": [], "fused_solve_kernel": [],
                 "fused_sample_rollout_kernel": [], "flash_combine_kernel": []}
    times, crashed = {}, {}

    def timing(kernel, plain, work, time_plain):
        t = {"ms": time_ms(kernel, N_TIMED),
             "plain_ms": time_ms(plain, N_TIMED_PLAIN_AR) if time_plain else None}
        t["bound_ms"], t["bound_by"] = bound_ms(*work)
        return t

    def merge_checks(name, kcarry, pcarry, pc, X):
        km, kb, ke = fr.flash_combine(kcarry, T_, C_, LAM)
        pm, pb, pe = fr.flash_combine_plain(pcarry, T_, C_, LAM)
        return [check(f"{name} new_mean", km, pm, "new_mean"),
                check(f"{name} baseline", kb, pb, "baseline"),
                check(f"{name} eta", ke, pe, "eta")], check(
                    f"{name} carry", kcarry, pcarry, "carry",
                    fr.block_carries_plain(pc, X.abs(), LAM).abs())

    # B1 on the sampler's clamped samples
    samp = zoo_sampler("gaussian", C_, std, dev, p)
    U, _ = samp.sample(g, mean, K, optimization_stride=stride)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    lr = (mean, samp._sigma(T_, 0).contiguous(), samp.control_cost_coeff, LAM, ALPHA,
          samp.pure_threshold(K))
    for mode in ("costs", "costs+lr", "epilogue+lr", "tsallis+lr"):
        lrp = lr if mode.endswith("+lr") else None

        def kernel(mode=mode, lrp=lrp):
            if mode.startswith("epilogue"):
                return fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lrp)
            if mode.startswith("tsallis"):
                return fr.rollout_block_minima(dyn, cost, x0, U, DT, lrp)
            return fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp)

        def plain(mode=mode, lrp=lrp):
            pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
            if mode.startswith("epilogue"):
                return fr.block_carries_plain(pc, U, LAM)
            return fr.block_minima_plain(pc) if mode.startswith("tsallis") else pc

        kout = kernel()
        pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
        torch.cuda.synchronize()
        name = f"B1 {mode}"
        same(f"{pair} {name} crash flags", kout[1], pcrash)
        by_kernel["rollout_costs_kernel"].append(check(f"{pair} {name} costs", kout[0], pc,
                                                       "bitwise"))
        if mode.startswith("epilogue"):
            merged, carry = merge_checks(f"{pair} {name}", kout[2],
                                         fr.block_carries_plain(pc, U, LAM), pc, U)
            by_kernel["rollout_costs_kernel"].append(carry)
            by_kernel["flash_combine_kernel"] += merged
        if mode.startswith("tsallis"):
            same(f"{pair} {name} block minima", kout[2], fr.block_minima_plain(pc))
        times[name] = timing(kernel, plain, zoo_rollout_work(dyn, cost, ops, K, T_, mode),
                             timed_plain and mode == "epilogue+lr")
        if mode == "epilogue+lr":
            # one-call yardstick for the weighting + weighted sum (not used by the port)
            times[name]["library_ms"] = time_ms(
                lambda: torch.softmax(-pc / LAM, 0) @ U.view(K, -1), N_TIMED)
        crashed[name] = float(kout[1].float().mean())
    # B3 (and the cartpole's B4)
    for kind in ("gaussian", "nln") if pair == "cartpole" else ("gaussian",):
        s = zoo_sampler(kind, C_, std, dev, p)
        args = (dyn, cost, s, x0, mean, seed_t, DT, LAM, ALPHA, K)
        kw = dict(optimization_stride=stride)
        kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, **kw)
        pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, **kw)
        torch.cuda.synchronize()
        name = f"B3 {kind}"
        same(f"{pair} {name} crash flags", kcrash, pcrash)
        merged, carry = merge_checks(f"{pair} {name}", kcarry, pcarry, pc, pU)
        by_kernel["fused_solve_kernel"] += [
            check(f"{pair} {name} U", kU, pU, "bitwise"),
            check(f"{pair} {name} costs", kc, pc, "bitwise"), carry]
        by_kernel["flash_combine_kernel"] += merged
        crashed[name] = float(kcrash.float().mean())
        times[name] = timing(lambda: fused_solve.fused_solve_carries(*args, **kw),
                             lambda: fused_solve.fused_solve_plain(*args, **kw),
                             zoo_sampling_work(dyn, cost, ops, K, T_, kind, True),
                             timed_plain and kind == "gaussian")
    if pair == "cartpole":
        dmean = 0.3 * torch.randn((T_, C_), generator=g, device=dev)
        for kind, epilogue in (("gaussian", False), ("nln", False), ("smooth", False),
                               ("smooth", True)):
            s = zoo_sampler(kind, C_, std, dev, p)
            state = dmean if kind == "smooth" else None
            args = (dyn, cost, s, x0, mean, seed_t, DT, LAM, ALPHA, K)
            kout = fr.fused_sample_rollout_costs(*args, optimization_stride=stride,
                                                 sampler_state=state, epilogue=epilogue)
            pc, pcrash, pU, pW = fr.sample_rollout_plain(
                *args, optimization_stride=stride, sampler_state=state)
            torch.cuda.synchronize()
            name = f"B4 {kind}{' epilogue' if epilogue else ''}"
            same(f"{pair} {name} crash flags", kout[1], pcrash)
            by_kernel["fused_sample_rollout_kernel"] += [
                check(f"{pair} {name} U", kout[2], pU, "bitwise"),
                check(f"{pair} {name} costs", kout[0], pc, "bitwise")]
            if epilogue:
                pm, pb, pe = fr.flash_combine_plain(fr.block_carries_plain(pc, pW, LAM),
                                                    T_, C_, LAM)
                by_kernel["flash_combine_kernel"] += [
                    check(f"{pair} {name} new_deriv_mean", kout[3], pm, "new_mean"),
                    check(f"{pair} {name} baseline", kout[4], pb, "baseline"),
                    check(f"{pair} {name} eta", kout[5], pe, "eta")]
            elif kind == "smooth":
                by_kernel["fused_sample_rollout_kernel"].append(
                    check(f"{pair} {name} W", kout[3], pW, "bitwise"))
            kid = fr.noise_kind(s)

            def kernel(epilogue=epilogue, s=s, state=state, kid=kid):
                # the kernel alone, as the main path launches it (U not kept)
                return fr._sample_rollout_cuda(dyn, cost, s, kid, x0, mean, seed_t, DT,
                                               LAM, ALPHA, K, 0, 0, state, epilogue,
                                               False, None)

            def plain(epilogue=epilogue, args=args, state=state):
                out = fr.sample_rollout_plain(*args, sampler_state=state)
                return fr.block_carries_plain(out[0], out[3], LAM) if epilogue else out

            times[name] = timing(kernel, plain,
                                 zoo_sampling_work(dyn, cost, ops, K, T_, kind, False,
                                                   epilogue),
                                 timed_plain and epilogue)
    emit("zoo_kernels", pair=pair, K=K, T=T_, pure_noise_percentage=p, stride=stride,
         crashed_share=crashed, checks=[c for cs in by_kernel.values() for c in cs],
         times=times)
    return by_kernel, times


def division_phase(dev):
    """The eager (combined) path divides by device scalars, as the kernels:
    at lambda 0.3 and T = 100 (inexact reciprocals) its costs equal the
    rollout kernel's on the same samples to the last bit (a zero mean makes
    the LR term 0 on both paths), and its weights equal exp(-(J - baseline)
    / lambda) with one IEEE division and the plain versions' weights (the
    CPU computation of the same formula, which divides)."""
    ctrl = VanillaMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                       make_sampler("gaussian"), dt=DT, lam=LAM_DIVISION, alpha=ALPHA,
                       num_timesteps=T, num_rollouts=K_MAIN, kernel="combined",
                       return_samples=True)
    eps = torch.randn((K_MAIN, T, C), generator=torch.Generator(device=dev).manual_seed(91),
                      device=dev)
    x = torch.tensor(X0, device=dev)
    res, _ = ctrl.solve(x, ctrl.init_state(seed=0), injected_noise=eps)
    U = res.sampled_controls.contiguous()
    lr = (torch.zeros((T, C), device=dev), ctrl.sampler._sigma(T, 0).contiguous(),
          ctrl.sampler.control_cost_coeff, LAM_DIVISION, ALPHA,
          ctrl.sampler.pure_threshold(K_MAIN))
    kc, kcrash = fr.fused_rollout_costs(ctrl.dynamics, ctrl.cost, x, U, DT, lr)
    torch.cuda.synchronize()
    same("combined costs and the rollout kernel's (lambda 0.3, T = 100)", res.costs, kc)
    same("combined and kernel crash flags", res.crash, kcrash)
    want = torch.exp(-(res.costs - res.baseline) / torch.tensor(LAM_DIVISION, device=dev))
    same("combined weights and the true-division weights", res.weights, want)
    host = weights.norm_exp_weights(res.costs.cpu(), LAM_DIVISION, res.baseline.cpu())
    # what the division by a host scalar (the code before the fix) gives on
    # the card: costs of the same sums divided by T as a host number
    total = res.costs * torch.tensor(float(T), device=dev)
    old_costs = total / T
    new_costs = total / torch.tensor(float(T), device=dev)
    old_weights = torch.exp(-(res.costs - res.baseline) / LAM_DIVISION)
    emit("division", K=K_MAIN, T=T, lam=LAM_DIVISION, max_ulp_costs=0,
         weights_vs_cpu_max_abs=float((res.weights.cpu() - host).abs().max()),
         host_scalar_division_differs={
             "costs (of J T / T)": int((old_costs != new_costs).sum()),
             "weights": int((old_weights != res.weights).sum())},
         checks=[check("combined costs vs rollout kernel", res.costs, kc, "bitwise")])


def model_loop_phase(path, ctrl, x0, steps, want, *, plant=None, slide_first=True,
                     on_step=None, profile=True, initial_mean=None, **labels):
    """``steps`` closed-loop steps of a model's configuration (AutoRally, the
    bicycle, the zoo) from ``x0`` through the entry points: slide, solve,
    step the plant with the first control (``slide_first=False``: solve,
    plant, slide, as tests/test_vanilla_mppi.py:80-107); then, with
    ``profile``, a short profiler window. Records the crashed share and the
    final state; the task bars are the callers'. ``plant(x, u)`` replaces the model's
    step; ``on_step(i, x, ctrl)`` may return a new cost (the waypoint
    updates). Fails unless the kernels launched as ``want`` says and every
    state is finite. Returns (launches, entry launches, the states
    (steps, S), the last result)."""
    if ctrl.device.type != "cuda":
        raise AssertionError("the controller did not default to the card")
    K_, T_, C_ = ctrl.num_rollouts, ctrl.num_timesteps, ctrl.dynamics.CONTROL_DIM
    plant = plant or (lambda x, u: ctrl.dynamics.step(x, u, 0.0, ctrl.dt)[0])
    cs, x = ctrl.init_state(seed=0, initial_mean=initial_mean), x0
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(steps)]
    states, crashed, extra = [], [], {}
    torch.cuda.synchronize()
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        ev[i][0].record()
        if slide_first:
            cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        ev[i][1].record()
        x = plant(x, res.control_mean[0])
        if not slide_first:
            cs = ctrl.slide_control_sequence(cs, 1)
        ev[i][2].record()
        states.append(x)
        crashed.append(res.crash.sum())
        if on_step is not None:
            new_cost = on_step(i, x, ctrl, extra)
            if new_cost is not None:
                ctrl.cost = new_cost
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, entries = dict(fr.launch_counts), dict(fr.entry_counts)
    expect_launches(launches, want, path)
    X = torch.stack(states).cpu()
    for name, t in (("states", X), ("control_mean", res.control_mean), ("costs", res.costs),
                    ("state_trajectory", res.state_trajectory)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{path}: {name} is not finite")
    if res.control_mean.shape != (T_, C_) or res.costs.shape != (K_,):
        raise AssertionError(f"{path}: unexpected result shapes")
    steady = ev[5:]  # the first solves include one-time allocations
    emit(f"{path}_main_path", K=K_, T=T_, **labels, kernel=ctrl.kernel,
         weight_transform=ctrl.weight_transform, steps=steps, launches=launches,
         entry_launches=entries, launches_per_step=sum(launches.values()) / steps,
         crashed_share=float(torch.stack(crashed).float().mean().cpu()) / K_,
         final_state=X[-1].tolist(), final_baseline=float(res.baseline), **extra,
         solve_ms_median=statistics.median(e[0].elapsed_time(e[1]) for e in steady),
         step_ms_median=statistics.median(e[0].elapsed_time(e[2]) for e in steady),
         host_wall_ms_per_step=1e3 * wall_s / steps)
    if profile:
        def step():
            s = ctrl.slide_control_sequence(cs, 1)
            r, _ = ctrl.solve(x, s)
            plant(x, r.control_mean[0])

        profile_steps(path, step, n=4, warmup=1)
    return launches, entries, X, res


def build_zoo(pair, kernel, K=K_ZOO, T_=T_ZOO, sampler=None, **kw):
    """A zoo pair's VanillaMPPI on the card; the Gaussian of the pair's std
    by default (the quadrotor's without a control cost, as
    tests/test_model_zoo.py:60-92 and the waypoint example)."""
    dyn, cost, _, std, _, _ = zoo_parts(pair)
    if sampler is None:
        coeff = [0.0] * dyn.CONTROL_DIM if pair.startswith("quadrotor") else None
        sampler = GaussianDistribution.create(std_dev=std, control_cost_coeff=coeff)
    return VanillaMPPI(dyn, cost, sampler, dt=kw.pop("dt", DT), lam=kw.pop("lam", LAM),
                       alpha=kw.pop("alpha", ALPHA), num_timesteps=T_, num_rollouts=K,
                       num_iters=1, kernel=kernel, **kw)


def build_cartpole(kernel, **kw):
    """bench.py:599-608 on the card: control range +-5, coefficients (100,
    10, 200, 20), Gaussian std 5 (coefficient 1), dt 0.02, lambda 1."""
    return build_zoo("cartpole", kernel, sampler=GaussianDistribution.create(std_dev=CART_STD),
                     **kw)


def zoo_loops(dev):
    """The zoo's closed loops. Returns {path: (launches, entry launches)}."""
    n, n_b1 = CLOSED_LOOP_STEPS, ZOO_B1_STEPS
    solve_want = {"fused_solve_kernel": n, "flash_combine_kernel": n}
    b1_want = {"rollout_costs_kernel": n_b1, "flash_combine_kernel": n_b1}
    paths = {}

    def run(path, *a, **kw):
        out = model_loop_phase(path, *a, **kw)
        paths[path] = out[:2]
        return out

    # the bench row cartpole_example_K8192 from x0 = 0
    run("cartpole_fused_solve", build_cartpole("fused_solve"), torch.zeros(4, device=dev), n,
        solve_want)
    # tests/test_vanilla_mppi.py:80-107 at K=8192 on the fused solve: dt 0.01,
    # lambda 0.25, std 5, control cost 1, 1 % pure noise, slide_scale 1;
    # solve, plant x + state_deriv dt, slide; its bar
    swing = VanillaMPPI(CartpoleDynamics.create(), CartpoleQuadraticCost(coeffs=CART_COEFFS),
                        GaussianDistribution.create(std_dev=CART_STD, control_cost_coeff=[1.0],
                                                    pure_noise_percentage=0.01),
                        dt=0.01, lam=0.25, alpha=0.0, slide_scale=[1.0], num_timesteps=T_ZOO,
                        num_rollouts=K_ZOO, num_iters=1, kernel="fused_solve")
    ns = SWINGUP_STEPS
    _, _, X, res = run(
        "cartpole_swingup", swing, torch.zeros(4, device=dev), ns,
        {"fused_solve_kernel": ns, "flash_combine_kernel": ns},
        plant=lambda x, u: x + swing.dynamics.state_deriv(x, u) * swing.dt,
        slide_first=False, profile=False)
    theta_err = abs(float(torch.remainder(X[-1, 2], 2 * np.pi)) - np.pi)
    emit("cartpole_swingup_bar", final_baseline=float(res.baseline), theta_error=theta_err,
         final_state=X[-1].tolist(), bar={"baseline": 1.0, "theta_error": 0.3})
    if not (float(res.baseline) < 1.0 and theta_err < 0.3):
        raise AssertionError(f"cartpole swing-up missed its bar: baseline "
                             f"{float(res.baseline)}, pole angle error {theta_err}")
    # the B1 and B4 entries on short main paths
    run("cartpole_fused", build_cartpole("fused"), torch.zeros(4, device=dev), n_b1, b1_want,
        profile=False)
    run("cartpole_tsallis", build_cartpole("fused_solve", weight_transform="tsallis"),
        torch.zeros(4, device=dev), n_b1, {"fused_sample_rollout_kernel": n_b1},
        profile=False)
    # tests/test_model_zoo.py:60-92: the hover from (1, 0, -0.5), hover
    # thrust as the initial mean, K=512, T=48, 150 steps; its bar
    hover_mean = torch.tensor([0.0, 0.0, 0.0, HOVER_THRUST], device=dev).expand(T_HOVER, 4)
    x0 = zoo_parts("quadrotor_quadratic", dev)[2]
    nh = HOVER_STEPS
    _, _, X, _ = run("quadrotor_hover", build_zoo("quadrotor_quadratic", "fused_solve",
                                                     K=K_HOVER, T_=T_HOVER), x0, nh,
                        {"fused_solve_kernel": nh, "flash_combine_kernel": nh},
                        initial_mean=hover_mean)
    pos_err = float(torch.linalg.vector_norm(X[-1, :3]))
    emit("quadrotor_hover_bar", position_error=pos_err, final_state=X[-1].tolist(),
         bar={"position_error": 0.5})
    if not pos_err < 0.5:
        raise AssertionError(f"quadrotor hover missed its bar: position error {pos_err}")
    run("quadrotor_fused", build_zoo("quadrotor_quadratic", "fused", K=K_HOVER, T_=T_HOVER),
        x0, n_b1, b1_want, initial_mean=hover_mean, profile=False)
    # examples/quadrotor_waypoint_example.py on the synthetic one-gate map:
    # the waypoint advances when the vehicle enters the gate margin
    def advance(i, x, ctrl, extra):
        wp = WAYPOINTS[extra.setdefault("gates_reached", 0) % len(WAYPOINTS)]
        if float(torch.linalg.vector_norm(x[:3] - torch.tensor(wp[:3], device=dev))) < 0.5:
            extra["gates_reached"] += 1
            if extra["gates_reached"] < len(WAYPOINTS):
                return ctrl.cost.update_waypoint(*WAYPOINTS[extra["gates_reached"]])
        return None

    qz = torch.zeros(13, device=dev)
    qz[6] = 1.0
    run("quadrotor_waypoint", build_zoo("quadrotor_map", "fused_solve", K=K_WAYPOINT,
                                        T_=T_HOVER), qz, WAYPOINT_STEPS,
        {"fused_solve_kernel": WAYPOINT_STEPS, "flash_combine_kernel": WAYPOINT_STEPS},
        initial_mean=hover_mean, on_step=advance, profile=False)
    run("quadrotor_waypoint_fused", build_zoo("quadrotor_map", "fused", K=K_WAYPOINT,
                                              T_=T_HOVER), qz, n_b1, b1_want,
        initial_mean=hover_mean, profile=False)
    # the Dubins car to a goal trajectory (the gather by t) and to a fixed goal
    dub = torch.tensor([0.0, 0.0, 3.0], device=dev)
    run("dubins_fused_solve", build_zoo("dubins_trajectory", "fused_solve"), dub, n_b1,
        {"fused_solve_kernel": n_b1, "flash_combine_kernel": n_b1}, profile=False)
    run("dubins_fused", build_zoo("dubins_quadratic", "fused"), dub, n_b1, b1_want,
        profile=False)
    # examples/double_integrator_example.py: T=65, K=128, dt 0.015, lambda 1,
    # alpha 1, start (-9, -9, 0.1, 0.1); its colored sampler on kernel="fused"
    # (the colored draw is eager, JAX draws it in XLA on pallas_fused too), and
    # a Gaussian of the same std on the fused solve
    ex = dict(K=128, T_=65, dt=0.015, lam=1.0, alpha=1.0)
    dix = torch.tensor([-9.0, -9.0, 0.1, 0.1], device=dev)
    run("di_quadratic", build_zoo("di_quadratic", "fused", sampler=ColoredNoiseDistribution.create(
        std_dev=[0.5, 0.5], exponents=[1.0, 1.0]), **ex), dix, n,
        {"rollout_costs_kernel": n, "flash_combine_kernel": n})
    run("di_quadratic_fused_solve", build_zoo("di_quadratic", "fused_solve", **ex), dix, n,
        solve_want)
    return paths


def bench_row_loops(dev):
    """Two bench rows that need no new kernel code: the bicycle on the
    1024^2 map (bench.py:755-773) and the DI row at K=1024 (:593-597)."""
    n = CLOSED_LOOP_STEPS
    data = np.abs(np.random.default_rng(2).normal(size=(1024, 1024))).astype("f")
    tex = MapTexture2D(data, origin=(-51.2, -51.2, 0.0), resolution=0.1)
    bicycle = VanillaMPPI(BicycleSlipDynamics.create(),
                          ARStandardCost(costmap=tex, output_indices=BI_OUTPUT_INDICES),
                          colored_sampler(None, 0.0, BI_STD, BI_EXPONENTS), dt=DT, lam=LAM,
                          alpha=ALPHA, num_timesteps=T_BI, num_rollouts=K_BI, num_iters=1,
                          kernel="fused")
    paths = {"bicycle_1024": model_loop_phase(
        "bicycle_1024", bicycle, torch.zeros(S_BI, device=dev), n,
        {"rollout_costs_kernel": n, "flash_combine_kernel": n}, map="1024")[0]}
    di = VanillaMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                     make_sampler("gaussian"), dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T,
                     num_rollouts=1024, num_iters=1, kernel="fused_solve")
    launches, _, X, _ = model_loop_phase(
        "di_K1024", di, torch.tensor(X0, device=dev), n,
        {"fused_solve_kernel": n, "flash_combine_kernel": n})
    r = torch.hypot(X[:, 0], X[:, 1])
    out_of_band = int(((r <= BAND[0]) | (r >= BAND[1])).sum())
    emit("di_K1024_band", radius_range=[float(r.min()), float(r.max())],
         out_of_band_steps=out_of_band)
    if out_of_band >= MAX_OUT_OF_BAND:
        raise AssertionError(f"di_K1024: {out_of_band} of {n} steps outside {BAND}")
    paths["di_K1024"] = launches
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={name: [line.strip() for line in b["log"].splitlines()
                       if "registers" in line or "Compiling entry" in line]
                for name, b in built.items()})

    errs = dict.fromkeys(fr.launch_counts, 0.0)

    def note(kernel, checks):
        for c in checks:
            errs[kernel] = max(errs[kernel], c["max_abs_err"])

    main_times = None
    for K, p, seed in ((K_MAIN, 0.0, 1), (K_RAGGED, 0.1, 2)):
        checks, times = kernel_phase(dev, K, p, seed)
        note("flash_combine_kernel",
             [c for c in checks if c["check"].startswith("flash_combine")])
        note("rollout_costs_kernel",
             [c for c in checks if not c["check"].startswith("flash_combine")])
        if K == K_MAIN:
            main_times = times
    checks_b, checks_l, ric_times = riccati_phase(dev)
    note("riccati_backward_kernel", checks_b)
    note("riccati_ladder_kernel", checks_l)
    rmppi_times = None
    for K, seed in ((K_R, 3), (K_R_RAGGED, 4)):
        checks, t = rmppi_phase(dev, K, seed)
        note("rmppi_rollout_kernel", checks)
        rmppi_times = rmppi_times or t
    checks, x0_times = x0_phase(dev)
    note("rollout_costs_kernel", checks)
    errs["fused_sample_rollout_kernel"] = philox_phase(dev)
    solve_times = None
    for K, p, stride, seed in ((K_MAIN, 0.0, 0, 7), (K_RAGGED, 0.1, 2, 8)):
        b3, b4, times = fused_kernel_phase(dev, K, p, stride, seed)
        note("fused_solve_kernel", b3)
        note("fused_sample_rollout_kernel", b4)
        solve_times = solve_times or times

    ar_errs = dict.fromkeys(("rollout_costs_kernel", "fused_solve_kernel",
                             "flash_combine_kernel"), 0.0)
    ar_times = {}
    for map_kind, K, p, stride, seed in (("128", K_AR, 0.0, 0, 51),
                                         ("128", K_AR_RAGGED, 0.1, 2, 52),
                                         ("1024", K_AR, 0.0, 0, 53)):
        checks, times = ar_kernel_phase(dev, map_kind, K, p, stride, seed,
                                        timed_plain=(map_kind, K) == ("128", K_AR))
        for c in checks:
            name = ("fused_solve_kernel" if c["check"].startswith("B3")
                    else "rollout_costs_kernel")
            if c["check"].endswith(("new_mean", "baseline", "eta")):
                name = "flash_combine_kernel"
            ar_errs[name] = max(ar_errs[name], c["max_abs_err"])
        if K == K_AR:
            ar_times[map_kind] = times

    # the colored rows: B1's Tsallis mode, B5, the merge; B1's bicycle entry
    kinds = ("rollout_costs_kernel", "tsallis_reduce_kernel", "flash_combine_kernel")
    ts_errs, bi_errs = dict.fromkeys(kinds, 0.0), dict.fromkeys(kinds, 0.0)

    def note_into(into, by_kernel):
        for kernel, checks in by_kernel.items():
            for c in checks:
                into[kernel] = max(into[kernel], c["max_abs_err"])

    ts_times = None
    for K, p, stride, seed in ((K_MAIN, 0.0, 0, 71), (K_RAGGED, 0.1, 2, 72)):
        by_kernel, times = tsallis_kernel_phase(dev, K, p, stride, seed)
        note_into(ts_errs, by_kernel)
        ts_times = ts_times or times
    bi_times = None
    for K, p, stride, seed in ((K_BI, 0.0, 0, 81), (K_BI_RAGGED, 0.1, 2, 82)):
        by_kernel, times = bicycle_kernel_phase(dev, K, p, stride, seed,
                                                timed_plain=K == K_BI)
        note_into(bi_errs, by_kernel)
        bi_times = bi_times or times

    # the analytic model zoo: every new entry against its plain version
    zoo_errs, zoo_times = {}, {}
    for i, (pair, K, p, stride) in enumerate(
            [(pair, K_ZOO, 0.0, 0) for pair in ZOO_PAIRS]
            + [("cartpole", K_ZOO_RAGGED, 0.1, 2)]):
        by_kernel, times = zoo_kernel_phase(dev, pair, K, p, stride, 101 + i,
                                            timed_plain=K == K_ZOO)
        errs_p = zoo_errs.setdefault(pair, dict.fromkeys(by_kernel, 0.0))
        note_into(errs_p, by_kernel)
        zoo_times.setdefault(pair, times)
    division_phase(dev)

    reference_phase(dev)
    robust_reference_phase(dev)
    fused_reference_phase(dev)
    ar_reference_phase(dev)
    colored_reference_phase(dev)
    by_path = {"vanilla": vanilla_loop_phase("vanilla", build_vanilla("gaussian", "fused"), {
                   "rollout_costs_kernel": CLOSED_LOOP_STEPS,
                   "flash_combine_kernel": CLOSED_LOOP_STEPS}, settle=True),
               "rmppi": robust_loop_phase("rmppi"),
               "tube": robust_loop_phase("tube")}
    for kind in SAMPLERS:
        by_path["vanilla_fused_solve" if kind == "gaussian" else kind] = (
            fused_loop_phase(kind))
    n, n_f = CLOSED_LOOP_STEPS, AR_FUSED_LOOP_STEPS
    ar_paths = {
        "autorally": ar_loop_phase("autorally", "128", "fused_solve", n, {
            "fused_solve_kernel": n, "flash_combine_kernel": n}),
        "autorally_1024": ar_loop_phase("autorally_1024", "1024", "fused_solve", n, {
            "fused_solve_kernel": n, "flash_combine_kernel": n}),
        "autorally_fused": ar_loop_phase("autorally_fused", "128", "fused", n_f, {
            "rollout_costs_kernel": n_f, "flash_combine_kernel": n_f}),
    }
    colored_paths = {
        "colored_fused": vanilla_loop_phase(
            "colored_fused", build_colored("exp", "fused"),
            {"rollout_costs_kernel": n, "flash_combine_kernel": n}, settle=False),
        "colored_tsallis": vanilla_loop_phase(
            "colored_tsallis", build_colored("tsallis", "fused"),
            {"rollout_costs_kernel": n, "tsallis_reduce_kernel": n,
             "flash_combine_kernel": n}, settle=False),
    }
    bicycle_paths = {
        "bicycle_colored": model_loop_phase(
            "bicycle_colored", build_bicycle("fused"), torch.zeros(S_BI, device=dev), n,
            {"rollout_costs_kernel": n, "flash_combine_kernel": n}, map="128")[0],
    }
    row_paths = bench_row_loops(dev)
    bicycle_paths["bicycle_1024"] = row_paths["bicycle_1024"]
    by_path["di_K1024"] = row_paths["di_K1024"]
    zoo_paths = zoo_loops(dev)

    def entry(name, source, replaces, t, library_ms, paths=by_path, err=None,
              kernel=None, **extra):
        kernel = kernel or name
        return {"name": name, "route": "cuda",
                "source": f"mppi_generic_tpu_torch/csrc/{source}",
                "replaces": f"mppi_generic_tpu/ops/{replaces}",
                "launches": sum(c[kernel] for c in paths.values()),
                "launches_by_path": {p: c[kernel] for p, c in paths.items()},
                "max_abs_err": errs[name] if err is None else err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": library_ms, **extra}

    epi, comb = main_times["epilogue+lr"], main_times["flash_combine"]
    modes = {m: main_times[m] for m in ("costs", "costs+lr", "epilogue+lr")}
    modes["x0"] = dict(x0_times, K=N_CAND * S_PER, T=T_R)
    # the AutoRally step and cost inside B1 and B3: device functions, not
    # launches of their own
    ar_functions = {
        "fnn_forward (csrc/fnn.cuh)": "mppi_generic_tpu/nn/fnn.py:80",
        "map_query_world (csrc/map_texture.cuh)":
            "mppi_generic_tpu/maps/texture.py:456, :373, :62, :568",
    }
    ar, ar1024 = ar_times["128"], ar_times["1024"]
    kernels = [
        entry("rollout_costs_kernel", "pair_di_circle.cu", "pallas_rollout.py:548", epi,
              epi["library_ms"], modes=modes),
        entry("flash_combine_kernel", "flash_combine.cu", "pallas_rollout.py:1005",
              comb, None),
        entry("riccati_backward_kernel", "riccati.cu", "pallas_riccati.py:137",
              ric_times["riccati_backward"], None, on_main_path=False,
              chain_steps=T_R - 1),
        entry("riccati_ladder_kernel", "riccati.cu", "pallas_riccati.py:203",
              ric_times["riccati_ladder"], None, chain_steps=T_R - 1),
        entry("rmppi_rollout_kernel", "rmppi_rollout.cu", "pallas_rollout.py:2127",
              rmppi_times, None),
        entry("fused_solve_kernel", "pair_di_circle.cu", "pallas_solve.py:103",
              solve_times["solve gaussian"], None,
              modes={"nln": solve_times["solve nln"]},
              randn_reference_ms=solve_times["randn_reference_ms"]),
        entry("fused_sample_rollout_kernel", "pair_di_circle.cu", "pallas_rollout.py:1631",
              solve_times["smooth epilogue"], None,
              modes={m: solve_times[m] for m in ("gaussian", "nln", "smooth")},
              randn_reference_ms=solve_times["randn_reference_ms"]),
        entry("fused_solve_kernel<AutorallyNN, ARCost>", "pair_ar_nn.cu",
              "pallas_solve.py:103", ar["B3 gaussian"], None, paths=ar_paths,
              err=ar_errs["fused_solve_kernel"], kernel="fused_solve_kernel",
              K=K_AR, T=T_AR, device_functions=ar_functions,
              modes={"nln": ar["B3 nln"], "gaussian 1024^2 map": ar1024["B3 gaussian"],
                     "nln 1024^2 map": ar1024["B3 nln"]}),
        entry("rollout_costs_kernel<AutorallyNN, ARCost>", "pair_ar_nn.cu",
              "pallas_rollout.py:548", ar["B1 epilogue+lr"],
              ar["B1 epilogue+lr"]["library_ms"], paths=ar_paths,
              err=ar_errs["rollout_costs_kernel"], kernel="rollout_costs_kernel",
              K=K_AR, T=T_AR, device_functions=ar_functions,
              modes={**{m: ar[f"B1 {m}"] for m in ("costs", "costs+lr", "epilogue")},
                     **{f"{m} 1024^2 map": ar1024[f"B1 {m}"]
                        for m in ("costs", "costs+lr", "epilogue", "epilogue+lr")}}),
        entry("flash_combine_kernel (AutoRally paths)", "flash_combine.cu",
              "pallas_rollout.py:1005", ar["flash_combine"], None, paths=ar_paths,
              err=ar_errs["flash_combine_kernel"], kernel="flash_combine_kernel"),
        # the colored rows: the rollout kernel's exp epilogue (colored_fused,
        # timed above at the same shapes) and its Tsallis pass 1
        # (colored_tsallis), the Tsallis reduction and the merge
        entry("rollout_costs_kernel (Tsallis pass 1; colored paths)", "pair_di_circle.cu",
              "pallas_rollout.py:894", ts_times["pass1"], None, paths=colored_paths,
              err=ts_errs["rollout_costs_kernel"], kernel="rollout_costs_kernel",
              modes={"epilogue+lr (colored_fused)": epi}),
        entry("tsallis_reduce_kernel", "tsallis_reduce.cu", "pallas_rollout.py:1342",
              ts_times["tsallis_reduce"], ts_times["tsallis_reduce"]["library_ms"],
              paths=colored_paths,
              err=max(ts_errs["tsallis_reduce_kernel"], bi_errs["tsallis_reduce_kernel"]),
              library_calls=ts_times["tsallis_reduce"]["library_calls"],
              modes={m: ts_times[m] for m in (
                  "tsallis_reduce entry (rho given, with the merge)",
                  "chain (pass 1, B5, merge)")}),
        entry("flash_combine_kernel (colored and bicycle paths)", "flash_combine.cu",
              "pallas_rollout.py:1005", ts_times["merge"], None,
              paths={**colored_paths, **bicycle_paths},
              err=max(ts_errs["flash_combine_kernel"], bi_errs["flash_combine_kernel"]),
              kernel="flash_combine_kernel"),
        entry("rollout_costs_kernel<BicycleSlip, ARCostBicycle>", "pair_bicycle_ar.cu",
              "pallas_rollout.py:548", bi_times["epilogue+lr"],
              bi_times["epilogue+lr"]["library_ms"], paths=bicycle_paths,
              err=bi_errs["rollout_costs_kernel"], kernel="rollout_costs_kernel",
              K=K_BI, T=T_BI,
              modes={m: bi_times[m] for m in ("costs", "costs+lr", "tsallis+lr")}),
    ]
    # the zoo's entries: launches counted per entry (fr.entry_counts) on the
    # zoo's loops
    def zoo_entry(name, pair, fn, replaces, t, errs_p, kernel, **extra):
        by = {p: e.get(fn, 0) for p, (_, e) in zoo_paths.items() if e.get(fn, 0)}
        return {"name": name, "route": "cuda",
                "source": f"mppi_generic_tpu_torch/csrc/pair_{pair}.cu",
                "replaces": f"mppi_generic_tpu/ops/{replaces}",
                "launches": sum(by.values()), "launches_by_path": by,
                "max_abs_err": errs_p[kernel], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"), **extra}

    cart = zoo_times["cartpole"]
    zoo_names = {"cartpole": "Cartpole, CartpoleQuadraticCost",
                 "quadrotor_quadratic": "Quadrotor, QuadrotorQuadraticCost",
                 "quadrotor_map": "Quadrotor, QuadrotorMapCost",
                 "dubins_quadratic": "Dubins, QuadraticCostT<3>",
                 "di_quadratic": "DoubleIntegrator, QuadraticCostT<4>"}
    for pair, types in zoo_names.items():
        t, e = zoo_times[pair], zoo_errs[pair]
        modes = {m: t[f"B1 {m}"] for m in ("costs", "costs+lr", "tsallis+lr")}
        if pair == "dubins_quadratic":
            modes.update({f"goal trajectory {m}": zoo_times["dubins_trajectory"][f"B1 {m}"]
                          for m in ("costs", "costs+lr", "epilogue+lr", "tsallis+lr")})
            e = {k: max(v, zoo_errs["dubins_trajectory"][k]) for k, v in e.items()}
        kernels.append(zoo_entry(
            f"rollout_costs_kernel<{types}>", pair, f"rollout_costs_{pair}",
            "pallas_rollout.py:548", t["B1 epilogue+lr"], e, "rollout_costs_kernel",
            K=K_ZOO, T=T_ZOO, modes=modes))
        solve_modes = {m: t[m] for m in t if m.startswith("B3") and m != "B3 gaussian"}
        if pair == "dubins_quadratic":
            solve_modes["goal trajectory"] = zoo_times["dubins_trajectory"]["B3 gaussian"]
        kernels.append(zoo_entry(
            f"fused_solve_kernel<{types}>", pair, f"fused_solve_{pair}",
            "pallas_solve.py:103", t["B3 gaussian"], e, "fused_solve_kernel",
            K=K_ZOO, T=T_ZOO, modes=solve_modes))
    kernels.append(zoo_entry(
        "fused_sample_rollout_kernel<Cartpole, CartpoleQuadraticCost>", "cartpole",
        "fused_sample_rollout_cartpole", "pallas_rollout.py:1631", cart["B4 smooth epilogue"],
        zoo_errs["cartpole"], "fused_sample_rollout_kernel", K=K_ZOO, T=T_ZOO,
        modes={m: cart[f"B4 {m}"] for m in ("gaussian", "nln", "smooth")}))
    merge_paths = {p: l for p, (l, _) in zoo_paths.items()}
    kernels.append(entry(
        "flash_combine_kernel (zoo paths)", "flash_combine.cu", "pallas_rollout.py:1005",
        ts_times["merge"], None, paths=merge_paths,
        err=max(e["flash_combine_kernel"] for e in zoo_errs.values()),
        kernel="flash_combine_kernel"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
