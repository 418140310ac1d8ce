"""Smoke run of the PyTorch/CUDA port (mppi_generic_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mppi_generic_tpu_torch/csrc`` (into
``build/torch_kernels/``), holds each kernel against its plain PyTorch
version on the card, checks the in-kernel Philox draw bit for bit and by
its statistics, holds each redesigned kernel against its earlier build and
times the two A B B A (first: ``ladder_forms``, ``staged_forms``,
``merge_cost_forms``, and ``pass_forms`` for the carry and minima passes
after the warp forms; B6 over a warp against its one-thread build where it
is checked, in ``riccati_kernels`` and ``robust_kernels``), and drives six closed
loops through the port's entry
points: the flagship vanilla MPPI (double integrator, circle cost, Gaussian
sampler, K=8192, T=100) on the precomputed-noise kernels, RMPPI and
Tube-MPPI with DDP feedback on the same task (bench.py:809-840: K=2560,
T=50, lambda 2, 9 candidates x 256 samples for RMPPI), and the fused solve
(``kernel="fused_solve"``, the samples drawn in the kernels) for the
flagship and the JAX suite's NLN and Smooth-MPPI rows (bench.py:619-638,
K=8192, T=100). Then AutoRally (bench.py:704-717 and :775-789: the 6-32-32-4
network dynamics and ARStandardCost on the 128^2 and the 4 x 1024^2
channel-major track maps, K=1920, T=150): the fused solve and rollout
kernels' AutoRally entries against their plain versions, the warp forms
of the fused solve and of the rollout kernel (one warp a sample, then
their epilogue pass) also bit for bit against their one-thread build and
A B B A against it on the 128^2 map (``autorally_kernels``; the racer
rows' B3 and B1 alike in ``racer_kernels``, AutoRally's per-sample-x0 B1
in ``robust_kernels``), a
fused-vs-combined reference, and three closed
loops with the AutoRally model as the plant (``autorally``,
``autorally_1024`` on the fused solve, ``autorally_fused`` on
``kernel="fused"``). Then the colored-noise rows (bench.py:641-702): the
rollout kernel's Tsallis mode, the Tsallis reduction kernel (its tiled form
also bit for bit and A B B A against the one-block build) and the merge
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
(``bicycle_1024``, bench.py:755-773, and ``di_K1024``, :593-597). Then the
racer LSTM rows (bench.py:719-743, :791-807: the LSTM-steering model on the
128^2 elevation map with ARStandardCost on the 128^2 track map, K=1920,
T=100; the LSTM-uncertainty model on flat ground, K=1920, T=150): their B1
entries in four modes and B3 entries (Gaussian, NLN), the LSTM step (B10)
inside, against their plain versions at K=1920 and the ragged K=1900
(``racer_kernels``), a fused-vs-combined reference without host syncs
(``racer_reference``), and the closed loops ``racer_steering`` (4 steps)
and ``racer_unc`` (2 steps: its eager re-rollout of the mean is about 10^5
launches) on the fused solve, ``racer_steering_fused`` and
``racer_unc_fused`` on ``kernel="fused"``. Then the robust family beyond the
double integrator (the AutoRally instantiation's width,
instantiations/__init__.py:56-67: K=1920, T=150): the RMPPI kernel's (B8)
AutoRally and DI-robust entries, the per-sample-x0 rollout's AutoRally,
bicycle and DI-robust entries, the DDP ladder (B7) with AutoRally's network
and the cartpole and the backward recursion (B6) at (4, 1) and (7, 2), the
latter also at T = 1024, against their plain versions, AutoRally also on a map where part of the
samples crash, the DI-robust entries and the DI ladder also at the
``rmppi_di_robust`` loop's shapes, B8's staged form for the DI also bit for
bit against its one-thread build and A B B A against it at the loops'
shapes (``robust_kernels``, and ``rmppi_kernel`` for the circle cost); RMPPI (``fused``) and Tube-MPPI
(``fused_solve``) on AutoRally against ``combined`` without host syncs
(``robust_reference_ar``); the loops ``rmppi_autorally`` (ARRobustCost, 9 x
256 candidates' samples) and ``tube_autorally`` with DDP feedback and the
AutoRally model as the plant, ``rmppi_di_robust`` (the JAX suite's RMPPI
loop on DoubleIntegratorRobustCost, tests/test_tube_robust.py:181-199, 60
steps with its disturbances and band bar) and ``instantiations`` (each
per-robot factory: its B3, merge and ladder against their plain versions
at its own K and T, then three solves with its DDP feedback). Then the
split form of B1 and B3 (csrc/split_kernels.cuh) for the double integrator
and AutoRally: every split entry against its plain version at K=8192 /
8000, T=100 and K=1920 / 1900, T=150 (AutoRally also on the partly-crashing
map), each pass timed apart and the whole form timed A B B A against the
combined kernel (``split_kernels``); the flagship's loop with the split
forced on ``fused`` and ``fused_solve`` and on the eager ``kernel="split"``,
with its bar, and AutoRally's with the split forced (``split_loops``); and
the kernel tuner on the flagship (``autotune``). Then every pair on every
kernel mode: the fused sampling kernel (B4) of AutoRally, the quadrotor with
either cost, the Dubins car (a fixed goal and a goal trajectory), the DI
with QuadraticCost or its robust cost, the bicycle and the racer LSTM
models (recurrent mode), B3 of the bicycle and the DI robust cost
(``pair_sample_kernels``), the split entries of the cartpole, the quadrotor
quadratic, the DI and Dubins quadratic, the bicycle and the racer models
(``split_kernels``, A B B A against the combined kernels; the bicycle's
lane-group dynamics pass also bit for bit and A B B A against its
one-thread build) and B1's split
form from one x0 per sample for the DI robust cost and AutoRally
(``split_x0_kernels``), each at its path's shape, a ragged one and, for the
map pairs, the partly-crashing map; then the loops that put each new entry
on a path (``pair_loops``: Tsallis, CEM and Smooth-MPPI on ``fused_solve``,
AutoRally's Tsallis weights on ``fused`` (B1's Tsallis pass 1 and its
minima pass), the split forced on ``fused`` and ``fused_solve``, the
cartpole swing-up and
the quadrotor hover with the split and their bars, RMPPI with stage 1's
split on the DI robust cost with its band bar and on AutoRally). The
earlier phases pass ``split_cost=False``, so they keep the combined kernels
on their paths (AUTO splits only where ``ops/fused_rollout.AUTO_SPLIT``
says so: B1 of AutoRally, racer steering and the bicycle, AutoRally's B1
from one x0 per sample, racer steering's B3). Then the robust family
finished (``finish_kernels``): the later pairs' entries (the cartpole, the
quadrotor with either cost, the Dubins car and the DI with QuadraticCost,
the bicycle, the racer LSTM models: B1 from one x0 per sample, its split
dynamics pass, B8 but for the racers), the DI robust cost's B1 from one x0
and its split dynamics passes, the DI circle cost's split pass from one x0
per sample and the Dubins ladder, each against its plain version at its
loop's shape; their loops (``finish_loops``: RMPPI on each later pair but
the racer uncertainty model, stage 1 combined then forced split; Tube and
the split ``fused`` and ``fused_solve`` on the DI robust cost; the bench
RMPPI row with ``split_cost=True``; Tube and RMPPI with Smooth-MPPI; RMPPI
with BoxQP) and CCM's law and BoxQP's gains against their CPU runs
(``ccm_boxqp``). Then the rest of the racer family (``racer_family``): B1,
B3 and B4 of RACER Dubins, its elevation model, RacerSuspension, the bicycle
on its elevation map and the suspension model with its steering LSTM, and
the racer_unc_ar entries on an elevation map, each against its plain
version at 1920 samples (the modes its loops launch) and 1901 × 17 (every
mode), on the bench's 128^2 elevation and track maps; their loops
(``family_loops``: two steps each on ``fused_solve`` and ``fused``, one on
``fused_solve`` with Smooth-MPPI, the uncertainty model through
``instantiations.racer_lstm_mppi``; the bicycle with a normals map, refused
by the wrappers, one eager step). Each phase prints one JSON
line;
``build`` and ``total`` give the build's and the whole run's seconds. The line before the last lists every kernel with its launches on
the main path, its error against the plain version and its times; the last
line is
``{"ok": true, "device": {...}}``. Any failed check ends the run with a
non-zero exit and no result line. Without CUDA it exits non-zero at once.

Times come from CUDA events. Each timed call is preceded by a device-side
sleep, so the events measure the device and not the host's enqueue.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import functools
import json
import os
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
    ARRobustCost,
    ARStandardCost,
    CartpoleQuadraticCost,
    DoubleIntegratorCircleCost,
    DoubleIntegratorRobustCost,
    QuadraticCost,
    QuadrotorMapCost,
    QuadrotorQuadraticCost,
)
from mppi_generic_tpu_torch.feedback import CCMFeedback
from mppi_generic_tpu_torch.feedback.ilqr import _alpha_ladder, linearize
from mppi_generic_tpu_torch.maps import MapTexture2D
from mppi_generic_tpu_torch.nn import FNN
from mppi_generic_tpu_torch.models import (
    AutorallyNNDynamics,
    BicycleSlipDynamics,
    BicycleSlipParametricElevation,
    CartpoleDynamics,
    DoubleIntegratorDynamics,
    DubinsDynamics,
    QuadrotorDynamics,
    RacerDubinsDynamics,
    RacerDubinsElevationDynamics,
    RacerDubinsElevationLSTMSteering,
    RacerDubinsElevationLSTMUncertainty,
    RacerDubinsElevationSuspension,
    RacerSuspensionDynamics,
    rollout_single,
)
from mppi_generic_tpu_torch.ops import _build, autotune, fused_solve, philox, riccati, weights
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops.rollout import rollout_combined
from mppi_generic_tpu_torch.utils.math_utils import true_div

K_MAIN, K_RAGGED, T, C, S = 8192, 8000, 100, 2, 4
DT, LAM, ALPHA = 0.02, 1.0, 0.0
CLOSED_LOOP_STEPS = 100
N_TIMED, N_TIMED_PLAIN = 100, 10
N_TIMED_KERNEL = 20  # a kernel's profiler window (device_ms)

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
T_B6_MAX = 1024  # the longest horizon B6 takes (riccati.supported)
AR_STD = [0.3, 0.5]
AR_MAPS = ("128", "1024")
# the kernel="fused" loop: B1 on the path, kept short (20 until B1's warp
# form joined the run, cut for time)
AR_FUSED_LOOP_STEPS = 10
# the kernel="fused" loop with Tsallis weights (B1's Tsallis pass 1, with the
# warp form's minima pass, then B5 and the merge), kept shorter
AR_TSALLIS_FUSED_STEPS = 5
# the bench row's fused-solve loop (100 steps until B3's warp form and the
# tiled B5 joined the run, cut for time)
# (50 until B1's warp form joined the run, 30 until the robust family's
# finished entries joined it; cut for time, no bar)
AR_LOOP_STEPS = 20
# an AutoRally plain version takes seconds: one timed run after its warm-up
# keeps the script well inside its time limit (these times are yardsticks)
N_TIMED_PLAIN_AR = 1
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
# the bicycle rows' loops (about 150 ms a step; 15 until the robust
# family's finished entries joined the run, cut for time, no bar)
BICYCLE_LOOP_STEPS = 10
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
STEPS_BY_PATH = {}  # the closed-loop steps of each model and robust loop


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


def time_ms(fn, n, warmup=3):
    """Median device milliseconds of ``fn`` over ``n`` runs after ``warmup``."""
    for _ in range(warmup):
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


def time_plain(fn, pair=None):
    """A plain version's ms: N_TIMED_PLAIN_AR runs (median) after one warm-up
    (thousands of eager launches a run); a racer pair's, whose run takes
    seconds and whose checks have just run it, one run without."""
    if pair in RACER_PAIRS:
        return time_ms(fn, 1, warmup=0)
    return time_ms(fn, N_TIMED_PLAIN_AR, warmup=1)


def plain_timed(fn):
    """(fn's outputs, its device ms): one run of a plain version, timed by
    CUDA events (its checks take its outputs)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def combine_work(nb, T_=T, C_=C):
    TC = T_ * C_
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
        same_as_one_thread(f"B3 {kind} K={K}", lambda args=args: fused_solve.fused_solve_carries(
            *args, optimization_stride=stride), (kc, kcrash, kU, kcarry), "di_circle", "solve")
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
            t = {"ms": form_time(lambda: fused_solve.fused_solve_carries(*args), "di_circle",
                                 "solve", kind),
                 "plain_ms": time_ms(lambda: fused_solve.fused_solve_plain(*args),
                                     N_TIMED_PLAIN)}
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
        def run(lrp=lrp):
            return fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp, split_cost=False)

        kc, kcrash = run()
        pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
        torch.cuda.synchronize()
        checks.append(check(f"costs(lr={with_lr})", kc, pc, "costs"))
        if not torch.equal(kcrash, pcrash):
            raise AssertionError("crash flags differ from the plain version")
        mode = f"costs{'+lr' if with_lr else ''}"
        same_as_one_thread(f"B1 {mode} K={K}", run, (kc, kcrash), "di_circle", "rollout")
        times[mode] = {
            "ms": form_time(run, "di_circle", "rollout", mode, K == K_MAIN),
            "plain_ms": time_ms(lambda: fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp),
                                N_TIMED_PLAIN),
        }
        times[mode]["bound_ms"], times[mode]["bound_by"] = bound_ms(
            *rollout_work(K, False, with_lr))
    # kernel 1, exp-epilogue mode, with LR (the main path's mode)
    def run_epilogue():
        return fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr, split_cost=False)

    kc, kcrash, kcarry = run_epilogue()
    same_as_one_thread(f"B1 epilogue+lr K={K}", run_epilogue, (kc, kcrash, kcarry),
                       "di_circle", "rollout")
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    pcarry = fr.block_carries_plain(pc, U, LAM)
    checks.append(check("epilogue costs", kc, pc, "costs"))
    # m, d and sum_k w_k |U_kj|: the magnitude each carry entry is summed from
    carry_scale = fr.block_carries_plain(pc, U.abs(), LAM).abs()
    checks.append(check("epilogue carry", kcarry, pcarry, "carry", carry_scale))
    if not torch.equal(kcrash, pcrash):
        raise AssertionError("epilogue crash flags differ from the plain version")
    times["epilogue+lr"] = {
        "ms": form_time(run_epilogue, "di_circle", "rollout", "epilogue+lr", K == K_MAIN),
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
    _, _, fm, fb, fe = fr.fused_weighted_rollout(dyn, cost, x0, U, DT, LAM, lr,
                                                 split_cost=False)
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


def build_vanilla(kind, kernel, split_cost=False):
    """The flagship (bench.py:31-50) or the NLN / Smooth-MPPI rows
    (bench.py:619-638) on the card (the controller's default device). The
    combined kernels unless ``split_cost`` says otherwise: the split form
    has phases of its own (``split_kernels``, ``split_loops``)."""
    return VanillaMPPI(
        DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
        make_sampler(kind), dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T,
        num_rollouts=K_MAIN, num_iters=1, kernel=kernel, split_cost=split_cost)


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
    kernel = split_name("di_circle", "sample") if kind == "smooth" else b3_kernel("di_circle")
    n = CLOSED_LOOP_STEPS
    return vanilla_loop_phase(
        "vanilla_fused_solve" if kind == "gaussian" else kind,
        build_vanilla(kind, "fused_solve"), {kernel: n, MERGE: n},
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


FORCED_BY_PATH = {}  # {path: the forms its loop forced against AUTO}


def expect_launches(launches, want, path):
    """Fail unless every kernel launched exactly as often as ``want`` says
    (kernels not named there: never). Records the forms the loop ``path``
    forced against AUTO (``_build.forced_routes``) in FORCED_BY_PATH."""
    FORCED_BY_PATH[path] = sorted(k for k, n in _build.forced_routes.items() if n)
    for name, count in launches.items():
        if count != want.get(name, 0):
            raise AssertionError(
                f"{path}: {name} launched {count} times, expected {want.get(name, 0)}")


def timed(fn, plain):
    return {"ms": time_ms(fn, N_TIMED), "plain_ms": time_ms(plain, N_TIMED_PLAIN)}


def riccati_ops(T_, S_=S, C_=C, n_alpha=0, deriv_ops=0):
    """Floating-point operations of the backward recursion (T-1 steps) and,
    with n_alpha, the ladder's forward passes (csrc/riccati_kernels.cuh),
    each step's model derivative ``deriv_ops`` (the DI's: copies only)."""
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
           + 2 * S_ + deriv_ops)  # the model's derivative, the Euler step
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
    """B6 and B7 at T=50, S=4, C=2, 14 alphas on a real DI linearisation
    (B6 also A B B A against its one-thread build)."""
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
    checks_b = [check("riccati_backward gains", kK, pK, "bitwise"),
                check("riccati_backward feedforward", kk, pk, "bitwise")]
    backward_forms(f"({S}, {C}) T={T_R}", back)
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
        bound_ms(*backward_work(back)))
    n_in_l = n_in + 2 * T_R * (S + C) + S * S + C * C + S * S + 2 * C + N_ALPHA
    n_out_l = n_out + N_ALPHA * (1 + T_R * (S + C))
    times["riccati_ladder"]["bound_ms"], times["riccati_ladder"]["bound_by"] = (
        bound_ms(4 * (n_in_l + n_out_l), riccati_ops(T_R, n_alpha=N_ALPHA)))
    for t in times.values():
        t["chain_steps"] = T_R - 1  # dependent Riccati steps on one thread
    emit("riccati_kernels", T=T_R, S=S, C=C, n_alpha=N_ALPHA,
         checks=checks_b + checks_l, times=times)
    return checks_b, checks_l, times


def backward_work(back):
    """(bytes, operations) of B6 on ``back`` = (As, Bs, dLx, dLu, Q, R,
    Vxx_T, Vx_T): the linearisation and the weights read once, the gains
    and feedforward written once."""
    T_, S_, C_ = back[1].shape
    n_in = T_ * (S_ * S_ + S_ * C_ + S_ + C_) + 2 * S_ * S_ + C_ * C_ + S_
    return 4 * (n_in + T_ * C_ * (S_ + 1)), riccati_ops(T_, S_, C_)


def backward_forms(label, back):
    """B6 on ``back`` against its one-thread build
    (-DMPPI_BACKWARD_ONE_THREAD) bit for bit, and timed A B B A against it
    by CUDA events, with its bound: kept in PASS_TIMES[("backward",
    label)] for the kernels line."""
    kout = riccati.riccati_backward(*back, DT)
    with one_thread_ladder():
        oout = riccati.riccati_backward(*back, DT)
    torch.cuda.synchronize()
    same_bits(f"B6 {label}", kout, oout)
    t = abba_against(lambda: riccati.riccati_backward(*back, DT), one_thread_ladder)
    t["bound_ms"], t["bound_by"] = bound_ms(*backward_work(back))
    t["chain_steps"] = back[0].shape[0] - 1
    PASS_TIMES[("backward", label)] = t


def rmppi_inputs(dev, K, seed, T_=T_R):
    """Raw samples around a mean, DDP gains of the DI task, the sampler's
    sigma and coefficients: the RMPPI kernel's inputs on the main path."""
    g = torch.Generator(device=dev).manual_seed(seed)
    _, fb, xs, us, goal_x, goal_u, _ = di_linearisation(dev, T_)
    gains = fb.compute_feedback(xs[0], goal_x, us).gains
    sampler = GaussianDistribution.create(std_dev=[1.0, 1.0], device=dev)
    mean = 0.3 * torch.randn((T_, C), generator=g, device=dev)
    U, _ = sampler.sample(g, mean, K)
    x_nom = torch.tensor(X0, device=dev)
    x_real = x_nom + torch.tensor([0.08, -0.05, 0.1, -0.1], device=dev)
    return (fb.dynamics, DoubleIntegratorCircleCost(device=dev), x_nom, x_real, U,
            gains, sampler._sigma(T_, 0), sampler.control_cost_coeff, DT, LAM_R, ALPHA)


def rmppi_phase(dev, K, seed, T_=T_R):
    """B8 for the DI circle cost against its plain version (and, bit for
    bit, the one-thread build); at the ``rmppi`` loop's shape (K_R x T_R)
    timed A B B A against the one-thread build."""
    args = rmppi_inputs(dev, K, seed, T_)
    kout = fr.fused_rmppi_rollout(*args)
    pout = fr.rmppi_rollout_plain(*args)
    torch.cuda.synchronize()
    checks = [check(f"rmppi {n}", a, b, "bitwise")
              for n, a, b in zip(("s_nom", "j_real", "s_fb"), kout[:3], pout[:3])]
    checks.append(check("rmppi U_real", kout[4], pout[4], "bitwise"))
    if not torch.equal(kout[3], pout[3]):
        raise AssertionError("RMPPI crash flags differ from the plain version")
    same_as_one_thread_b8(f"rmppi K={K} T={T_}", args, kout)
    fn, plain = (lambda: fr.fused_rmppi_rollout(*args)), (lambda: fr.rmppi_rollout_plain(*args))
    if (K, T_) == (K_R, T_R):
        t = b8_form_time("di_circle", f"K={K} T={T_}", fn)
        t["plain_ms"] = time_ms(plain, N_TIMED_PLAIN)
    else:
        t = timed(fn, plain)
    n_bytes = 4 * (2 * K * T_ * C + 4 * K + T_ * C * S + T_ * C + C + 4 * C + 2 * S
                   + len(DoubleIntegratorCircleCost.PARAM_NAMES))
    t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, K * T_ * OPS_RMPPI + 3 * K)
    emit("rmppi_kernel", K=K, T=T_, checks=checks, times=t)
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
        num_timesteps=T_R, num_rollouts=K_R, nominal_threshold=THRESH_R, kernel=kernel,
        split_cost=False)


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
    """The closed loop of bench.py:457-465 from X0, 100 steps
    (``robust_family_loop``), its band bar, and for RMPPI the breakdown of
    a step."""
    ctrl = build_robust() if kind == "rmppi" else build_tube()
    n = CLOSED_LOOP_STEPS
    if kind == "rmppi":
        # stage 1 of the first step has no nominal system to evaluate yet
        want = {**stage1_launches(ctrl, "di_circle", n - 1),
                split_name("di_circle", "rmppi"): n, LADDER: n}
    else:
        want = {b1_kernel("di_circle"): 2 * n, MERGE: 2 * n,
                LADDER: n}
    launches, _, X, _, cs, x = robust_family_loop(
        kind, ctrl, torch.tensor(X0, device=ctrl.device), n, want, profile=10)
    band_check(kind, X)
    if kind == "rmppi":
        rmppi_breakdown(ctrl, cs, x)
    return launches


def stage1_launches(ctrl, pair, k):
    """The launches of k evaluations of RMPPI's candidates by ``ctrl``: B1
    from one x0 per sample, or its split form (the dynamics pass and the
    cost pass) where the controller's split_cost takes it (AUTO:
    ``fr.AUTO_SPLIT``)."""
    if not fr.resolve_split(ctrl.dynamics, ctrl.cost, ctrl.split_cost, "rollout_x0"):
        return {b1_kernel(pair, x0=True): k}
    return {split_name(pair, "split_dynamics_x0"): k,
            cost_kernel(pair, ctrl.num_candidates * ctrl.samples_per_condition,
                        ctrl.num_timesteps): k}


def band_check(path, X):
    """Fail unless fewer than MAX_OUT_OF_BAND of the states X (steps, S)
    leave the band BAND of radii."""
    r = torch.hypot(X[:, 0], X[:, 1])
    out_of_band = int(((r <= BAND[0]) | (r >= BAND[1])).sum())
    emit(f"{path}_band", radius_range=[float(r.min()), float(r.max())],
         final_radius=float(r[-1]), out_of_band_steps=out_of_band, bar=MAX_OUT_OF_BAND)
    if out_of_band >= MAX_OUT_OF_BAND:
        raise AssertionError(f"{path}: {out_of_band} of {len(r)} steps outside "
                             f"{BAND[0]} < r < {BAND[1]}")


def profile_steps(kind, step, n=10, warmup=3):
    """A torch.profiler window over n calls of ``step`` (closed-loop steps
    from one state, after the launch counts were read): kernel launches and
    device time per step, the device's idle share of the window, the
    largest kernels. Only the device's activity is traced (the host's
    operators would add an event to parse per launch); the loops with
    thousands of launches per step take a shorter window."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    """bench.py:704-717 (or :775-789 on the 1024^2 map) on the card, on the
    combined kernels (the split form has phases of its own)."""
    dyn, cost = ar_parts(map_kind)
    return VanillaMPPI(dyn, cost, ar_sampler("gaussian"), dt=DT, lam=LAM, alpha=ALPHA,
                       num_timesteps=T_AR, num_rollouts=K_AR, num_iters=1, kernel=kernel,
                       return_samples=return_samples, split_cost=False)


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


def min_pass_work(K):
    """(bytes, operations) of Tsallis pass 1's block minima from the costs
    (K,): the costs read once, the minima written once, one comparison a
    sample."""
    return 4 * (K + -(-K // fr.BLOCK)), K


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
    """B3 (Gaussian, NLN) and B1 (its five modes) with the AutoRally entry
    against their plain versions: U, costs, crash flags and block minima to
    the last bit, the carries and the merge as the DI kernels'; the warp
    forms of B3 and B1 also their carry rows in write_block_carry's order
    and every output of the one-thread build bit for bit. Times by CUDA
    events (B3 and B1 A B B A against the one-thread build on the 128^2 map
    at K_AR, where B1's minima pass is also timed alone by the profiler); the
    plain versions' only where ``timed_plain``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn, cost = ar_parts(map_kind, dev)
    x0 = ar_x0(dev)
    mean = 0.2 * torch.randn((T_AR, C), generator=g, device=dev)
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    checks, times, crashed = [], {}, {}

    def timing(kernel, plain, work, form=None, kind="solve"):
        # form: the mode of a B3 (or, kind "rollout", B1) launch, A B B A at
        # the path's shape
        t = {"ms": (form_time(kernel, "ar_nn", kind, form, at_path)
                    if form else time_ms(kernel, N_TIMED)),
             "plain_ms": time_plain(plain) if timed_plain else None}
        t["bound_ms"], t["bound_by"] = bound_ms(*work)
        return t

    at_path = map_kind == "128" and K == K_AR

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
        kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, split_cost=False,
                                                                 **kw)
        name = f"B3 {kind}"
        same_as_one_thread(f"AutoRally {name} K={K} map {map_kind}", lambda args=args: (
            fused_solve.fused_solve_carries(*args, split_cost=False, **kw)),
            (kc, kcrash, kU, kcarry), "ar_nn", "solve")
        pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, **kw)
        torch.cuda.synchronize()
        same(f"{name} crash flags", kcrash, pcrash)
        same(f"{name} carry rows in write_block_carry's order", kcarry,
             fr.block_carries_ordered(pc, pU, fr._f32(LAM)))
        checks += [check(f"{name} U", kU, pU, "bitwise"),
                   check(f"{name} costs", kc, pc, "bitwise"),
                   *merge_checks(name, kcarry, pcarry, pc, pU)]
        crashed[name] = float(kcrash.float().mean())
        times[name] = timing(lambda: fused_solve.fused_solve_carries(*args, split_cost=False,
                                                                     **kw),
                             lambda: fused_solve.fused_solve_plain(*args, **kw),
                             ar_solve_work(cost, K, kind), kind)
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
    for mode in ("costs", "costs+lr", "epilogue", "epilogue+lr", "tsallis+lr"):
        lrp = lr if mode.endswith("+lr") else None
        epilogue = mode.startswith("epilogue")
        tsallis = mode.startswith("tsallis")
        name = f"B1 {mode}"

        def kernel(lrp=lrp, epilogue=epilogue, tsallis=tsallis):
            if epilogue:
                return fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lrp,
                                                split_cost=False)
            if tsallis:
                return fr.rollout_block_minima(dyn, cost, x0, U, DT, lrp, split_cost=False)
            return fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp, split_cost=False)

        def plain(lrp=lrp, epilogue=epilogue, tsallis=tsallis):
            pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
            if tsallis:
                return fr.block_minima_plain(pc)
            return fr.block_carries_plain(pc, U, LAM) if epilogue else (pc, pcrash)

        kout = kernel()
        same_as_one_thread(f"AutoRally {name} K={K} map {map_kind}", kernel, kout, "ar_nn",
                           "rollout")
        pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
        torch.cuda.synchronize()
        same(f"{name} crash flags", kout[1], pcrash)
        checks.append(check(f"{name} costs", kout[0], pc, "bitwise"))
        if epilogue:
            same(f"{name} carry rows in write_block_carry's order", kout[2],
                 fr.block_carries_ordered(pc, U, fr._f32(LAM)))
            checks += merge_checks(name, kout[2], fr.block_carries_plain(pc, U, LAM), pc, U)
        if tsallis:
            same(f"{name} block minima", kout[2], fr.block_minima_plain(pc))
        times[name] = timing(kernel, plain, ar_rollout_work(cost, K, epilogue, lrp is not None),
                             mode, "rollout")
        if tsallis and at_path:
            # the warp form's minima pass alone (launched on its own on these
            # costs, nothing before it to overlap), its plain version and the
            # one PyTorch call of the same function at this K (a multiple of
            # 64), all by device time
            t = {"ms": device_ms(lambda pc=pc: fr._block_minima(pc), MIN_PASS),
                 "plain_ms": device_ms(lambda pc=pc: fr.block_minima_plain(pc)),
                 "library_ms": device_ms(lambda pc=pc: pc.view(-1, fr.BLOCK).amin(1))}
            t["bound_ms"], t["bound_by"] = bound_ms(*min_pass_work(K))
            times[MIN_PASS] = t
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
    ix, iy, iyaw = cost.output_indices[:3]
    cos_y, sin_y = torch.cos(y[iyaw]), torch.sin(y[iyaw])
    thr = cost.boundary_threshold
    d = torch.minimum(
        (cost._track_value(y[ix] + 0.5 * cos_y, y[iy] + 0.5 * sin_y) - thr).abs(),
        (cost._track_value(y[ix] - 0.5 * cos_y, y[iy] - 0.5 * sin_y) - thr).abs())
    return d.reshape(len(samples), -1).amin(dim=1)


def ar_reference_phase(dev):
    """The AutoRally configuration on the 128^2 map: ``model_reference_phase``."""
    model_reference_phase("autorally_reference", lambda k, **kw: build_autorally("128", k, **kw),
                          ar_x0(dev), K_AR, T_AR, 41, map="128")


def model_reference_phase(phase, build, x, K_, T_, seed, cost_tol="costs", **labels):
    """One full-width solve of a configuration (``build(kernel)``) on
    kernel="fused_solve" and on kernel="fused" against kernel="combined" on
    the same normals, each of the two under set_sync_debug_mode("error")
    after a warm solve.

    The eager network sums with a matmul and the kernels left to right, so
    the costs sit an ulp or so apart (about 1e-3 at J = 1e4, where every
    sample has crashed). A cost or crash flag may differ beyond the costs'
    tolerance only for a sample whose map value comes within 1e-4 of the
    crash threshold on the way (the distance is printed) and whose weight
    is below 1e-6; the mean's tolerance follows from the other costs: a
    weight moves by at most 2 max|dJ| / lambda relative, so the mean by that
    times max|U_k - mean|. ``cost_tol`` names the costs' tolerance in TOL."""
    dev = x.device
    g = torch.Generator(device=dev).manual_seed(seed)
    eps = torch.randn((K_, T_, C), generator=g, device=dev)
    combined = build("combined", return_samples=True)
    state = combined.init_state(seed=0).replace(
        control_mean=0.1 * torch.randn((T_, C), generator=g, device=dev))
    rc, _ = combined.solve(x, state, injected_noise=eps)
    U = rc.sampled_controls
    w_c = torch.exp(-(rc.costs - rc.baseline) / LAM)
    checks, odd_samples = [], {}
    for kernel in ("fused_solve", "fused"):
        ctrl = build(kernel)
        ctrl.solve(x, state, injected_noise=eps)  # one-time copies
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rf, _ = ctrl.solve(x, state, injected_noise=eps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rtol, atol = TOL[cost_tol]
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
                            cost_tol))
        spread = float((U - rc.control_mean).abs().max())
        mean_atol = 2 * float(dJ[ok].max()) / LAM * spread + 1e-5
        for field, tol in (("control_mean", mean_atol), ("state_trajectory",
                                                         T_ * DT * mean_atol + 1e-5)):
            got, want = getattr(rf, field), getattr(rc, field)
            err = float((got - want).abs().max())
            if not err <= tol:
                raise AssertionError(f"{kernel} {field} vs combined: {err} > {tol}")
            checks.append({"check": f"{kernel} {field} vs combined", "max_abs_err": err,
                           "atol": tol})
        checks.append(check(f"{kernel} baseline vs combined", rf.baseline, rc.baseline,
                            cost_tol))
    emit(phase, K=K_, T=T_, **labels, crashed_share=float(rc.crash.float().mean()),
         checks=checks, samples_off_tolerance=odd_samples,
         no_host_sync=["fused_solve", "fused"])


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
    gamma that zeros some weights; costs, crash flags, minima, rho and the
    rows to the last bit (the rows and rho also against the one-block build
    of B5), eta and the new mean at the exp epilogue's tolerances; the
    tsallis_reduce entry alone with a given device rho. At K_MAIN also the
    times (B5 A B B A against the one-block build, by CUDA events and the
    profiler), bounds and the eager weights + matmul."""
    dyn, cost, x0, U, lr = colored_inputs(dev, K, p, seed, stride)
    by_kernel = {"rollout_costs_kernel": [], "tsallis_reduce_kernel": [],
                 "flash_combine_kernel": []}
    times, zero_weights = {}, {}
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    pmin = fr.block_minima_plain(pc)
    prho = torch.amin(pmin)
    for gamma, r in ((GAMMA, R_TS), (GAMMA_SMALL, R_SMALL)):
        name = f"gamma {gamma} r {r}"
        kc, kcrash, kmin = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr, split_cost=False)
        krows, krho = fr.tsallis_block_rows(U, kc, kmin, gamma, r)
        with earlier_forms():  # the one-block build
            one_rows = fr.tsallis_block_rows(U, kc, kmin, gamma, r)
        km, _, ke = fr.flash_combine(krows, T, C, 1.0)
        _, _, fm, frho, fe = fr.fused_weighted_rollout(
            dyn, cost, x0, U, DT, LAM, lr, weight_kind="tsallis", weight_params=(gamma, r),
            split_cost=False)
        knum, keta = fr.tsallis_reduce(U, pc, prho, gamma, r)
        prows = fr.tsallis_rows_plain(U, pc, prho, fr._f32(gamma), fr._tsallis_pw(r))
        pm, _, pe, pnum = fr.flash_combine_plain(prows, T, C, 1.0, with_num=True)
        torch.cuda.synchronize()
        same(f"{name} crash flags", kcrash, pcrash)
        same(f"{name} block minima", kmin, pmin)
        same(f"{name} rho", krho, prho)
        same(f"{name} rows", krows, prows)
        same_bits(f"{name} rows and rho", (krows, krho), one_rows)
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
            times["pass1"] = {
                "ms": form_time(lambda: fr.rollout_block_minima(dyn, cost, x0, U, DT, lr,
                                                                split_cost=False),
                                "di_circle", "rollout", "tsallis+lr"),
                "plain_ms": time_ms(lambda: fr.block_minima_plain(
                    fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)[0]), N_TIMED_PLAIN)}
            times["pass1"]["bound_ms"], times["pass1"]["bound_by"] = bound_ms(
                *pass1_work(K))
            # the tiled kernel A B B A against the one-block build, by CUDA
            # events and by the profiler's device time
            b5 = lambda: fr.tsallis_block_rows(U, kc, kmin, gamma, r)  # noqa: E731
            t = abba_against(b5, earlier_forms)
            t["device"] = device_abba(b5, TSALLIS, "tsallis_reduce_kernel", earlier_forms)
            t["earlier"] = {k: t[k] for k in ("ms", "other_ms", "abba_ms", "faster", "device")}
            t["plain_ms"] = time_ms(lambda: fr.tsallis_rows_plain(U, pc, prho, g32, pw),
                                    N_TIMED_PLAIN)
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
                                                  weight_params=(gamma, r),
                                                  split_cost=False), N_TIMED)}
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
                       num_iters=1, kernel=kernel, return_samples=kernel == "combined",
                       split_cost=False)


def build_colored(transform, kernel):
    """bench.py:671-702 on the card: ColoredMPPI, normExp or Tsallis."""
    return ColoredMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                       colored_sampler(), dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T,
                       num_rollouts=K_MAIN, num_iters=1, kernel=kernel,
                       weight_transform=transform, tsallis_gamma=GAMMA, tsallis_r=R_TS,
                       return_samples=kernel == "combined", split_cost=False)


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
                return fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lrp,
                                                split_cost=False)
            if mode.startswith("tsallis"):
                return fr.rollout_block_minima(dyn, cost, x0, U, DT, lrp, split_cost=False)
            return fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp, split_cost=False)

        def plain(mode=mode, lrp=lrp):
            pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
            if mode.startswith("epilogue"):
                return fr.block_carries_plain(pc, U, LAM)
            return fr.block_minima_plain(pc) if mode.startswith("tsallis") else pc

        kout = kernel()
        same_as_one_thread(f"bicycle B1 {mode} K={K}", kernel, kout, "bicycle_ar", "rollout")
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
        t = {"ms": form_time(kernel, "bicycle_ar", "rollout", mode, timed_plain),
             "plain_ms": time_plain(plain) if timed_plain else None}
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


def ar_loop_phase(path, map_kind, kernel, steps, want, profile=2):
    """The AutoRally configuration's closed loop from x0 (v_x = 3)."""
    ctrl = build_autorally(map_kind, kernel)
    return model_loop_phase(path, ctrl, ar_x0(ctrl.device), steps, want, profile=profile,
                            map=map_kind)[0]


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
K_WAYPOINT, WAYPOINT_STEPS = 1024, 50  # no bar; 100 until cut for time
WAYPOINTS = [(1.5, 0.0, 0.0, np.pi / 2), (3.0, 0.8, 0.0, np.pi / 2), (4.5, 1.5, 0.0, np.pi / 2)]
SWINGUP_STEPS = 500
# the kernel="fused" and Tsallis loops: the entry on a main path (20 until
# B1's warp form joined the run, cut for time)
ZOO_B1_STEPS = 10
# loops without a task bar, cut for time (100 steps each until the staged
# split passes' checks joined the run; 50 until the rest of the racer family
# joined it)
CARTPOLE_ROW_STEPS = 30  # the bench row cartpole_example_K8192 on fused_solve
TSALLIS_HOVER_STEPS = 30  # the hover with Tsallis weights (pair_loops)
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
    if pair in RACER_PAIRS:
        return (*racer_parts(pair, dev), racer_x0(pair, x0dev), RACER_STD, 0.0,
                OPS_RACER[pair])
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


# ---------------------------------------------------------------------------
# The racer LSTM rows (bench.py:719-743, :791-807): the LSTM-steering model
# on the 128^2 elevation map (0.1 normal, numpy seed 1, 1 m texels) with
# ARStandardCost on the 128^2 track map, T=100; the LSTM-uncertainty model
# (three LSTMs, the 4 x 4 covariance) on flat ground with ARStandardCost
# without a costmap, T=150; both with output_indices (2, 3, 5, 6, 0, 1),
# Gaussian std [0.3, 0.5], lambda 1, dt 0.02, K=1920, x0 = 0 with v_x = 3.
# The LSTMs are random (numpy seeds 0, 1, 2 at scale 0.1, as LSTM.create),
# since the bench's come from JAX keys. Their B1 and B3 entries run through
# the zoo's kernel phase (zoo_kernel_phase, phase "racer_kernels").
# ---------------------------------------------------------------------------
K_RC, K_RC_RAGGED = 1920, 1900
RACER_PAIRS = ("racer_steering_ar", "racer_unc_ar")
T_RACER = {"racer_steering_ar": 100, "racer_unc_ar": 150}
RACER_STD = [0.3, 0.5]
RACER_INDICES = (2, 3, 5, 6, 0, 1)
# The eager re-rollout of the mean steps the models one launch per operation:
# about 41,000 launches per step for the steering row (0.9 s), several times
# that for the uncertainty row; its loop is shorter, and a profiler window
# (about 0.35 ms per recorded launch) is one step.
# cut for time from 10 and 5 when B3's warp form joined the run, the
# steering row from 6 when the passes' earlier build joined it
RACER_STEERING_LOOP_STEPS = 4
RACER_UNC_LOOP_STEPS = 2
# the racer rows' ragged kernel cases (K 1900 / 1901) run one partial chunk
# of steps: their plain versions take seconds at the paths' T (cut for time
# from T_RACER when B3's warp form joined the run)
RACER_RAGGED_T = 31
RACER_FUSED_LOOP_STEPS = 2  # the kernel="fused" loops: B1 on the path (3 until cut for time)


def lstm_ops(I, NO, H=16, N1=16):
    """Operations of one LSTM step and its head (csrc/lstm.cuh): the gates'
    4 H (H + I) multiply-adds as two operations each and two adds per gate
    row; per hidden unit three sigmoids (negation, expf, add, division), two
    tanhf and four multiplies and adds; the head's N1 (H + I) + NO N1
    multiply-adds, its bias adds and N1 tanhf."""
    return (8 * H * (H + I) + 8 * H
            + H * (3 * (3 + OPS_TRANSCENDENTAL) + 2 * OPS_TRANSCENDENTAL + 4)
            + 2 * N1 * (H + I) + N1 * (1 + OPS_TRANSCENDENTAL) + 2 * NO * N1 + NO)


# The steering model's step (csrc/racer_lstm_steering.cuh, racer_elevation.cuh)
# besides its LSTM: the steering and brake rates 13, the longitudinal rate 41
# and sinf, the yaw rate (two divisions, tanf), the kinematics (cosf, sinf,
# 2), the Euler update 12, the yaw wrap (fmodf and 4), the clamps 5; the
# settling: six sinf / cosf, the rotation 10, four corners 32, four map
# queries (54 each), four slopes 16 and their asin_approx (28 and sqrtf
# each), the averages and checks 12; the output 1.
OPS_RACER_STEER = (479 + 15 * OPS_TRANSCENDENTAL) + lstm_ops(4, 1)
# The uncertainty model's step (csrc/racer_lstm_unc.cuh) besides its three
# LSTMs: the parametric rates 52 with four transcendentals, the suspension
# 129, the quadratic brake 13, the features and corrections 7 with three
# sinf, Q 54 with five sigmoids and three more transcendentals, the
# Jacobian 43 with five, the propagation 320, the Euler update, clamps and
# output 36 with the yaw wrap's fmodf.
OPS_RACER_UNC = (654 + 21 * OPS_TRANSCENDENTAL + lstm_ops(4, 1) + lstm_ops(11, 2)
                 + lstm_ops(12, 5))
# The cost of the steering row reads the track map (OPS_AR_COST); the
# uncertainty row's has no costmap: no map queries.
OPS_RACER = {"racer_steering_ar": OPS_RACER_STEER + OPS_AR_COST,
             "racer_unc_ar": OPS_RACER_UNC + OPS_AR_COST - 2 * 54}


@functools.lru_cache(maxsize=None)
def racer_elevation_data():
    """bench.py:725-728: 0.1 normal heights, numpy seed 1, 128^2."""
    return (0.1 * np.random.default_rng(1).normal(size=(128, 128))).astype("f")


def racer_parts(pair, dev=None):
    """(dynamics, cost) of a racer row on ``dev`` (the controllers' default
    when None)."""
    kw = {} if dev is None else {"device": dev}
    if pair == "racer_unc_ar":
        return (RacerDubinsElevationLSTMUncertainty.create(seed=0, **kw),
                ARStandardCost(output_indices=RACER_INDICES, **kw))
    elev = MapTexture2D(racer_elevation_data(), origin=(-64.0, -64.0, 0.0), resolution=1.0,
                        **kw)
    data, origin, res, _ = ar_map_data("128")
    track = MapTexture2D(data, origin=origin, resolution=res, **kw)
    return (RacerDubinsElevationLSTMSteering.create(elevation_map=elev, seed=0, **kw),
            ARStandardCost(costmap=track, output_indices=RACER_INDICES, **kw))


def build_racer(pair, kernel, return_samples=False):
    """A racer bench row's VanillaMPPI on the card, on the combined kernels
    (the split form has loops of its own)."""
    dyn, cost = racer_parts(pair)
    return VanillaMPPI(dyn, cost, GaussianDistribution.create(std_dev=RACER_STD), dt=DT,
                       lam=LAM, alpha=ALPHA, num_timesteps=T_RACER[pair], num_rollouts=K_RC,
                       num_iters=1, kernel=kernel, return_samples=return_samples,
                       split_cost=False)


def racer_x0(pair, dev):
    x0 = torch.zeros(9 if pair == "racer_steering_ar" else 26, device=dev)
    x0[0] = 3.0
    return x0


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
    """A zoo or racer pair's B1 entry in its four modes (costs, costs + LR,
    the exp epilogue + LR, Tsallis pass 1 + LR), its B3 entry (Gaussian; the
    cartpole and the racer pairs also NLN) and, for the cartpole, its B4
    entry (Gaussian, NLN, Smooth-MPPI, Smooth-MPPI with its epilogue), each
    against its plain
    version: U, costs, crash flags and block minima to the last bit, carries
    at rtol 1e-5, merged means at rtol 1e-4 / atol 1e-5. Times by CUDA
    events against the bound from the .cuh operation counts; the plain
    versions' times where ``timed_plain`` (the epilogue mode, B3 Gaussian,
    B4 Smooth with its epilogue), the library yardstick softmax(-J / lambda)
    @ U beside the epilogue."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn, cost, x0, std, offset, ops = zoo_parts(pair, dev)
    C_, T_ = dyn.CONTROL_DIM, case_T(pair, K, T_RACER.get(pair, T_ZOO))
    mean = 0.3 * torch.randn((T_, C_), generator=g, device=dev)
    mean[:, -1] += offset
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    by_kernel = {"rollout_costs_kernel": [], "fused_solve_kernel": [],
                 "fused_sample_rollout_kernel": [], "flash_combine_kernel": []}
    times, crashed = {}, {}

    def timing(kernel, plain, work, with_plain, form=None, run_ms=None):
        # form: (kind, mode) of a B3 or B1 launch, A B B A at the path's shape;
        # run_ms: the check's own run of the plain version, timed, which a
        # racer row's plain time is (time_plain would repeat that one run)
        t = {"ms": (form_time(kernel, pair, *form, timed_plain) if form
                    else time_ms(kernel, N_TIMED)),
             "plain_ms": ((run_ms if pair in RACER_PAIRS else time_plain(plain, pair))
                          if with_plain else None)}
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
    plain_costs = {}
    for mode in ("costs", "costs+lr", "epilogue+lr", "tsallis+lr"):
        lrp = lr if mode.endswith("+lr") else None

        def kernel(mode=mode, lrp=lrp):
            if mode.startswith("epilogue"):
                return fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lrp,
                                                split_cost=False)
            if mode.startswith("tsallis"):
                return fr.rollout_block_minima(dyn, cost, x0, U, DT, lrp, split_cost=False)
            return fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp, split_cost=False)

        def plain(mode=mode, lrp=lrp):
            pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
            if mode.startswith("epilogue"):
                return fr.block_carries_plain(pc, U, LAM)
            return fr.block_minima_plain(pc) if mode.startswith("tsallis") else pc

        kout = kernel()
        same_as_one_thread(f"{pair} B1 {mode} K={K}", kernel, kout, pair, "rollout")
        # the three "+lr" modes share one plain rollout
        with_lr = lrp is not None
        if with_lr not in plain_costs:
            plain_costs[with_lr] = plain_timed(
                lambda lrp=lrp: fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp))
        (pc, pcrash), run_ms = plain_costs[with_lr]
        name = f"B1 {mode}"
        same(f"{pair} {name} crash flags", kout[1], pcrash)
        by_kernel["rollout_costs_kernel"].append(check(f"{pair} {name} costs", kout[0], pc,
                                                       "bitwise"))
        if mode.startswith("epilogue"):
            if pair in WARP_PAIRS:  # the warp form's carry pass
                same(f"{pair} {name} carry rows in write_block_carry's order", kout[2],
                     fr.block_carries_ordered(pc, U, fr._f32(LAM)))
            merged, carry = merge_checks(f"{pair} {name}", kout[2],
                                         fr.block_carries_plain(pc, U, LAM), pc, U)
            by_kernel["rollout_costs_kernel"].append(carry)
            by_kernel["flash_combine_kernel"] += merged
        if mode.startswith("tsallis"):
            same(f"{pair} {name} block minima", kout[2], fr.block_minima_plain(pc))
        times[name] = timing(kernel, plain, zoo_rollout_work(dyn, cost, ops, K, T_, mode),
                             timed_plain and mode == "epilogue+lr", ("rollout", mode), run_ms)
        if mode == "epilogue+lr":
            # one-call yardstick for the weighting + weighted sum (not used by the port)
            times[name]["library_ms"] = time_ms(
                lambda: torch.softmax(-pc / LAM, 0) @ U.view(K, -1), N_TIMED)
        crashed[name] = float(kout[1].float().mean())
    # B3 (and the cartpole's B4)
    nln = pair == "cartpole" or pair in RACER_PAIRS
    for kind in ("gaussian", "nln") if nln else ("gaussian",):
        s = zoo_sampler(kind, C_, std, dev, p)
        args = (dyn, cost, s, x0, mean, seed_t, DT, LAM, ALPHA, K)
        kw = dict(optimization_stride=stride)
        kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, split_cost=False,
                                                                 **kw)
        same_as_one_thread(f"{pair} B3 {kind} K={K}", lambda args=args: (
            fused_solve.fused_solve_carries(*args, split_cost=False, **kw)),
            (kc, kcrash, kU, kcarry), pair, "solve")
        (pc, pcrash, pU, pcarry), run_ms = plain_timed(
            lambda args=args: fused_solve.fused_solve_plain(*args, **kw))
        name = f"B3 {kind}"
        same(f"{pair} {name} crash flags", kcrash, pcrash)
        if pair in WARP_PAIRS:  # the warp form's carry pass
            same(f"{pair} {name} carry rows in write_block_carry's order", kcarry,
                 fr.block_carries_ordered(pc, pU, fr._f32(LAM)))
        merged, carry = merge_checks(f"{pair} {name}", kcarry, pcarry, pc, pU)
        by_kernel["fused_solve_kernel"] += [
            check(f"{pair} {name} U", kU, pU, "bitwise"),
            check(f"{pair} {name} costs", kc, pc, "bitwise"), carry]
        by_kernel["flash_combine_kernel"] += merged
        crashed[name] = float(kcrash.float().mean())
        times[name] = timing(lambda: fused_solve.fused_solve_carries(*args, split_cost=False,
                                                                     **kw),
                             lambda: fused_solve.fused_solve_plain(*args, **kw),
                             zoo_sampling_work(dyn, cost, ops, K, T_, kind, True),
                             timed_plain and kind == "gaussian", ("solve", kind), run_ms)
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
    emit("racer_kernels" if pair in RACER_PAIRS else "zoo_kernels", pair=pair, K=K, T=T_,
         pure_noise_percentage=p, stride=stride,
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
    kc, kcrash = fr.fused_rollout_costs(ctrl.dynamics, ctrl.cost, x, U, DT, lr,
                                        split_cost=False)
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
                     on_step=None, profile=2, initial_mean=None, **labels):
    """``steps`` closed-loop steps of a model's configuration (AutoRally, the
    bicycle, the zoo) from ``x0`` through the entry points: slide, solve,
    step the plant with the first control (``slide_first=False``: solve,
    plant, slide, as tests/test_vanilla_mppi.py:80-107); then a profiler
    window of ``profile`` steps (after one warm-up step when more than one;
    none with 0 or False). Records the crashed share and the final state;
    the task bars are the callers'. ``plant(x, u)`` replaces the model's
    step; ``on_step(i, x, ctrl)`` may return a new cost (the waypoint
    updates). Fails unless the kernels launched as ``want`` says and every
    state is finite. Returns (launches, entry launches, the states
    (steps, S), the last result)."""
    if ctrl.device.type != "cuda":
        raise AssertionError("the controller did not default to the card")
    STEPS_BY_PATH[path] = steps
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
    # the first solves include one-time allocations (a short loop: its last)
    steady = ev[min(5, steps - 1):]
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

        profile_steps(path, step, n=profile, warmup=1 if profile > 1 else 0)
    return launches, entries, X, res


def build_zoo(pair, kernel, K=K_ZOO, T_=T_ZOO, sampler=None, **kw):
    """A zoo pair's VanillaMPPI on the card; the Gaussian of the pair's std
    by default (the quadrotor's without a control cost, as
    tests/test_model_zoo.py:60-92 and the waypoint example)."""
    dyn, cost, _, std, _, _ = zoo_parts(pair)
    if sampler is None:
        coeff = [0.0] * dyn.CONTROL_DIM if pair.startswith("quadrotor") else None
        sampler = GaussianDistribution.create(std_dev=std, control_cost_coeff=coeff)
    kw.setdefault("split_cost", False)  # the split form has loops of its own
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
    solve_want = lambda pair, k=n: solve_launches(pair, k)
    b1_want = lambda pair, k=n_b1: rollout_launches(pair, k)
    paths = {}

    def run(path, *a, **kw):
        out = model_loop_phase(path, *a, **kw)
        paths[path] = out[:2]
        return out

    # the bench row cartpole_example_K8192 from x0 = 0
    run("cartpole_fused_solve", build_cartpole("fused_solve"), torch.zeros(4, device=dev),
        CARTPOLE_ROW_STEPS, solve_want("cartpole", CARTPOLE_ROW_STEPS))
    # tests/test_vanilla_mppi.py:80-107 at K=8192 on the fused solve: dt 0.01,
    # lambda 0.25, std 5, control cost 1, 1 % pure noise, slide_scale 1;
    # solve, plant x + state_deriv dt, slide; its bar
    swing = VanillaMPPI(CartpoleDynamics.create(), CartpoleQuadraticCost(coeffs=CART_COEFFS),
                        GaussianDistribution.create(std_dev=CART_STD, control_cost_coeff=[1.0],
                                                    pure_noise_percentage=0.01),
                        dt=0.01, lam=0.25, alpha=0.0, slide_scale=[1.0], num_timesteps=T_ZOO,
                        num_rollouts=K_ZOO, num_iters=1, kernel="fused_solve",
                        split_cost=False)
    ns = SWINGUP_STEPS
    _, _, X, res = run(
        "cartpole_swingup", swing, torch.zeros(4, device=dev), ns, solve_want("cartpole", ns),
        plant=lambda x, u: x + swing.dynamics.state_deriv(x, u) * swing.dt,
        slide_first=False, profile=False)
    theta_err = abs(float(torch.remainder(X[-1, 2], 2 * np.pi)) - np.pi)
    emit("cartpole_swingup_bar", final_baseline=float(res.baseline), theta_error=theta_err,
         final_state=X[-1].tolist(), bar={"baseline": 1.0, "theta_error": 0.3})
    if not (float(res.baseline) < 1.0 and theta_err < 0.3):
        raise AssertionError(f"cartpole swing-up missed its bar: baseline "
                             f"{float(res.baseline)}, pole angle error {theta_err}")
    # the B1 and B4 entries on short main paths
    run("cartpole_fused", build_cartpole("fused"), torch.zeros(4, device=dev), n_b1,
        b1_want("cartpole"), profile=False)
    run("cartpole_tsallis", build_cartpole("fused_solve", weight_transform="tsallis"),
        torch.zeros(4, device=dev), n_b1, {split_name("cartpole", "sample"): n_b1},
        profile=False)
    # tests/test_model_zoo.py:60-92: the hover from (1, 0, -0.5), hover
    # thrust as the initial mean, K=512, T=48, 150 steps; its bar
    hover_mean = torch.tensor([0.0, 0.0, 0.0, HOVER_THRUST], device=dev).expand(T_HOVER, 4)
    x0 = zoo_parts("quadrotor_quadratic", dev)[2]
    nh = HOVER_STEPS
    _, _, X, _ = run("quadrotor_hover", build_zoo("quadrotor_quadratic", "fused_solve",
                                                     K=K_HOVER, T_=T_HOVER), x0, nh,
                        solve_want("quadrotor_quadratic", nh), initial_mean=hover_mean)
    pos_err = float(torch.linalg.vector_norm(X[-1, :3]))
    emit("quadrotor_hover_bar", position_error=pos_err, final_state=X[-1].tolist(),
         bar={"position_error": 0.5})
    if not pos_err < 0.5:
        raise AssertionError(f"quadrotor hover missed its bar: position error {pos_err}")
    run("quadrotor_fused", build_zoo("quadrotor_quadratic", "fused", K=K_HOVER, T_=T_HOVER),
        x0, n_b1, b1_want("quadrotor_quadratic"), initial_mean=hover_mean, profile=False)
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
        solve_want("quadrotor_map", WAYPOINT_STEPS), initial_mean=hover_mean, on_step=advance,
        profile=False)
    run("quadrotor_waypoint_fused", build_zoo("quadrotor_map", "fused", K=K_WAYPOINT,
                                              T_=T_HOVER), qz, n_b1,
        b1_want("quadrotor_map"), initial_mean=hover_mean, profile=False)
    # the Dubins car to a goal trajectory (the gather by t) and to a fixed goal
    dub = torch.tensor([0.0, 0.0, 3.0], device=dev)
    run("dubins_fused_solve", build_zoo("dubins_trajectory", "fused_solve"), dub, n_b1,
        solve_want("dubins_quadratic", n_b1), profile=False)
    run("dubins_fused", build_zoo("dubins_quadratic", "fused"), dub, n_b1,
        b1_want("dubins_quadratic"), profile=False)
    # examples/double_integrator_example.py: T=65, K=128, dt 0.015, lambda 1,
    # alpha 1, start (-9, -9, 0.1, 0.1); its colored sampler on kernel="fused"
    # (the colored draw is eager, JAX draws it in XLA on pallas_fused too), and
    # a Gaussian of the same std on the fused solve
    ex = dict(K=128, T_=65, dt=0.015, lam=1.0, alpha=1.0)
    dix = torch.tensor([-9.0, -9.0, 0.1, 0.1], device=dev)
    run("di_quadratic", build_zoo("di_quadratic", "fused", sampler=ColoredNoiseDistribution.create(
        std_dev=[0.5, 0.5], exponents=[1.0, 1.0]), **ex), dix, n, b1_want("di_quadratic", n))
    run("di_quadratic_fused_solve", build_zoo("di_quadratic", "fused_solve", **ex), dix, n,
        solve_want("di_quadratic"))
    return paths


def racer_reference_phase(dev):
    """Each racer row at full width on kernel="fused_solve" and "fused"
    against "combined" (``model_reference_phase``): the eager LSTMs and head
    sum with matmuls over T recurrent steps, the kernels left to right, so
    the costs are held at rtol 1e-4 / atol 1e-5 and the mean's tolerance
    follows from the measured cost differences."""
    for i, pair in enumerate(RACER_PAIRS):
        model_reference_phase("racer_reference",
                              lambda k, pair=pair, **kw: build_racer(pair, k, **kw),
                              racer_x0(pair, dev), K_RC, T_RACER[pair], 91 + i,
                              cost_tol="solve", pair=pair)


def racer_loops(dev):
    """The racer bench rows' closed loops on the fused solve (the steering
    row RACER_STEERING_LOOP_STEPS, the uncertainty row RACER_UNC_LOOP_STEPS: its eager
    re-rollout of the mean steps three LSTMs 150 times, about 10^5 launches)
    and short loops on kernel="fused" (B1 on the path). Returns {path:
    (launches, entry launches)}."""
    paths = {}
    for pair in RACER_PAIRS:
        kind = pair.split("_")[1]
        n = RACER_STEERING_LOOP_STEPS if kind == "steering" else RACER_UNC_LOOP_STEPS
        # a profile window of the steering row only: the uncertainty row's
        # 1.3e5 launches a step take about a minute to trace and parse
        out = model_loop_phase(f"racer_{kind}", build_racer(pair, "fused_solve"),
                               racer_x0(pair, dev), n, solve_launches(pair, n),
                               profile=kind == "steering" and 1, pair=pair)
        paths[f"racer_{kind}"] = out[:2]
        n = RACER_FUSED_LOOP_STEPS
        out = model_loop_phase(f"racer_{kind}_fused", build_racer(pair, "fused"),
                               racer_x0(pair, dev), n, rollout_launches(pair, n),
                               profile=False, pair=pair)
        paths[f"racer_{kind}_fused"] = out[:2]
    return paths


def bench_row_loops(dev):
    """Two bench rows that need no new kernel code: the bicycle on the
    1024^2 map (bench.py:755-773, BICYCLE_LOOP_STEPS) and the DI row at
    K=1024 (:593-597)."""
    n = BICYCLE_LOOP_STEPS
    data = np.abs(np.random.default_rng(2).normal(size=(1024, 1024))).astype("f")
    tex = MapTexture2D(data, origin=(-51.2, -51.2, 0.0), resolution=0.1)
    bicycle = VanillaMPPI(BicycleSlipDynamics.create(),
                          ARStandardCost(costmap=tex, output_indices=BI_OUTPUT_INDICES),
                          colored_sampler(None, 0.0, BI_STD, BI_EXPONENTS), dt=DT, lam=LAM,
                          alpha=ALPHA, num_timesteps=T_BI, num_rollouts=K_BI, num_iters=1,
                          kernel="fused", split_cost=False)
    # the same launches as "bicycle_colored": no profiler window of its own
    paths = {"bicycle_1024": model_loop_phase(
        "bicycle_1024", bicycle, torch.zeros(S_BI, device=dev), n,
        {b1_kernel("bicycle_ar"): n, MERGE: n}, profile=False,
        map="1024")[0]}
    n = CLOSED_LOOP_STEPS
    di = VanillaMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                     make_sampler("gaussian"), dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T,
                     num_rollouts=1024, num_iters=1, kernel="fused_solve")
    launches, _, X, _ = model_loop_phase(
        "di_K1024", di, torch.tensor(X0, device=dev), n,
        {b3_kernel("di_circle"): n, MERGE: n})
    band_check("di_K1024", X)
    paths["di_K1024"] = launches
    return paths


# ---------------------------------------------------------------------------
# The robust family beyond the double integrator: B8 and B7 with staged
# models (AutoRally's network, the cartpole), B6 at (4, 1) and (7, 2), B1's
# per-sample-x0 entries; RMPPI and Tube-MPPI on AutoRally with DDP feedback
# at the AutoRally instantiation's width (instantiations/__init__.py:56-67:
# K=1920, T=150; RMPPI 9 x 256 samples in stage 1), the JAX suite's RMPPI
# loop on DoubleIntegratorRobustCost (tests/test_tube_robust.py:38-57,
# :181-199) and the per-robot factories.
# ---------------------------------------------------------------------------
N_CAND_AR, S_PER_AR = 9, 256
ROBUST_AR_STEPS = 6  # 10 until the passes' earlier build joined the run, cut for time
K_RDI, T_RDI, S_PER_RDI, THRESH_RDI, ROBUST_DI_STEPS = 256, 48, 64, 50.0, 60
X0_RDI = [2.0, 0.0, 0.0, 2.0]
INSTANTIATION_SOLVES = 3
# The partly-crashing map of the robust kernel phase: 0.15 |z| (numpy seed
# 11) on 256^2 texels of 0.1 m from (-12.8, -12.8), every texel from x =
# 10.35 m on at 3. With the network at scale 0.2 (numpy seed 0; the bench's
# 0.1 keeps the samples within millimetres) the samples spread over about
# 0.35 m in 3 s and part of them reach the block (the phase records the
# crashed share of each case).
PARTIAL_NET_SCALE, PARTIAL_BLOCK_COL = 0.2, 231
# operations per sample-step: the DI robust cost (csrc/
# double_integrator_robust_cost.cuh: the radius, speed and momentum 9 and
# sqrtf, the center and width 4, d 2, the barrier 3, |d| > 1 2, the tracking
# terms 6); the AutoRally derivative alone (the step without its Euler update
# and yaw wrap); the cartpole's derivative
OPS_DI_ROBUST_COST = 26
OPS_AR_DERIV = 2 * FNN_MACS + 68 + 64 * OPS_TRANSCENDENTAL + 2 * OPS_TRANSCENDENTAL + 7
OPS_CART_DERIV = 24 + 2 * OPS_TRANSCENDENTAL


def rmppi_ops(S_, C_, step, cost):
    """The RMPPI kernel per sample-step: two steps and two costs, two clamps
    of C channels (5 each), the feedback K (x_r - x_n) (S + C (2S - 1)), its
    cost (5 per channel + 1), u_raw + u_fb, three accumulations."""
    return 2 * step + 2 * cost + 2 * 5 * C_ + S_ + C_ * (2 * S_ - 1) + 5 * C_ + 1 + C_ + 4


def partial_map(dev="cpu"):
    data = (0.15 * np.abs(np.random.default_rng(11).normal(size=(256, 256)))).astype("f")
    data[:, PARTIAL_BLOCK_COL:] = 3.0
    return MapTexture2D(data, origin=(-12.8, -12.8, 0.0), resolution=0.1, device=dev)


def robust_ar_parts(map_kind, dev="cpu", robust=True):
    """AutoRally with ARRobustCost (ARStandardCost unless ``robust``): the
    bench network (scale 0.1) on the bench's map, or the network at scale
    0.2 on the partly-crashing map."""
    if map_kind == "partial":
        dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=PARTIAL_NET_SCALE),
                                  device=dev)
        tex = partial_map(dev)
    else:
        dyn = AutorallyNNDynamics.create(seed=0, device=dev)
        data, origin, res, channel_major = ar_map_data(map_kind)
        tex = MapTexture2D(data, origin=origin, resolution=res, channel_major=channel_major,
                           device=dev)
    return dyn, (ARRobustCost if robust else ARStandardCost)(costmap=tex, device=dev)


def build_rmppi_ar(kernel, split_cost=False):
    """RMPPI on AutoRally: the bench network, ARRobustCost on the 128^2 map,
    Gaussian std [0.3, 0.5], DDP feedback (Q, R, Q_f the identity), dt 0.02,
    lambda 1, alpha 0, K=1920, T=150, 9 x 256, the JAX default threshold."""
    dyn, cost = robust_ar_parts("128")
    return RobustMPPI(dyn, cost, ar_sampler("gaussian"), feedback=DDPFeedback.create(dyn, DT),
                      dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T_AR, num_rollouts=K_AR,
                      num_candidates=N_CAND_AR, samples_per_condition=S_PER_AR,
                      kernel=kernel, split_cost=split_cost)


def build_tube_ar(kernel):
    """Tube-MPPI on AutoRally: the same model, ARStandardCost on the same
    map, sampler and feedback, the JAX default nominal threshold (100)."""
    dyn, cost = robust_ar_parts("128", robust=False)
    return TubeMPPI(dyn, cost, ar_sampler("gaussian"), feedback=DDPFeedback.create(dyn, DT),
                    dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T_AR, num_rollouts=K_AR,
                    kernel=kernel, split_cost=False)


def build_rmppi_di_robust(kernel, split_cost=False):
    """The JAX suite's RMPPI controller (tests/test_tube_robust.py:38-57):
    DoubleIntegratorRobustCost, std [1, 1], coefficients 0.01, dt 0.02,
    lambda 1, K=256, T=48, 9 x 64, threshold 50."""
    dyn = DoubleIntegratorDynamics.create()
    return RobustMPPI(dyn, DoubleIntegratorRobustCost(),
                      GaussianDistribution.create(std_dev=[1.0, 1.0],
                                                  control_cost_coeff=[0.01, 0.01]),
                      feedback=DDPFeedback.create(dyn, DT), dt=DT, lam=1.0, alpha=0.0,
                      num_timesteps=T_RDI, num_rollouts=K_RDI, num_candidates=9,
                      samples_per_condition=S_PER_RDI, value_function_threshold=THRESH_RDI,
                      kernel=kernel, split_cost=split_cost)


def ladder_problem(dyn, x0, T_, seed, u_offset=None):
    """ilqr_tracking's first iteration of a model: u_init from a seed (plus
    ``u_offset`` per channel where given), xs rolled from x0, a noisy goal,
    Q, R and Q_f the identity (DDPFeedback's defaults). Returns the
    ladder's arguments."""
    dev = x0.device
    g = torch.Generator(device=dev).manual_seed(seed)
    S_, C_ = dyn.STATE_DIM, dyn.CONTROL_DIM
    lo = torch.nan_to_num(dyn.control_ranges[:, 0], neginf=-1e30).contiguous()
    hi = torch.nan_to_num(dyn.control_ranges[:, 1], posinf=1e30).contiguous()
    us = 0.3 * torch.randn((T_, C_), generator=g, device=dev)
    if u_offset is not None:
        us = us + torch.tensor(u_offset, device=dev)
    us = torch.clamp(us, lo, hi)
    xs = [x0]
    for t in range(T_ - 1):
        xs.append(xs[-1] + dyn.state_deriv(xs[-1], us[t]) * DT)
    xs = torch.stack(xs)
    goal_x = xs + 0.05 * torch.randn((T_, S_), generator=g, device=dev)
    goal_u = torch.zeros((T_, C_), device=dev)
    fb = DDPFeedback.create(dyn, DT)
    lin = linearize(dyn, xs, us, goal_x, goal_u, fb.Q, fb.R, fb.Q_f, DT)
    return (dyn, xs, us, *lin[:4], fb.Q, fb.R, fb.Q_f, lin[4], lin[5], goal_x, goal_u,
            _alpha_ladder(N_ALPHA, device=dev), lo, hi, DT)


def ladder_plain(args):
    dyn, xs, us, As, Bs, dLx, dLu, Q, R, Qf, Vxx_T, Vx_T, goal_x, goal_u, alphas, lo, hi, dt = args
    Ks, ks = riccati.riccati_backward_plain(As, Bs, dLx, dLu, Q * dt, R * dt, Vxx_T, Vx_T,
                                            dt, 1e-6)
    return (Ks, ks) + riccati.ladder_forward_plain(dyn, xs, us, Ks, ks, goal_x, goal_u, Q,
                                                   R, Qf, alphas, torch.stack([lo, hi]), dt)


def ladder_work(args, deriv_ops, n_params):
    """(bytes, operations) of B7: the linearisation, the reference and goal
    trajectories, the weights, limits, alphas and the model's table read
    once; the gains, costs and candidate trajectories written once."""
    dyn, xs = args[0], args[1]
    T_, S_ = xs.shape
    C_ = dyn.CONTROL_DIM
    n_in = (T_ * (S_ * S_ + S_ * C_ + S_ + C_) + 3 * S_ * S_ + 2 * C_ * C_ + S_
            + 2 * T_ * (S_ + C_) + 2 * C_ + N_ALPHA + n_params)
    n_out = T_ * C_ * S_ + T_ * C_ + N_ALPHA * (1 + T_ * (S_ + C_))
    return 4 * (n_in + n_out), riccati_ops(T_, S_, C_, N_ALPHA, deriv_ops)


def robust_kernel_phase(dev):
    """B8 for AutoRally (the bench's 128^2 map and the partly-crashing map,
    K=1920, T=150, the DDP gains of the configuration) and for the DI robust
    cost (K=2560 / 2500, T=50, the rmppi_di_robust loop's K=256 / 250,
    T=48, and 250 x 31; its staged form also against the one-thread build,
    A B B A at the loop's shape); B1's per-sample-x0 entries for AutoRally (both maps) and the DI
    robust cost at 9 x 256 (T=150, 50), the latter also at the loop's 9 x 64
    (T=48), and for the bicycle on the 128^2 map (T=100); B7 for AutoRally
    (T=150), the cartpole (T=100) and the DI at the loop's T=48, 14 alphas;
    B6 on those linearisations ((7, 2), (4, 1), (4, 2)) and on AutoRally's
    at T = 1024, also A B B A against its one-thread build. Each against its plain version on the same inputs:
    AutoRally's B8 and B1 to the last bit, the rest at TOL "exact". Times by
    CUDA events with their bounds; the plain versions' after one warm-up
    run, and not on the partly-crashing map (seconds per call)."""
    g = torch.Generator(device=dev).manual_seed(61)
    checks = {k: [] for k in ("rmppi_rollout_kernel", "rollout_costs_kernel",
                              "riccati_ladder_kernel", "riccati_backward_kernel")}
    times, crashed = {}, {}

    def timing(name, kernel, plain, work):
        timed_plain = "partial" not in name
        t = {"ms": time_ms(kernel, N_TIMED),
             "plain_ms": time_plain(plain) if timed_plain else None}
        t["bound_ms"], t["bound_by"] = bound_ms(*work)
        times[name] = t

    def rmppi_case(name, args, tol, work, staged=None):
        kout = fr.fused_rmppi_rollout(*args)
        pout = fr.rmppi_rollout_plain(*args)
        torch.cuda.synchronize()
        checks["rmppi_rollout_kernel"].extend(
            check(f"{name} {n}", a, b, tol)
            for n, a, b in zip(("s_nom", "j_real", "s_fb", "U_real"),
                               (*kout[:3], kout[4]), (*pout[:3], pout[4])))
        same(f"{name} crash flags", kout[3], pout[3])
        crashed[name] = float(kout[3].float().mean())
        fn = lambda: fr.fused_rmppi_rollout(*args)
        if staged is not None:  # (mode) of a staged entry: the one-thread build's bits
            same_as_one_thread_b8(name, args, kout)
            if staged:  # the loop's shape: A B B A in place of the single timing
                t = b8_form_time("di_robust", staged, fn)
                t["plain_ms"] = time_plain(lambda: fr.rmppi_rollout_plain(*args))
                t["bound_ms"], t["bound_by"] = bound_ms(*work)
                times[name] = t
                return
        timing(name, fn, lambda: fr.rmppi_rollout_plain(*args), work)

    def x0_case(name, dyn, cost, x0s, U, tol, work, pair=None, at_path=False):
        # pair: a network pair, whose warp form is also held against the
        # one-thread build (and at_path timed A B B A against it)
        fn = lambda: fr.fused_rollout_costs(dyn, cost, x0s, U, DT, split_cost=False)  # noqa: E731
        kc, kcrash = fn()
        if pair is not None:
            same_as_one_thread(name, fn, (kc, kcrash), pair, "rollout_x0")
        pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0s, U, DT)
        torch.cuda.synchronize()
        checks["rollout_costs_kernel"].append(check(f"{name} costs", kc, pc, tol))
        same(f"{name} crash flags", kcrash, pcrash)
        crashed[name] = float(kcrash.float().mean())
        plain = lambda: fr.rollout_costs_plain(dyn, cost, x0s, U, DT)  # noqa: E731
        if not at_path:
            timing(name, fn, plain, work)
            return
        t = {"ms": form_time(fn, pair, "rollout_x0", "costs"), "plain_ms": time_plain(plain)}
        t["bound_ms"], t["bound_by"] = bound_ms(*work)
        times[name] = t

    def candidates(x0, delta, s_per=S_PER_AR):
        """9 candidates on a segment from x0, each repeated for ``s_per`` samples."""
        w = torch.linspace(0.0, 1.0, N_CAND_AR, device=dev)[:, None]
        cand = x0 + w * torch.tensor(delta, device=dev)
        return cand.repeat_interleave(s_per, dim=0).contiguous()

    samp = ar_sampler("gaussian", dev)
    K_x0 = N_CAND_AR * S_PER_AR
    for map_kind in ("128", "partial"):
        dyn, cost = robust_ar_parts(map_kind, dev)
        fixed = ar_fixed_bytes(cost)
        x_nom = ar_x0(dev)
        x_real = x_nom + torch.tensor([0.0, 0.04, 0.02, 0.0, 0.0, 0.02, 0.01], device=dev)
        mean = 0.2 * torch.randn((T_AR, C), generator=g, device=dev)
        # the gains of the configuration: DDP tracking the mean's trajectory
        traj = rollout_single(dyn, x_nom, mean, DT)[0][:-1]
        gains = DDPFeedback.create(dyn, DT).compute_feedback(x_real, traj, mean).gains
        U, _ = samp.sample(g, mean, K_AR)
        args = (dyn, cost, x_nom, x_real, U, gains, samp._sigma(T_AR, 0),
                samp.control_cost_coeff, DT, LAM, ALPHA)
        n_bytes = fixed + 4 * (2 * K_AR * T_AR * C + 4 * K_AR + T_AR * C * (S_AR + 1)
                               + 5 * C + 2 * S_AR)
        rmppi_case(f"B8 ar_nn {map_kind}", args, "bitwise",
                   (n_bytes, K_AR * T_AR * rmppi_ops(S_AR, C, OPS_AR_STEP, OPS_AR_COST)
                    + 3 * K_AR))
        x0s = candidates(x_nom, [0.1, 0.05, 0.02, 0.0, 0.1, 0.0, 0.0])
        Ux = dyn.enforce_constraints(None, samp.sample(g, mean, K_x0)[0].permute(2, 0, 1))
        Ux = Ux.permute(1, 2, 0).contiguous()
        x0_case(f"B1-x0 ar_nn {map_kind}", dyn, cost, x0s, Ux, "bitwise",
                (fixed + 4 * (K_x0 * T_AR * C + K_x0 * S_AR + 2 * K_x0),
                 K_x0 * T_AR * (OPS_AR_STEP + OPS_AR_COST + OPS_ACC) + 2 * K_x0),
                "ar_nn", map_kind == "128")
    # the bicycle's per-sample-x0 entry on the 128^2 map, T=100
    bdyn, bcost = bicycle_parts(dev)
    bmean = 0.2 * torch.randn((T_BI, C), generator=g, device=dev)
    Ub = bdyn.enforce_constraints(None, samp.sample(g, bmean, K_x0)[0].permute(2, 0, 1))
    Ub = Ub.permute(1, 2, 0).contiguous()
    x0s = candidates(torch.zeros(S_BI, device=dev), [0.1, 0.05, 0.02] + [0.0] * (S_BI - 3))
    x0_case("B1-x0 bicycle_ar 128", bdyn, bcost, x0s, Ub, "bitwise",
            (4 * (bcost.params.numel() + bcost.costmap.data.numel() + bdyn.params.numel()
                  + K_x0 * T_BI * C + K_x0 * S_BI + 2 * K_x0),
             K_x0 * T_BI * (OPS_BI_STEP + OPS_AR_COST + OPS_ACC) + 2 * K_x0))
    # the DI robust cost: B8 at the bench's RMPPI width (2560 / 2500 x 50), at
    # the rmppi_di_robust loop's (256 x 48, A B B A against the one-thread
    # build; a ragged 250) and at a ragged T (250 x 31); B1-x0 at 9 x 256 x 50
    # and at the loop's 9 x 64 x 48
    for K, T_, seed in ((K_R, T_R, 63), (K_R_RAGGED, T_R, 64), (K_RDI, T_RDI, 67),
                        (K_RDI - 6, T_RDI, 68), (K_RDI - 6, 31, 70)):
        args = list(rmppi_inputs(dev, K, seed, T_))
        args[1] = DoubleIntegratorRobustCost(device=dev)
        n_bytes = 4 * (2 * K * T_ * C + 4 * K + T_ * C * S + T_ * C + C + 4 * C + 2 * S
                       + len(DoubleIntegratorCircleCost.PARAM_NAMES))
        at_path = (K, T_) == (K_RDI, T_RDI)
        rmppi_case(f"B8 di_robust K={K} T={T_}", tuple(args), "bitwise",
                   (n_bytes, K * T_ * rmppi_ops(S, C, OPS_STEP, OPS_DI_ROBUST_COST) + 3 * K),
                   staged=f"K={K} T={T_} (rmppi_di_robust)" if at_path else False)
    ddyn, dcost = DoubleIntegratorDynamics.create(device=dev), DoubleIntegratorRobustCost(device=dev)
    for s_per, T_ in ((S_PER_AR, T_R), (S_PER_RDI, T_RDI)):
        K_ = N_CAND_AR * s_per
        x0s = candidates(torch.tensor(X0_RDI, device=dev), [0.4, 0.2, 0.3, -0.4], s_per)
        Ud = GaussianDistribution.create(std_dev=[1.0, 1.0], device=dev).sample(
            g, 0.3 * torch.randn((T_, C), generator=g, device=dev), K_)[0].contiguous()
        x0_case(f"B1-x0 di_robust {K_} x {T_}", ddyn, dcost, x0s, Ud, "exact",
                (4 * (K_ * T_ * C + K_ * S + len(DoubleIntegratorCircleCost.PARAM_NAMES)
                      + 2 * K_),
                 K_ * T_ * (OPS_STEP + OPS_DI_ROBUST_COST + OPS_ACC) + 2 * K_))

    # B7 with the model inside, and B6 on the same linearisations
    cart = CartpoleDynamics.create(control_ranges=CART_RANGE, device=dev)
    ladders = {
        "ar_nn": (ladder_problem(AutorallyNNDynamics.create(seed=0, device=dev), ar_x0(dev),
                                 T_AR, 65), OPS_AR_DERIV, FNN_MACS + 68),
        "cartpole": (ladder_problem(cart, torch.tensor([0.0, 0.0, 0.5, 0.0], device=dev),
                                    T_ZOO, 66), OPS_CART_DERIV, 3),
        # the rmppi_di_robust loop's DDP (riccati_phase holds the DI at T=50)
        f"di T={T_RDI}": (ladder_problem(DoubleIntegratorDynamics.create(device=dev),
                                         torch.tensor(X0_RDI, device=dev), T_RDI, 69), 0, 0),
    }
    for name, (args, deriv_ops, n_params) in ladders.items():
        kout = riccati.riccati_ladder_solve(*args)
        pout = ladder_plain(args)
        torch.cuda.synchronize()
        checks["riccati_ladder_kernel"].extend(
            check(f"B7 {name} {n}", a, b, "exact")
            for n, a, b in zip(("gains", "feedforward", "costs", "xs_new", "us_new"),
                               kout, pout))
        timing(f"B7 {name}", lambda args=args: riccati.riccati_ladder_solve(*args),
               lambda args=args: ladder_plain(args), ladder_work(args, deriv_ops, n_params))
        back = (args[3], args[4], args[5], args[6], args[7], args[8], args[10], args[11])
        T_, S_, C_ = back[0].shape[0], back[0].shape[1], back[1].shape[2]
        kK, kk = riccati.riccati_backward(*back, DT)
        Ks, ks = riccati.riccati_backward_plain(*back[:4], back[4] * DT, back[5] * DT,
                                                back[6], back[7], DT, 1e-6)
        torch.cuda.synchronize()
        bname = f"B6 ({S_}, {C_})"
        # B7's warp recursion and B6's one thread: the same floats
        same(f"B7 {name} gains against {bname}'s", kout[0], kK)
        same(f"B7 {name} feedforward against {bname}'s", kout[1], kk)
        checks["riccati_backward_kernel"] += [
            check(f"{bname} gains", kK, Ks, "bitwise"),
            check(f"{bname} feedforward", kk, ks, "bitwise")]
        timing(bname, lambda back=back: riccati.riccati_backward(*back, DT),
               lambda back=back: riccati.riccati_backward_plain(
                   *back[:4], back[4] * DT, back[5] * DT, back[6], back[7], DT, 1e-6),
               backward_work(back))
        times[bname]["chain_steps"] = times[f"B7 {name}"]["chain_steps"] = T_ - 1
        backward_forms(f"({S_}, {C_}) T={T_}", back)
    # B6 at the longest horizon it takes, on AutoRally's linearisation: its
    # gains fill 64 KB of shared memory, past the 48 KB default
    args = ladder_problem(AutorallyNNDynamics.create(seed=0, device=dev), ar_x0(dev), T_B6_MAX,
                          65)
    back = (args[3], args[4], args[5], args[6], args[7], args[8], args[10], args[11])
    kK, kk = riccati.riccati_backward(*back, DT)
    Ks, ks = riccati.riccati_backward_plain(*back[:4], back[4] * DT, back[5] * DT, back[6],
                                            back[7], DT, 1e-6)
    torch.cuda.synchronize()
    checks["riccati_backward_kernel"] += [
        check(f"B6 (7, 2) T={T_B6_MAX} gains", kK, Ks, "bitwise"),
        check(f"B6 (7, 2) T={T_B6_MAX} feedforward", kk, ks, "bitwise")]
    backward_forms(f"(7, 2) T={T_B6_MAX}", back)
    emit("robust_kernels", K_ar=K_AR, T_ar=T_AR, K_x0=K_x0, crashed_share=crashed,
         checks=[c for cs in checks.values() for c in cs], times=times)
    return checks, times


def robust_reference_ar_phase(dev):
    """RMPPI (kernel="fused") and Tube-MPPI (kernel="fused_solve") on
    AutoRally at full width against kernel="combined" on the same normals
    (RMPPI from one warm state with an initialized nominal system), each
    kernel path under set_sync_debug_mode("error") after a warm call. The
    eager network sums with a matmul: costs at TOL "solve"; the means within
    2 max|dJ| / lambda times the samples' spread (``model_reference_phase``);
    the candidate free energies within max|dJ|; the DDP gains, which both
    paths compute with the ladder kernel from the same nominal trajectory, to
    the last bit."""
    g = torch.Generator(device=dev).manual_seed(71)
    x = ar_x0(dev)
    e1 = torch.randn((S_PER_AR, T_AR, C), generator=g, device=dev)
    e2 = torch.randn((K_AR, T_AR, C), generator=g, device=dev)
    combined, fused = build_rmppi_ar("combined"), build_rmppi_ar("fused")
    warm, _ = combined.update_importance_sampling(x, combined.init_state(seed=0), 1)
    _, warm = combined.solve(x, warm)
    x1 = x + torch.tensor([0.02, 0.03, 0.01, 0.0, 0.05, 0.0, 0.0], device=dev)

    def cycle(ctrl):
        s1, fe = ctrl.update_importance_sampling(x1, warm, 1, injected_noise=e1)
        res, _ = ctrl.solve(x1, s1, injected_noise=e2)
        return s1, fe, res

    def strict(fn):
        fn()  # one-time copies
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    sc, fec, rc = cycle(combined)
    sf, fef, rf = strict(lambda: cycle(fused))
    torch.cuda.synchronize()
    if int(sf.best_index) != int(sc.best_index) or (
            int(sf.nominal_stride) != int(sc.nominal_stride)):
        raise AssertionError("fused and combined RMPPI chose different candidates")
    checks = [check("rmppi gains", sf.feedback_state.gains, sc.feedback_state.gains,
                    "bitwise")]

    def systems(name, a, b, U):
        """Costs, crash flags and means of both systems; ``U`` the samples
        without their means, the spread taken against b's means."""
        dJ = 0.0
        for system in ("real", "nominal"):
            sa, sb = getattr(a, system), getattr(b, system)
            checks.append(check(f"{name} {system} costs", sa.costs, sb.costs, "solve"))
            same(f"{name} {system} crash flags (against combined)", sa.crash, sb.crash)
            d = float((sa.costs - sb.costs).abs().max())
            spread = float((U[system] - sb.control_mean[None]).abs().max())
            checks.append(within(f"{name} {system} control_mean", sa.control_mean,
                                 sb.control_mean, 2 * d / LAM * spread + 1e-5))
            dJ = max(dJ, d)
        return dJ

    # RMPPI draws both systems' samples around the nominal mean
    U = e2 * combined.sampler.std_dev + sc.nominal_mean
    dJ = systems("rmppi", rf, rc, {"real": U, "nominal": U})
    checks.append(within("rmppi candidate free energy", fef, fec, dJ + 1e-5))

    tcomb, tfused = build_tube_ar("combined"), build_tube_ar("fused_solve")
    state = tcomb.init_state(seed=0)
    rtc, _ = tcomb.solve(x1, state, injected_noise=e2)
    rtf, _ = strict(lambda: tfused.solve(x1, state, injected_noise=e2))
    torch.cuda.synchronize()
    noise = e2 * tcomb.sampler.std_dev
    systems("tube", rtf, rtc, {"real": noise + state.control_mean,
                               "nominal": noise + state.nominal_mean})
    emit("robust_reference_ar", K=K_AR, T=T_AR, candidates=N_CAND_AR,
         samples_per_condition=S_PER_AR, best_index=int(sf.best_index),
         crashed_share={"rmppi": float(rc.real.crash.float().mean()),
                        "tube": float(rtc.real.crash.float().mean())},
         checks=checks, no_host_sync=["rmppi fused", "tube fused_solve"])


def robust_family_loop(path, ctrl, x0, steps, want, *, disturb=None, profile=1,
                       split_from=None, **labels):
    """``steps`` closed-loop steps of a robust controller from ``x0``:
    stage 1 (RMPPI), slide, solve, the plant (the controller's model) with
    the real system's first control, plus ``disturb[i]`` where given; from
    step ``split_from`` on the controller runs with split_cost=True. Then a
    profiler window of ``profile`` steps from the last state. Nothing inside
    the loop waits on the device. Fails unless the kernels launched as
    ``want`` says and every state, cost and gain is finite. Returns
    (launches, entry launches, the states (steps, S), the last result, the
    last controller state, the last plant state)."""
    if ctrl.device.type != "cuda":
        raise AssertionError("the controller did not default to the card")
    STEPS_BY_PATH[path] = steps
    rmppi = isinstance(ctrl, RobustMPPI)
    cs, x = ctrl.init_state(seed=0), x0
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(steps)]
    states, crashed = [], []
    torch.cuda.synchronize()
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        if i == split_from:
            ctrl.split_cost = True
        ev[i][0].record()
        if rmppi:
            cs, _ = ctrl.update_importance_sampling(x, cs, 1)
        ev[i][1].record()
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        ev[i][2].record()
        x, _ = ctrl.dynamics.step(x, res.real.control_mean[0], 0.0, ctrl.dt)
        if disturb is not None:
            x = x + disturb[i]
        ev[i][3].record()
        states.append(x)
        crashed.append(res.real.crash.sum())
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, entries = dict(fr.launch_counts), dict(fr.entry_counts)
    expect_launches(launches, want, path)
    X = torch.stack(states).cpu()
    for name, t in (("states", X), ("control_mean", res.real.control_mean),
                    ("costs", res.real.costs), ("nominal costs", res.nominal.costs),
                    ("state_trajectory", res.real.state_trajectory),
                    ("gains", cs.feedback_state.gains)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{path}: {name} is not finite")
    K_, T_ = ctrl.num_rollouts, ctrl.num_timesteps
    if res.real.control_mean.shape != (T_, ctrl.dynamics.CONTROL_DIM) or (
            res.real.costs.shape != (K_,)):
        raise AssertionError(f"{path}: unexpected result shapes")
    steady = ev[min(5, steps - 1):]
    med = lambda a, b: statistics.median(e[a].elapsed_time(e[b]) for e in steady)
    emit(f"{path}_main_path", K=K_, T=T_, kernel=ctrl.kernel, steps=steps, **labels,
         launches=launches, entry_launches=entries,
         launches_per_step=sum(launches.values()) / steps,
         crashed_share=float(torch.stack(crashed).float().mean().cpu()) / K_,
         final_state=X[-1].tolist(), final_baseline_real=float(res.real.baseline),
         stage1_ms_median=med(0, 1) if rmppi else None, solve_ms_median=med(1, 2),
         step_ms_median=med(0, 3), host_wall_ms_per_step=1e3 * wall_s / steps)
    if profile:
        def step():
            s = cs
            if rmppi:
                s, _ = ctrl.update_importance_sampling(x, s, 1)
            s = ctrl.slide_control_sequence(s, 1)
            r, _ = ctrl.solve(x, s)
            ctrl.dynamics.step(x, r.real.control_mean[0], 0.0, ctrl.dt)

        profile_steps(path, step, n=profile, warmup=1)
    return launches, entries, X, res, cs, x


def robust_family_loops(dev):
    """rmppi_autorally and tube_autorally (ROBUST_AR_STEPS each, the
    AutoRally model as the plant) and rmppi_di_robust (60 steps with the
    velocity disturbances of tests/test_tube_robust.py:181-199, numpy seed
    1, and its bar). Returns {path: (launches, entry launches)}."""
    n = ROBUST_AR_STEPS
    paths = {}
    out = robust_family_loop(
        "rmppi_autorally", build_rmppi_ar("fused"), ar_x0(dev), n,
        {b1_kernel("ar_nn", x0=True): n - 1, split_name("ar_nn", "rmppi"): n,
         LADDER: n}, map="128", cost="ARRobustCost")
    paths["rmppi_autorally"] = out[:2]
    out = robust_family_loop(
        "tube_autorally", build_tube_ar("fused_solve"), ar_x0(dev), n,
        {**solve_launches("ar_nn", 2 * n), LADDER: n}, map="128", cost="ARStandardCost")
    paths["tube_autorally"] = out[:2]
    n = ROBUST_DI_STEPS
    rng = np.random.RandomState(1)
    disturb = torch.zeros((n, S), device=dev)
    disturb[:, 2:] = torch.tensor(np.stack([rng.randn(2) * 0.02 for _ in range(n)]),
                                  dtype=torch.float32, device=dev)
    out = robust_family_loop(
        "rmppi_di_robust", build_rmppi_di_robust("fused"), torch.tensor(X0_RDI, device=dev),
        n, {b1_kernel("di_robust", x0=True): n - 1, split_name("di_robust", "rmppi"): n,
            LADDER: n}, disturb=disturb, profile=False)
    band_check("rmppi_di_robust", out[2])
    paths["rmppi_di_robust"] = out[:2]
    return paths


def factory_kernel_checks(name, ctrl, x0, ladder, seed):
    """A factory's kernels against their plain versions at its own shapes and
    parts (dynamics, cost, sampler, K, T), before its counted solves: B3 on
    a random mean (U, costs, crash flags to the last bit, the carry rows at
    TOL "carry"), the merge of its carry, and the ladder at its T where its
    DDP runs it (TOL "exact"). Returns {C function: checks}."""
    dev = x0.device
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn, cost, K_, T_ = ctrl.dynamics, ctrl.cost, ctrl.num_rollouts, ctrl.num_timesteps
    C_ = dyn.CONTROL_DIM
    mean = 0.3 * torch.randn((T_, C_), generator=g, device=dev)
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    args = (dyn, cost, ctrl.sampler, x0, mean, seed_t, ctrl.dt, ctrl.lam, ctrl.alpha, K_)
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, split_cost=False)
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args)
    kmerge = fr.flash_combine(kcarry, T_, C_, ctrl.lam)
    pmerge = fr.flash_combine_plain(pcarry, T_, C_, ctrl.lam)
    torch.cuda.synchronize()
    same(f"{name} B3 crash flags", kcrash, pcrash)
    out = {fr._entry(dyn, cost, "solve")[1]: [
        check(f"{name} B3 U", kU, pU, "bitwise"),
        check(f"{name} B3 costs", kc, pc, "bitwise"),
        check(f"{name} B3 carry", kcarry, pcarry, "carry",
              fr.block_carries_plain(pc, pU.abs(), ctrl.lam).abs())],
        "flash_combine_kernel": [check(f"{name} merge {n}", a, b, n) for n, a, b in
                                 zip(("new_mean", "baseline", "eta"), kmerge, pmerge)]}
    if ladder:
        largs = ladder_problem(dyn, x0, T_, seed + 1)
        kout = riccati.riccati_ladder_solve(*largs)
        pout = ladder_plain(largs)
        torch.cuda.synchronize()
        out[riccati._LADDER_ENTRY[type(dyn)]] = [
            check(f"{name} B7 {n}", a, b, "exact")
            for n, a, b in zip(("gains", "feedforward", "costs", "xs_new", "us_new"),
                               kout, pout)]
    return out


def instantiations_phase(dev):
    """Each factory of mppi_generic_tpu_torch.instantiations built on the
    card at its published scale with kernel="fused_solve" (the factories'
    default is "combined"): its kernels held against their plain versions
    at its shapes (``factory_kernel_checks``), then INSTANTIATION_SOLVES
    closed-loop steps (slide, solve, the model as the plant); after each
    solve the DDP feedback tracks the solve's trajectory: the ladder kernel
    for AutoRally, the cartpole and the double integrator, the eager scan
    for the quadrotor (S = 13 is outside the kernels' sizes). The racer
    model (S = 26) computes none. Returns ({path: (launches, entry
    launches)}, {C function: checks})."""
    from mppi_generic_tpu_torch import instantiations

    quad = torch.zeros(13, device=dev)
    quad[6] = 1.0
    x0s = {"autorally_mppi": ar_x0(dev), "cartpole_mppi": torch.zeros(4, device=dev),
           "double_integrator_mppi": torch.tensor(X0, device=dev),
           "quadrotor_mppi": quad, "quadrotor_waypoint_mppi": quad,
           "racer_lstm_mppi": racer_x0("racer_unc_ar", dev)}
    n, paths, summary, checks = INSTANTIATION_SOLVES, {}, {}, {}
    for i, name in enumerate(instantiations.__all__):
        ctrl, fb = getattr(instantiations, name)(kernel="fused_solve", split_cost=False)
        with_fb = name != "racer_lstm_mppi"
        ladder = with_fb and riccati.supported(ctrl.dynamics.STATE_DIM,
                                               ctrl.dynamics.CONTROL_DIM, ctrl.num_timesteps)
        for fn, fn_checks in factory_kernel_checks(name, ctrl, x0s[name], ladder,
                                                   121 + 2 * i).items():
            checks.setdefault(fn, []).extend(fn_checks)
        cs, x = ctrl.init_state(seed=0), x0s[name]
        torch.cuda.synchronize()
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            cs = ctrl.slide_control_sequence(cs, 1)
            res, cs = ctrl.solve(x, cs)
            if with_fb:
                fbs = fb.compute_feedback(x, res.state_trajectory[:-1], res.control_mean)
            x, _ = ctrl.dynamics.step(x, res.control_mean[0], 0.0, ctrl.dt)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, entries = dict(fr.launch_counts), dict(fr.entry_counts)
        solve = fr.form_kernel_name("fused_solve", fr._entry(ctrl.dynamics, ctrl.cost, "solve"))
        carry = n if solve == "fused_solve_warp_kernel" else 0  # the warp form's carry pass
        expect_launches(launches, {solve: n, MERGE: n, CARRY: carry,
                                   LADDER: n if ladder else 0}, name)
        for what, t in (("state", x), ("control_mean", res.control_mean),
                        ("costs", res.costs)) + ((("gains", fbs.gains),) if with_fb else ()):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name}: {what} is not finite")
        paths[name] = (launches, entries)
        STEPS_BY_PATH[name] = n
        summary[name] = {"K": ctrl.num_rollouts, "T": ctrl.num_timesteps,
                         "dynamics": type(ctrl.dynamics).__name__,
                         "cost": type(ctrl.cost).__name__,
                         "feedback": ("ladder kernel" if ladder else
                                      "eager scan" if with_fb else "none"),
                         "launches": launches, "entry_launches": entries,
                         "crashed_share": float(res.crash.float().mean()),
                         "host_wall_ms_per_step": 1e3 * wall_s / n}
    emit("instantiations", solves=n, kernel="fused_solve", factories=summary,
         checks=[c for cs in checks.values() for c in cs])
    return paths, checks


# ---------------------------------------------------------------------------
# The split form (csrc/split_kernels.cuh): the split modes of B1 (four
# modes) and B3 (Gaussian, NLN) for the double integrator (K=8192 and the
# ragged 8000, T=100) and AutoRally (K=1920 and 1900, T=150, on the 128^2
# bench map and on the partly-crashing map), each pass timed apart and the
# whole form A B B A against the combined kernel; the split loops and the
# kernel tuner.
# ---------------------------------------------------------------------------
SPLIT_MODES = ("costs", "costs+lr", "epilogue+lr", "tsallis+lr")
SPLIT_EPI = {"costs": fr.EPI_NONE, "costs+lr": fr.EPI_NONE, "epilogue+lr": fr.EPI_EXP,
             "tsallis+lr": fr.EPI_MIN}
SPLIT_AR_LOOP_STEPS = 20  # the forced-split AutoRally fused_solve loop
SPLIT_AR_FUSED_STEPS = 5  # the forced-split AutoRally fused loop: B1's split on a path


def split_inputs(dev, pair, K, p, stride, seed, map_kind):
    """(dynamics, cost, x0, mean, U, LR tables, samplers by kind, T) of one
    split case: the DI flagship's inputs (``make_inputs``), AutoRally's
    (``ar_kernel_phase``'s) on ``map_kind``, or another pair's at its path's
    shape (``pair_parts``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if pair == "di_circle":
        dyn, cost, x0, U, lr = make_inputs(dev, K, p, seed)
        return (dyn, cost, x0, lr[0], U, lr,
                {k: make_sampler(k, dev, p) for k in ("gaussian", "nln")}, T)
    if pair == "ar_nn":
        dyn, cost = robust_ar_parts(map_kind, dev, robust=False)
        x0, std, offset, T_ = ar_x0(dev), AR_STD, 0.0, T_AR
        samplers = {k: ar_sampler(k, dev, p) for k in ("gaussian", "nln")}
    else:
        dyn, cost, x0, std, offset, T_ = pair_parts(pair, dev, map_kind)
        T_ = case_T(pair, K, T_)
        samplers = {k: zoo_sampler(k, dyn.CONTROL_DIM, std, dev, p, T_)
                    for k in ("gaussian", "nln")}
    C_ = dyn.CONTROL_DIM
    mean = 0.2 * torch.randn((T_, C_), generator=g, device=dev)
    mean[:, -1] += offset
    samp = samplers["gaussian"]
    U, _ = samp.sample(g, mean, K, optimization_stride=stride)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    lr = (mean, samp._sigma(T_, 0).contiguous(), samp.control_cost_coeff, LAM, ALPHA,
          samp.pure_threshold(K))
    return dyn, cost, x0, mean, U, lr, samplers, T_


def pair_fixed_bytes(dyn, cost, which):
    """The tables a pass reads once: the model's table and map (the dynamics
    passes) or the cost's table and map (the cost pass)."""
    if which == "cost":
        tables = (cost.params, cost.kernel_map())
    else:
        tables = (dyn.kernel_params(), dyn.kernel_map())
    return 4 * sum(t.numel() for t in tables if t is not None)


def split_pass_work(pair, dyn, cost, K, T_, which, mode="costs", kind="gaussian",
                    x0_rows=1):
    """(bytes, operations) of one pass at this shape: ``which`` "dynamics"
    (B1's: U and x0 (``x0_rows`` of them) read, Y written; the steps),
    "solve_dynamics" (B3's: the tables read, U, Y and the LR sums written;
    the draw, carve-outs, clamp, LR and the steps) or "cost" (Y and U read,
    costs, crash and the mode's rows written; the running cost of each step
    once, the LR term, the sums and the epilogue). A sticky crash's dual
    evaluation is the design's, not the function's: counted once."""
    step, cost_ops = PAIR_OPS[pair]
    S_, C_, O_ = dyn.STATE_DIM, dyn.CONTROL_DIM, dyn.OUTPUT_DIM
    KT = K * T_
    fixed = pair_fixed_bytes(dyn, cost, which)
    if which == "dynamics":
        return fixed + 4 * (KT * C_ + x0_rows * S_ + KT * O_), KT * step
    if which == "solve_dynamics":
        tables = 3 + (kind == "nln")  # mean, sigma, coeff / sigma^2, NLN's std
        draw = (OPS_PHILOX + (2 if kind == "nln" else 1) * OPS_BOX_MULLER) * (-(-C_ // 2))
        per_channel = 4 + 7 + 5 + (OPS_TRANSCENDENTAL + 2 if kind == "nln" else 0)
        n_bytes = fixed + 4 * (tables * T_ * C_ + 4 * C_ + S_ + 1 + KT * C_ + KT * O_ + K)
        return n_bytes, KT * (draw + C_ * per_channel + step)
    nb = -(-K // fr.BLOCK)
    n_bytes = fixed + 4 * (KT * O_ + KT * C_ + 2 * K)
    n_ops = KT * (cost_ops + OPS_ACC) + 2 * K
    if mode.endswith("+lr"):
        n_bytes += 4 * (2 * T_ * C_ + C_)
        n_ops += KT * 8 * C_
    if mode == "solve":  # B3's LR sums read, its carry rows written
        n_bytes += 4 * (K + nb * (2 + T_ * C_))
        n_ops += 2 * K + 5 * K + 2 * KT * C_
    elif mode.startswith("epilogue"):
        n_bytes += 4 * nb * (2 + T_ * C_)
        n_ops += 5 * K + 2 * KT * C_
    elif mode.startswith("tsallis"):
        n_bytes += 4 * nb
        n_ops += K
    return n_bytes, n_ops


def split_form_work(pair, dyn, cost, K, T_, mode, kind=None):
    """(bytes, operations) of the function the split form computes: the
    combined kernel's (``rollout_work`` and its kin), the intermediate Y
    not counted."""
    if pair not in ("di_circle", "ar_nn"):
        ops = sum(PAIR_OPS[pair])
        if kind is not None:
            return zoo_sampling_work(dyn, cost, ops, K, T_, kind, True)
        return zoo_rollout_work(dyn, cost, ops, K, T_, mode)
    if kind is not None:  # B3
        return (sampling_work(K, kind, True, True, False, False) if pair == "di_circle"
                else ar_solve_work(cost, K, kind))
    epi, with_lr = mode.startswith("epilogue"), mode.endswith("+lr")
    if pair == "di_circle":
        return pass1_work(K) if mode.startswith("tsallis") else rollout_work(K, epi, with_lr)
    n_bytes, n_ops = ar_rollout_work(cost, K, epi, with_lr)
    if mode.startswith("tsallis"):
        n_bytes, n_ops = n_bytes + 4 * -(-K // fr.BLOCK), n_ops + K
    return n_bytes, n_ops


def split_cost_plain(cost, Y, U, lrp, T_):
    """Plain version of the cost pass with the exp epilogue on the kernels'
    outputs Y (T, O, K): (carry rows, crash flags)."""
    Y = Y.permute(2, 0, 1)
    acc, crash = fr.split_sums_plain(*fr.split_step_values_plain(cost, Y, U, lrp))
    costs = true_div(acc + cost.terminal_cost(Y[:, -1].T), T_)
    return fr.block_carries_plain(costs, U, LAM), crash


def abba(combined, split):
    """The combined and the split form timed in turns, combined, split,
    split, combined (CUDA events, medians of N_TIMED): their means and the
    four times."""
    a1, b1 = time_ms(combined, N_TIMED), time_ms(split, N_TIMED)
    b2, a2 = time_ms(split, N_TIMED), time_ms(combined, N_TIMED)
    return {"ms": (b1 + b2) / 2, "combined_ms": (a1 + a2) / 2,
            "abba_ms": [a1, b1, b2, a2], "split_faster": max(b1, b2) < min(a1, a2)}


def split_kernel_phase(dev, pair, K, p, stride, seed, map_kind=None, timed=False):
    """B1's split form in its four modes and B3's (Gaussian, NLN) against
    their plain versions at one shape: costs, crash flags, U and block
    minima bit for bit, the carries within rtol 1e-5 and the merge as the
    combined kernels'. With ``timed``: each pass's time and bound, the
    whole form A B B A against the combined kernel, the plain versions'
    times, and one library call for the exp epilogue."""
    dyn, cost, x0, mean, U, lr, samplers, T_ = split_inputs(dev, pair, K, p, stride, seed,
                                                            map_kind)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    checks, times, crashed = [], {}, {}
    plain_rollouts = {}  # {with LR: the plain B1 rollout}, shared by the modes

    def plain_ms(fn, run_ms=None):
        # the DI's plain versions take milliseconds; the others time_plain's;
        # a racer pair's the check's own run of it, timed (run_ms), which
        # time_plain would repeat
        if pair == "di_circle":
            return time_ms(fn, N_TIMED_PLAIN, warmup=1)
        if pair in RACER_PAIRS and run_ms is not None:
            return run_ms
        return time_plain(fn, pair)
    C_ = dyn.CONTROL_DIM

    def merge_checks(name, kcarry, pc, U_):
        pcarry = fr.block_carries_plain(pc, U_, LAM)
        km, kb, ke = fr.flash_combine(kcarry, T_, C_, LAM)
        pm, pb, pe = fr.flash_combine_plain(pcarry, T_, C_, LAM)
        return [check(f"{name} carry", kcarry, pcarry, "carry",
                      fr.block_carries_plain(pc, U_.abs(), LAM).abs()),
                check(f"{name} new_mean", km, pm, "new_mean"),
                check(f"{name} baseline", kb, pb, "baseline"),
                check(f"{name} eta", ke, pe, "eta")]

    for mode in SPLIT_MODES:
        lrp = lr if mode.endswith("+lr") else None
        epi = SPLIT_EPI[mode]
        name = f"B1 split {mode}"
        kc, kcrash, kout = fr._rollout_any(dyn, cost, x0, U, DT, lrp, epi, LAM, True)
        if (lrp is not None) not in plain_rollouts:
            plain_rollouts[lrp is not None] = plain_timed(
                lambda lrp=lrp: fr.split_rollout_plain(dyn, cost, x0, U, DT, lrp))
        (pc, pcrash), run_ms = plain_rollouts[lrp is not None]
        same(f"{name} crash flags", kcrash, pcrash)
        checks.append(check(f"{name} costs", kc, pc, "bitwise"))
        if epi == fr.EPI_EXP:
            checks += merge_checks(name, kout, pc, U)
        elif epi == fr.EPI_MIN:
            same(f"{name} block minima", kout, fr.block_minima_plain(pc))
            checks.append({"check": f"{name} block minima", "max_abs_err": 0.0})
        crashed[name] = float(kcrash.float().mean())
        if timed:
            t = abba(lambda: fr._rollout_cuda(dyn, cost, x0, U, DT, lrp, epi, LAM),
                     lambda: fr.split_rollout_cuda(dyn, cost, x0, U, DT, lrp, epi, LAM))
            t["bound_ms"], t["bound_by"] = bound_ms(*split_form_work(pair, dyn, cost, K, T_, mode))
            Y = fr.split_dynamics_cuda(dyn, cost, x0, U, DT)
            t["cost_pass"] = {"ms": time_ms(
                lambda: fr.split_cost_cuda(dyn, cost, Y, U, lrp, epi, LAM), N_TIMED)}
            t["cost_pass"]["bound_ms"], t["cost_pass"]["bound_by"] = bound_ms(
                *split_pass_work(pair, dyn, cost, K, T_, "cost", mode))
            t["plain_ms"] = None
            if mode == "epilogue+lr":
                t["plain_ms"] = plain_ms(lambda: fr.block_carries_plain(
                    fr.split_rollout_plain(dyn, cost, x0, U, DT, lrp)[0], U, LAM), run_ms)
                # one-call yardstick for the weighting + weighted sum (not used by the port)
                t["library_ms"] = time_ms(
                    lambda: torch.softmax(-pc / LAM, 0) @ U.view(K, -1), N_TIMED)
                t["cost_pass"]["plain_ms"] = plain_ms(
                    lambda: split_cost_plain(cost, Y, U, lrp, T_))
                dyn_pass = lambda: fr.split_dynamics_cuda(dyn, cost, x0, U, DT)
                # the lane-group pass A B B A against its one-thread build, the
                # staged pass the same (form_time)
                t["dynamics_pass"] = (turns(dyn_pass, "lanes") if pair in LANES_PAIRS
                                      else {"ms": form_time(dyn_pass, pair, "split_dynamics",
                                                            "B1")})
                t["dynamics_pass"]["plain_ms"] = plain_ms(
                    lambda: fr.split_outputs_plain(dyn, x0, U, DT))
                t["dynamics_pass"]["bound_ms"], t["dynamics_pass"]["bound_by"] = bound_ms(
                    *split_pass_work(pair, dyn, cost, K, T_, "dynamics"))
            times[name] = t
    if pair in LANES_PAIRS or earlier_form(pair, "split_dynamics") is not None:
        # the lane-group or staged pass and its one-thread build against the
        # plain version: Y bit for bit; the lane-group pass also at a ragged
        # T and K = 1901
        form = "lanes" if pair in LANES_PAIRS else "staged"
        cases = [U] + ([U[:, :31].contiguous()] + ([U[:1901]] if K == K_BI else [])
                       if pair in LANES_PAIRS else [])
        for U_ in cases:
            checks += warp_pass_checks(
                (f"{pair} {U_.shape[0]} x {U_.shape[1]} Y",),
                lambda U_=U_: (fr.split_dynamics_cuda(dyn, cost, x0, U_, DT),),
                lambda U_=U_: (fr.split_outputs_plain(dyn, x0, U_, DT).permute(1, 2, 0),),
                form)
    for kind, samp in samplers.items():
        name = f"B3 split {kind}"
        args = (dyn, cost, samp, x0, mean, seed_t, DT, LAM, ALPHA, K)
        kw = dict(optimization_stride=stride)
        kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, split_cost=True, **kw)
        (pc, pcrash, pU, pcarry), run_ms = plain_timed(
            lambda args=args: fused_solve.fused_solve_split_plain(*args, **kw))
        same(f"{name} crash flags", kcrash, pcrash)
        checks += [check(f"{name} U", kU, pU, "bitwise"),
                   check(f"{name} costs", kc, pc, "bitwise"),
                   *merge_checks(name, kcarry, pc, pU)]
        crashed[name] = float(kcrash.float().mean())
        kid = fr.noise_kind(samp)
        if earlier_form(pair, "split_solve_dynamics") is not None:
            # the staged pass and its one-thread build against the plain
            # version: U, Y and the LR sums bit for bit
            def plain_pass(samp=samp):
                pU, plr = fused_solve._samples_plain(dyn, samp, mean, seed_t, K, 0, stride, None)
                return pU, fr.split_outputs_plain(dyn, x0, pU, DT).permute(1, 2, 0), plr

            pass_args = (dyn, cost, samp, kid, x0, mean, seed_t, DT, K, 0, stride, None)
            checks += warp_pass_checks(
                tuple(f"{pair} {K} x {T_} B3 {kind} {w}" for w in ("U", "Y", "LR sums")),
                lambda: fused_solve.split_solve_dynamics_cuda(*pass_args), plain_pass, "staged")
        if timed:
            t = abba(lambda: fused_solve.fused_solve_carries(*args, split_cost=False),
                     lambda: fused_solve.fused_solve_carries(*args, split_cost=True))
            t["bound_ms"], t["bound_by"] = bound_ms(*split_form_work(pair, dyn, cost, K, T_, None,
                                                                     kind))
            dyn_args = (dyn, cost, samp, kid, x0, mean, seed_t, DT, K, 0, 0, None)
            Uk, Y, lrs = fused_solve.split_solve_dynamics_cuda(*dyn_args)
            # the staged pass A B B A against its one-thread build (form_time)
            t["dynamics_pass"] = {"ms": form_time(
                lambda: fused_solve.split_solve_dynamics_cuda(*dyn_args), pair,
                "split_solve_dynamics", kind)}
            t["dynamics_pass"]["bound_ms"], t["dynamics_pass"]["bound_by"] = bound_ms(
                *split_pass_work(pair, dyn, cost, K, T_, "solve_dynamics", kind=kind))
            gain = fr._lr_gain(LAM, ALPHA)
            t["cost_pass"] = {"ms": time_ms(lambda: fr.split_cost_cuda(
                dyn, cost, Y, Uk, None, fr.EPI_EXP, LAM, lrs, gain), N_TIMED)}
            t["cost_pass"]["bound_ms"], t["cost_pass"]["bound_by"] = bound_ms(
                *split_pass_work(pair, dyn, cost, K, T_, "cost", "solve"))
            t["plain_ms"] = None
            if kind == "gaussian":
                t["plain_ms"] = plain_ms(lambda: fused_solve.fused_solve_split_plain(*args),
                                         run_ms if stride == 0 else None)
                t["dynamics_pass"]["plain_ms"] = plain_ms(lambda: fr.split_outputs_plain(
                    dyn, x0, fused_solve._samples_plain(dyn, samp, mean, seed_t, K, 0, 0,
                                                        None)[0], DT))
            times[name] = t
    emit("split_kernels", pair=pair, map=map_kind, K=K, T=T_, pure_noise_percentage=p,
         stride=stride, crashed_share=crashed, checks=checks, times=times)
    return checks, times


def build_split_vanilla(kernel, split_cost):
    """The flagship (bench.py:31-50) with the split form forced or not."""
    return VanillaMPPI(
        DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
        make_sampler("gaussian"), dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T,
        num_rollouts=K_MAIN, num_iters=1, kernel=kernel, split_cost=split_cost)


def split_choice(dyn, cost, kernel):
    """``split_cost`` for a loop that is to run the split form on ``kernel``
    ("fused" or "fused_solve"): None where AUTO takes the split for the pair
    (``fr.AUTO_SPLIT``), else True (forced)."""
    auto = fr.resolve_split(dyn, cost, None, "solve" if kernel == "fused_solve" else "rollout")
    return None if auto else True


def split_loops(dev):
    """The flagship's 100-step closed loop with the split form forced on
    ``fused`` and on ``fused_solve`` and on the eager ``kernel="split"``
    path (the flagship's bar), then AutoRally's split loops (the split
    form's dynamics passes in their warp form; on AUTO where it takes the
    split, else forced: ``split_choice``): 20 steps on ``fused_solve``, a
    few on ``fused`` (states finite, the crashed share recorded). Returns
    {path: (launches, entry launches)}."""
    n = CLOSED_LOOP_STEPS
    paths = {}
    for path, kernel, split, want in (
            ("split_fused", "fused", True,
             {split_name("di_circle", "split_dynamics"): n,
              cost_kernel("di_circle", K_MAIN, T): n, MERGE: n}),
            ("split_fused_solve", "fused_solve", True,
             {split_name("di_circle", "split_solve_dynamics"): n,
              cost_kernel("di_circle", K_MAIN, T): n, MERGE: n}),
            ("split_eager", "split", None, {})):
        launches = vanilla_loop_phase(path, build_split_vanilla(kernel, split), want,
                                      settle=True)
        paths[path] = (launches, dict(fr.entry_counts))
    for path, kernel, steps, dyn_kernel in (
            ("autorally_split_fused_solve", "fused_solve", SPLIT_AR_LOOP_STEPS,
             "split_solve_dynamics_warp_kernel"),
            ("autorally_split_fused", "fused", SPLIT_AR_FUSED_STEPS,
             "split_dynamics_warp_kernel")):
        dyn, cost = ar_parts("128")
        ctrl = VanillaMPPI(dyn, cost, ar_sampler("gaussian"), dt=DT, lam=LAM, alpha=ALPHA,
                           num_timesteps=T_AR, num_rollouts=K_AR, num_iters=1, kernel=kernel,
                           split_cost=split_choice(dyn, cost, kernel))
        launches, entries, _, _ = model_loop_phase(
            path, ctrl, ar_x0(dev), steps,
            {dyn_kernel: steps, cost_kernel("ar_nn", K_AR, T_AR): steps, MERGE: steps},
            profile=False, map="128")
        paths[path] = (launches, entries)
    return paths


def autotune_phase(dev):
    """The kernel tuner on the flagship (bench.py:31-50): the four kernel
    paths, then the split sweep of the winner, timed in this run (a cache
    directory of its own, so nothing read from an earlier run)."""
    ctrl = build_vanilla("gaussian", "fused", split_cost=None)
    x = torch.tensor(X0, device=dev)
    cache_dir = _build.BUILD_ROOT.parent / "chip_smoke_autotune"
    timings = {}
    t0 = time.perf_counter()
    saved = os.environ.get("MPPI_TUNE_CACHE_DIR")
    os.environ["MPPI_TUNE_CACHE_DIR"] = str(cache_dir)
    try:
        tuned = autotune.choose_appropriate_kernel(ctrl, x, retune=True, timings=timings)
        t_tune = time.perf_counter() - t0
        fr.reset_launch_counts()
        again = autotune.choose_appropriate_kernel(ctrl, x)
    finally:
        if saved is None:
            del os.environ["MPPI_TUNE_CACHE_DIR"]
        else:
            os.environ["MPPI_TUNE_CACHE_DIR"] = saved
    if tuned.kernel not in autotune.DEFAULT_CANDIDATES:
        raise AssertionError(f"autotune chose {tuned.kernel!r}")
    if (again.kernel, again.split_cost) != (tuned.kernel, tuned.split_cost) or any(
            fr.launch_counts.values()):
        raise AssertionError("the second tuner call did not come from the cache")
    missing = [k for k in autotune.DEFAULT_CANDIDATES if k not in timings]
    if missing:
        raise AssertionError(f"autotune timed no {missing}")
    emit("autotune", K=K_MAIN, T=T, candidates=list(autotune.DEFAULT_CANDIDATES),
         ms_per_solve={k: 1e3 * v for k, v in timings.items()}, kernel=tuned.kernel,
         split_cost=tuned.split_cost, tune_s=t_tune)
    return tuned.kernel, tuned.split_cost, timings


# ---------------------------------------------------------------------------
# Every pair on every kernel mode: the fused sampling kernel (B4) for the
# pairs that lacked it (AutoRally, the quadrotor with either cost, the Dubins
# car with a fixed goal and a goal trajectory, the DI with QuadraticCost or
# its robust cost, the bicycle, the racer LSTM models in the kernel's
# recurrent mode), B3 for the bicycle and the DI robust cost; the split form
# of B1 and B3 for the cartpole, the quadrotor with its quadratic cost, the
# DI and the Dubins car with a fixed goal, the bicycle and the racer models;
# B1's split form from one x0 per sample (RMPPI's stage 1) for the DI robust
# cost and AutoRally. Each entry against its plain version at its path's
# full shape, at a ragged one (K 1900 / 8000, p 0.1, stride 2) and, for the
# map pairs, on the partly-crashing map; each split entry also A B B A
# against its combined kernel, which fills the AUTO table. Then the loops
# that put each new entry on a path.
# ---------------------------------------------------------------------------
# operations per sample-step of each pair's step and cost
PAIR_OPS = {
    "di_circle": (OPS_STEP, OPS_COST),
    "ar_nn": (OPS_AR_STEP, OPS_AR_COST),
    "bicycle_ar": (OPS_BI_STEP, OPS_AR_COST),
    "cartpole": (OPS_CART_STEP, OPS_CART_COST),
    "quadrotor_quadratic": (OPS_QUAD_STEP, OPS_QQ_COST),
    "quadrotor_map": (OPS_QUAD_STEP, OPS_QMAP_COST),
    "dubins_quadratic": (OPS_DUBINS_STEP, ops_quadratic(3, False)),
    "dubins_trajectory": (OPS_DUBINS_STEP, ops_quadratic(3, True)),
    "di_quadratic": (OPS_STEP, ops_quadratic(4, False)),
    "di_robust": (OPS_STEP, OPS_DI_ROBUST_COST),
    "racer_steering_ar": (OPS_RACER_STEER, OPS_AR_COST),
    "racer_unc_ar": (OPS_RACER_UNC, OPS_AR_COST - 2 * 54),
}
SAMPLE_PAIRS = ("ar_nn", "bicycle_ar", "quadrotor_quadratic", "quadrotor_map",
                "dubins_quadratic", "dubins_trajectory", "di_quadratic", "di_robust",
                "racer_steering_ar", "racer_unc_ar")
SOLVE_PAIRS = ("bicycle_ar", "di_robust")  # the new B3 entries
SPLIT_PAIRS = ("cartpole", "quadrotor_quadratic", "di_quadratic", "dubins_quadratic",
               "bicycle_ar", "racer_steering_ar", "racer_unc_ar")
MAP_PAIRS = ("ar_nn", "bicycle_ar", "racer_steering_ar")  # on the partly-crashing map too
# the new entries' loops on the cheap pairs (20 until B1's warp form joined
# the run, cut for time)
PAIR_LOOP_STEPS = 6  # 10 until the robust family's finished entries joined
# the racer models' (about 10^5 eager launches per step; 3 until cut for time)
PAIR_LOOP_STEPS_HEAVY = 2
SPLIT_LOOP_STEPS = 5  # the forced-split loops that put each split entry on a path
# the partly-crashing map: the bicycle and the racer steering model start
# 5 m before the block at x = 10.35 m at 3 m/s (AutoRally's network at
# scale 0.2 starts from x = 0, as in the robust kernel phase)
PARTIAL_X = 5.35


def pair_parts(pair, dev=None, map_kind=None):
    """(dynamics, cost, x0, std, mean offset of the last channel, T) of a
    pair at its path's horizon on ``dev`` (the controllers' default when
    None); ``map_kind="partial"`` puts a map pair's track on the
    partly-crashing map."""
    kw = {} if dev is None else {"device": dev}
    x0dev = dev if dev is not None else "cuda"
    if pair == "ar_nn":
        dyn, cost = robust_ar_parts(map_kind or "128", dev or "cuda", robust=False)
        return dyn, cost, ar_x0(x0dev), AR_STD, 0.0, T_AR
    if pair == "bicycle_ar":
        dyn, cost = bicycle_parts(dev or "cuda")
        x0 = torch.zeros(S_BI, device=x0dev)
        if map_kind == "partial":
            cost = ARStandardCost(costmap=partial_map(dev or "cuda"),
                                  output_indices=BI_OUTPUT_INDICES, **kw)
            x0[0], x0[5] = PARTIAL_X, 3.0
        return dyn, cost, x0, BI_STD, 0.0, T_BI
    if pair == "di_robust":
        return (DoubleIntegratorDynamics.create(**kw), DoubleIntegratorRobustCost(**kw),
                torch.tensor(X0_RDI, device=x0dev), [1.0, 1.0], 0.0, T_ZOO)
    dyn, cost, x0, std, offset, _ = zoo_parts(pair, dev)
    if map_kind == "partial" and pair == "racer_steering_ar":
        cost = ARStandardCost(costmap=partial_map(dev or "cuda"),
                              output_indices=RACER_INDICES, **kw)
        x0 = x0.clone()
        x0[2] = PARTIAL_X
    return dyn, cost, x0, std, offset, T_RACER.get(pair, T_ZOO)


def merge_checks(name, kcarry, pcarry, pc, X, T_, C_):
    """The carry rows of a kernel against the plain ones (rtol 1e-5 of the
    rows over |X|) and their merges (the merge's tolerances)."""
    km, kb, ke = fr.flash_combine(kcarry, T_, C_, LAM)
    pm, pb, pe = fr.flash_combine_plain(pcarry, T_, C_, LAM)
    return [check(f"{name} carry", kcarry, pcarry, "carry",
                  fr.block_carries_plain(pc, X.abs(), LAM).abs()),
            check(f"{name} new_mean", km, pm, "new_mean"),
            check(f"{name} baseline", kb, pb, "baseline"),
            check(f"{name} eta", ke, pe, "eta")]


def carry_pass_work(K, T_, C_):
    """(bytes, operations) of the carry rows of Smooth-MPPI's epilogue from
    the costs (K,) and W (K, T, C): both read once, the rows written once;
    s, the maxima, exp and the sums (5 a sample), the weighted sum (2 a
    sample-entry)."""
    nb = -(-K // fr.BLOCK)
    TC = T_ * C_
    return 4 * (K + K * TC + nb * (2 + TC)), 5 * K + 2 * K * TC


def pair_sample_phase(dev, pair, K, p, stride, seed, map_kind=None, timed=False):
    """B4 of a pair (Gaussian, NLN, Smooth-MPPI, Smooth-MPPI with its
    epilogue over W; off the timed shape the Gaussian and the epilogue) and,
    for the bicycle and the DI robust cost, B3 (Gaussian; timed also NLN),
    against their plain versions: U, W, costs and crash flags to the last
    bit, the carries at rtol 1e-5 and the merges as the merge's. With
    ``timed``: each mode's time by CUDA events against its bound, and the
    plain version's (Smooth with its epilogue; B3 Gaussian)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn, cost, x0, std, offset, T_ = pair_parts(pair, dev, map_kind)
    T_ = case_T(pair, K, T_)
    ops = sum(PAIR_OPS[pair])
    C_ = dyn.CONTROL_DIM
    mean = 0.3 * torch.randn((T_, C_), generator=g, device=dev)
    mean[:, -1] += offset
    dmean = 0.3 * torch.randn((T_, C_), generator=g, device=dev)
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    checks, times, crashed = [], {}, {}
    modes = ((("gaussian", False), ("nln", False), ("smooth", False), ("smooth", True))
             if timed else (("gaussian", False), ("smooth", True)))
    for kind, epilogue in modes:
        s = zoo_sampler(kind, C_, std, dev, p, T_)
        state = dmean if kind == "smooth" else None
        args = (dyn, cost, s, x0, mean, seed_t, DT, LAM, ALPHA, K)
        kout = fr.fused_sample_rollout_costs(*args, optimization_stride=stride,
                                             sampler_state=state, epilogue=epilogue)
        (pc, pcrash, pU, pW), run_ms = plain_timed(lambda args=args, state=state: (
            fr.sample_rollout_plain(*args, optimization_stride=stride, sampler_state=state)))
        name = f"B4 {kind}{' epilogue' if epilogue else ''}"
        same(f"{pair} {name} crash flags", kout[1], pcrash)
        checks += [check(f"{pair} {name} U", kout[2], pU, "bitwise"),
                   check(f"{pair} {name} costs", kout[0], pc, "bitwise")]
        if epilogue:
            pm, pb, pe = fr.flash_combine_plain(fr.block_carries_plain(pc, pW, LAM),
                                                T_, C_, LAM)
            checks += [check(f"{pair} {name} new_deriv_mean", kout[3], pm, "new_mean"),
                       check(f"{pair} {name} baseline", kout[4], pb, "baseline"),
                       check(f"{pair} {name} eta", kout[5], pe, "eta")]
            # the carry rows themselves (the warp form's carry pass, the
            # one-thread kernel's epilogue): write_block_carry's order
            kcarry = fr._sample_rollout_cuda(dyn, cost, s, fr.noise_kind(s), x0, mean, seed_t,
                                             DT, LAM, ALPHA, K, 0, stride, state, True,
                                             False, None)[4]
            checks.append(check(f"{pair} {name} carry rows", kcarry,
                                fr.block_carries_ordered(pc, pW, fr._f32(LAM)), "bitwise"))
        elif kind == "smooth":
            checks.append(check(f"{pair} {name} W", kout[3], pW, "bitwise"))
        crashed[name] = float(kout[1].float().mean())
        if timed:
            kid = fr.noise_kind(s)

            def kernel(s=s, kid=kid, state=state, epilogue=epilogue):
                # the kernel alone, as the main path launches it (U not kept)
                return fr._sample_rollout_cuda(dyn, cost, s, kid, x0, mean, seed_t, DT,
                                               LAM, ALPHA, K, 0, stride, state, epilogue,
                                               False, None)

            def plain(args=args, state=state):
                out = fr.sample_rollout_plain(*args, optimization_stride=stride,
                                              sampler_state=state)
                return fr.block_carries_plain(out[0], out[3], LAM)

            # a racer pair's plain time is the check's own run, timed (time_plain
            # would repeat that one run)
            plain_ms = None
            if epilogue:
                plain_ms = run_ms if pair in RACER_PAIRS else time_plain(plain, pair)
            t = {"ms": time_ms(kernel, N_TIMED), "plain_ms": plain_ms, "library_ms": None}
            t["bound_ms"], t["bound_by"] = bound_ms(*zoo_sampling_work(
                dyn, cost, ops, K, T_, kind, False, epilogue))
            times[name] = t
            warp = fr.form_kernel_name("fused_sample_rollout",
                                       fr._entry(dyn, cost, "sample")).endswith("_warp_kernel")
            if epilogue and warp:
                # the warp form's carry pass alone (launched on its own on the
                # costs and W, nothing before it to overlap), and its plain
                # version (the rows over W from the costs), both by device time
                Wc = pW.contiguous()
                t = {"ms": device_ms(lambda: fr._block_carries(pc, Wc, LAM), CARRY),
                     "plain_ms": device_ms(lambda: fr.block_carries_plain(pc, pW, LAM)),
                     "library_ms": None}
                t["bound_ms"], t["bound_by"] = bound_ms(*carry_pass_work(K, T_, C_))
                times[CARRY] = t
    if pair in SOLVE_PAIRS:
        for kind in ("gaussian", "nln") if timed else ("gaussian",):
            s = zoo_sampler(kind, C_, std, dev, p, T_)
            args = (dyn, cost, s, x0, mean, seed_t, DT, LAM, ALPHA, K)
            kw = dict(optimization_stride=stride)
            kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, split_cost=False,
                                                                     **kw)
            same_as_one_thread(f"{pair} B3 {kind} K={K}", lambda args=args: (
                fused_solve.fused_solve_carries(*args, split_cost=False, **kw)),
                (kc, kcrash, kU, kcarry), pair, "solve")
            pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, **kw)
            torch.cuda.synchronize()
            name = f"B3 {kind}"
            same(f"{pair} {name} crash flags", kcrash, pcrash)
            checks += [check(f"{pair} {name} U", kU, pU, "bitwise"),
                       check(f"{pair} {name} costs", kc, pc, "bitwise"),
                       *merge_checks(f"{pair} {name}", kcarry, pcarry, pc, pU, T_, C_)]
            crashed[name] = float(kcrash.float().mean())
            if timed:
                t = {"ms": form_time(lambda: fused_solve.fused_solve_carries(
                         *args, split_cost=False, **kw), pair, "solve", kind),
                     "plain_ms": (time_plain(lambda: fused_solve.fused_solve_plain(*args, **kw),
                                             pair)
                                  if kind == "gaussian" else None), "library_ms": None}
                t["bound_ms"], t["bound_by"] = bound_ms(*zoo_sampling_work(
                    dyn, cost, ops, K, T_, kind, True))
                times[name] = t
    emit("pair_sample_kernels", pair=pair, map=map_kind, K=K, T=T_,
         pure_noise_percentage=p, stride=stride, crashed_share=crashed, checks=checks,
         times=times)
    return checks, times


def split_x0_phase(dev, pair, map_kind=None, timed=False):
    """B1's split form from one x0 per sample at RMPPI's stage-1 shape (9
    candidates on a segment, each with its samples: the DI robust cost
    9 x 64, T=48; AutoRally with ARRobustCost 9 x 256, T=150) against its
    plain version (costs and crash flags to the last bit) and the combined
    per-sample-x0 kernel; with ``timed`` A B B A against that kernel, each
    pass timed apart."""
    g = torch.Generator(device=dev).manual_seed(131)
    if pair == "di_robust":
        dyn, cost = (DoubleIntegratorDynamics.create(device=dev),
                     DoubleIntegratorRobustCost(device=dev))
        xa, dx, n_per, T_, std = (torch.tensor(X0_RDI, device=dev),
                                  torch.tensor([0.3, 0.1, 0.4, -0.3], device=dev),
                                  S_PER_RDI, T_RDI, [1.0, 1.0])
    else:
        dyn, cost = robust_ar_parts(map_kind, dev)
        xa, dx, n_per, T_, std = (ar_x0(dev),
                                  torch.tensor([0.5, 0.3, 0.1, 0.0, -0.5, 0.0, 0.0],
                                               device=dev), S_PER_AR, T_AR, AR_STD)
    w = torch.linspace(0.0, 1.0, N_CAND_AR, device=dev)[:, None]
    X0c = (xa[None] + w * dx[None]).repeat_interleave(n_per, dim=0).contiguous()
    K = X0c.shape[0]
    sigma = torch.tensor([std], device=dev)
    U = sigma * torch.randn((K, T_, C), generator=g, device=dev)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, X0c, U, DT, split_cost=True)
    pc, pcrash = fr.split_rollout_plain(dyn, cost, X0c, U, DT)
    cc, ccrash = fr.fused_rollout_costs(dyn, cost, X0c, U, DT, split_cost=False)
    torch.cuda.synchronize()
    same(f"{pair} B1-x0 split crash flags", kcrash, pcrash)
    same(f"{pair} B1-x0 split vs combined crash flags", kcrash, ccrash)
    checks = [check(f"{pair} B1-x0 split costs", kc, pc, "bitwise")]
    if earlier_form(pair, "split_dynamics_x0") is not None:
        # the staged pass and the one-thread build against the plain version:
        # Y bit for bit at the loop's shape, 9 x 256 x 50 and a ragged one
        cases = [(X0c, U)]
        for n_per_, T__ in ((S_PER_AR, T_R), (23, 31)):
            X0_ = (xa[None] + w * dx[None]).repeat_interleave(n_per_, dim=0).contiguous()
            U_ = sigma * torch.randn((X0_.shape[0], T__, C), generator=g, device=dev)
            cases.append((X0_, U_.contiguous()))
        for X0_, U_ in cases:
            checks += warp_pass_checks(
                (f"{pair} B1-x0 {X0_.shape[0]} x {U_.shape[1]} Y",),
                lambda X0_=X0_, U_=U_: (fr.split_dynamics_cuda(dyn, cost, X0_, U_, DT),),
                lambda X0_=X0_, U_=U_: (
                    fr.split_outputs_plain(dyn, X0_, U_, DT).permute(1, 2, 0),), "staged")
    times = {}
    if timed:
        t = abba(lambda: fr._rollout_cuda(dyn, cost, X0c, U, DT, None),
                 lambda: fr.split_rollout_cuda(dyn, cost, X0c, U, DT, None))
        n_bytes, n_ops = zoo_rollout_work(dyn, cost, sum(PAIR_OPS[pair]), K, T_, "costs")
        t["bound_ms"], t["bound_by"] = bound_ms(n_bytes + 4 * (K - 1) * dyn.STATE_DIM, n_ops)
        Y = fr.split_dynamics_cuda(dyn, cost, X0c, U, DT)
        t["dynamics_pass"] = {"ms": form_time(
            lambda: fr.split_dynamics_cuda(dyn, cost, X0c, U, DT), pair, "split_dynamics_x0",
            "B1-x0")}
        t["dynamics_pass"]["bound_ms"], t["dynamics_pass"]["bound_by"] = bound_ms(
            *split_pass_work(pair, dyn, cost, K, T_, "dynamics", x0_rows=K))
        t["dynamics_pass"]["plain_ms"] = time_ms(
            lambda: fr.split_outputs_plain(dyn, X0c, U, DT), N_TIMED_PLAIN_AR, warmup=1)
        t["cost_pass"] = {"ms": time_ms(lambda: fr.split_cost_cuda(dyn, cost, Y, U), N_TIMED)}
        t["cost_pass"]["bound_ms"], t["cost_pass"]["bound_by"] = bound_ms(
            *split_pass_work(pair, dyn, cost, K, T_, "cost"))
        Yk = Y.permute(2, 0, 1)
        t["cost_pass"]["plain_ms"] = time_ms(lambda: fr.split_sums_plain(
            *fr.split_step_values_plain(cost, Yk, U)), N_TIMED_PLAIN_AR, warmup=1)
        t["plain_ms"] = time_ms(lambda: fr.split_rollout_plain(dyn, cost, X0c, U, DT),
                                N_TIMED_PLAIN_AR, warmup=1)
        t["library_ms"] = None
        times["B1-x0 split"] = t
    emit("split_x0_kernels", pair=pair, map=map_kind, K=K, T=T_,
         crashed_share=float(kcrash.float().mean()), checks=checks, times=times)
    return checks, times


# ---------------------------------------------------------------------------
# The warp form of the network pairs' split dynamics passes
# (csrc/split_warp.cuh): each pass against its plain version (Y, U and the
# LR sums bit for bit) at the path's shape and the ragged one, and A B B A
# against the one-thread pass it replaced: the same sources built with
# -DMPPI_SPLIT_ONE_THREAD into a directory of their own (build_one_thread;
# the port never loads that build). The launch counters name the form that
# each library reports (fr.form_kernel_name).
# ---------------------------------------------------------------------------
WARP_PAIRS = ("ar_nn", "racer_steering_ar", "racer_unc_ar")
# (the robust family's sources of the later pairs, csrc/robust_<pair>.cu,
# have no earlier form to time: their entries were new in the slice that
# redesigned nothing, and they stay out of the variant builds)
WARP_SOURCES = tuple(sorted({_build.pair_entry(p, k)[0] for p in WARP_PAIRS
                             for k in ("split_dynamics", "split_dynamics_x0")
                             if _build.pair_entry(p, k) is not None}
                            - {f"robust_{p}" for p in WARP_PAIRS}))
# the pairs whose B1 split dynamics pass runs the lane-group form
# (csrc/split_lanes.cuh); -DMPPI_SPLIT_ONE_THREAD builds their one-thread
# pass beside the warp pairs'
LANES_PAIRS = ("bicycle_ar",)
LANES_SOURCES = tuple(_build.pair_entry(p, "split_dynamics")[0] for p in LANES_PAIRS)
# the pairs whose split dynamics passes run the staged form
# (csrc/split_staged.cuh; the bicycle's B1 pass the lane-group form);
# -DMPPI_SPLIT_ONE_THREAD builds their one-thread passes beside the others
SPLIT_STAGED_PAIRS = ("di_circle", "di_quadratic", "cartpole", "quadrotor_quadratic",
                      "dubins_quadratic", "di_robust", "bicycle_ar")
SPLIT_KINDS = ("split_dynamics", "split_solve_dynamics", "split_dynamics_x0")
SPLIT_ONE_THREAD_SOURCES = tuple(sorted(
    set(WARP_SOURCES + LANES_SOURCES) | {_build.pair_entry(p, k)[0] for p in SPLIT_STAGED_PAIRS
                                          for k in SPLIT_KINDS
                                          if _build.pair_entry(p, k) is not None
                                          and not _build.pair_entry(p, k)[0].startswith(
                                              "robust_")}))
ONE_THREAD = {}  # {source: the loaded one-thread build}, from build_one_thread
# The one-thread rows of PERF.md §6 that the warp forms of B4 and B8 replace
# (no one-thread build of them is kept, so their times are not measured
# here): where each row stands, with the call it came from.
B4_ROW = "PERF.md §6, one-thread B4 row, call 3 of its slice"
ONE_THREAD_ROWS = {
    ("sample", "ar_nn"): B4_ROW,
    ("sample", "racer_steering_ar"): B4_ROW,
    ("sample", "racer_unc_ar"): B4_ROW,
    ("rmppi", "ar_nn"): "PERF.md §6, one-thread B8 row, call 5 of its slice",
}


def one_thread_fields(kind, pair):
    """The ``kernels`` line's fields of an entry's earlier form: the
    one-thread row a warp entry replaces, or the staged form of B4, B3, B1,
    B8 or a split dynamics pass timed A B B A against the one-thread kernel
    in this run, by mode (none for a one-thread entry)."""
    if earlier_form(pair, kind) is not None or (kind == "rmppi" and pair in B8_STAGED_PAIRS):
        return {"one_thread_abba": {m: {k: t.get(k) for k in (
            "ms", "other_ms", "abba_ms", "faster", "device")}
            for m, t in FORM_TIMES[(kind, pair)].items()}}
    row = ONE_THREAD_ROWS.get((kind, pair))
    if row is None or not split_name(pair, kind).endswith("_warp_kernel"):
        return {}
    return {"one_thread_row_from": row}


def ladder_fields(key):
    """The ``kernels`` line's fields of a B7 entry: its time A B B A against
    the one-thread ladder in this run (ladder_form_phase)."""
    t = FORM_TIMES[("ladder", key)]
    return {"one_thread_abba": {k: t[k] for k in ("ms", "other_ms", "abba_ms", "faster")}}


# the kernel family of each kind of entry with a warp or a staged form
FORM_BASE = {"split_dynamics": "split_dynamics", "split_dynamics_x0": "split_dynamics",
             "split_solve_dynamics": "split_solve_dynamics",
             "sample": "fused_sample_rollout", "rmppi": "rmppi_rollout",
             "solve": "fused_solve", "rollout": "rollout_costs", "rollout_x0": "rollout_costs"}


def split_name(pair, kind):
    """The counted name of the kernel that ``pair``'s entry ``kind`` (a split
    dynamics pass, B4, B8, B3 or B1) launches, as its library reports it."""
    return fr.form_kernel_name(FORM_BASE[kind], _build.pair_entry(pair, kind))


# the pairs whose cost is evaluated twice a step (a sticky crash:
# time_parallel_crash), which the split cost pass's form rule reads
DUAL_COST_PAIRS = ("ar_nn", "bicycle_ar", "racer_steering_ar", "racer_unc_ar")


def cost_kernel(pair, K, T_):
    """The counted name of the split cost pass that ``pair``'s entry
    launches for K samples over T_ steps on the card."""
    return fr.split_cost_kernel_name(_build.pair_entry(pair, "split_cost"), 0, K, T_,
                                     pair in DUAL_COST_PAIRS)


def b1_kernel(pair, x0=False):
    """The counted name of ``pair``'s B1 kernel (its per-sample-x0 entry's
    with ``x0``)."""
    return split_name(pair, "rollout_x0" if x0 else "rollout")


def b3_kernel(pair):
    """The counted name of ``pair``'s B3 kernel."""
    return split_name(pair, "solve")


def rollout_launches(pair, k, weights="exp"):
    """The launches of k solves of ``pair`` on kernel="fused" (B1 in the form
    its entry reports, and the merge; ``weights`` "tsallis": B5 between
    them): the warp form adds its epilogue pass (CARRY, or MIN_PASS for
    Tsallis pass 1)."""
    name = b1_kernel(pair)
    out = {name: k, MERGE: k}
    if weights == "tsallis":
        out[TSALLIS] = k
    if name == "rollout_costs_warp_kernel":
        out[MIN_PASS if weights == "tsallis" else CARRY] = k
    return out


def solve_launches(pair, k):
    """The launches of k fused solves of ``pair`` (B3 in the form its entry
    reports, and the merge): the warp form adds its carry pass (CARRY)."""
    name = b3_kernel(pair)
    out = {name: k, MERGE: k}
    if name == "fused_solve_warp_kernel":
        out[CARRY] = k
    return out


def sample_launches(pair, k, epilogue=False):
    """The launches of k B4 solves of ``pair`` in the form its entry reports:
    the sampling kernel, and with Smooth-MPPI's epilogue the merge and, in
    the warp form, its carry pass (CARRY)."""
    name = split_name(pair, "sample")
    out = {name: k}
    if epilogue:
        out[MERGE] = k
        if name == "fused_sample_rollout_warp_kernel":
            out[CARRY] = k
    return out


def device_ms(fn, name=None, n=N_TIMED_KERNEL):
    """The median device ms of the kernel whose name holds ``name`` (a tuple
    of names: those kernels, summed; every kernel of a run, summed, with no
    ``name``) over the last n of 2 n runs of ``fn`` (a launch sequence
    holding each named kernel once), from a
    torch.profiler window: device time alone, without the launches' gaps.
    The runs are parted by a host pause, which leaves a gap of a
    millisecond or more between them on the device's clock (``last_runs``).
    The first n runs warm the tracing up (a window opened late in a run
    missed the kernels of its first runs). A window whose last n runs are
    not whole (a host stall inside a run, or events the profiler dropped:
    seen once in about forty windows of a run) is taken again, up to three
    windows."""
    from torch.profiler import ProfilerActivity, profile

    names = (name,) if isinstance(name, str) else name
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * n):
                fn()
                torch.cuda.synchronize()
                time.sleep(0.002)
        seen = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and (names is None or any(m in e.name for m in names))),
                      key=lambda e: e.time_range.start)
        runs = last_runs(seen, n)
        if runs is not None and (names is None or len(runs[0]) == len(names)):
            us = [sum(e.time_range.elapsed_us() for e in r) for r in runs]
            return statistics.median(us) / 1e3
    raise AssertionError(f"the profiler saw {len(seen)} launches of "
                         f"{name or 'any kernel'} in {2 * n} runs, not {n} whole runs "
                         f"of one launch sequence at the end, in three windows")


def last_runs(seen, n):
    """The last n runs of a launch sequence among the device events ``seen``
    (sorted by start), or None. A synchronise and a host pause part the
    runs, so no gap-free stretch of the device's clock (gaps of a
    millisecond or more part the stretches) holds two runs; a host stall
    inside a run can split it in two. So the sequence is the longest
    stretch, m launches, and the last n runs are the last n m events, each
    beginning a stretch."""
    starts, end = [], None
    for e in seen:
        starts.append(end is None or e.time_range.start - end > 1000)  # microseconds
        end = max(end or 0, e.time_range.end)
    m = longest = 0
    for begins in starts:
        longest = 1 if begins else longest + 1
        m = max(m, longest)
    first = len(seen) - n * m
    if m == 0 or first < 0 or not all(starts[first + i * m] for i in range(n)):
        return None
    return [seen[first + i * m:first + (i + 1) * m] for i in range(n)]


# B7's, B4's, B3's and B1's earlier forms, kept buildable to time the new
# ones against them in one call: the ladder's one-thread recursion and
# forward passes (-DMPPI_LADDER_ONE_THREAD) and the one-thread B4, B3 and B1
# of the models without the warp form (-DMPPI_SAMPLE_ONE_THREAD,
# -DMPPI_SOLVE_ONE_THREAD, -DMPPI_ROLLOUT_ONE_THREAD, in one build of their
# pair sources; the staged per-sample-x0 entries of rollout_x0.cu are held
# against their plain versions only)
LADDER = "riccati_ladder_warp_kernel"  # B7 in the port's build (check_forms)
B4_STAGED = "fused_sample_rollout_staged_kernel"  # B4 of STAGED_PAIRS there
STAGED_PAIRS = ("di_circle", "di_quadratic", "di_robust", "cartpole", "quadrotor_quadratic",
                "quadrotor_map", "dubins_quadratic", "bicycle_ar")
STAGED_SOURCES = tuple(sorted({_build.pair_entry(p, "sample")[0] for p in STAGED_PAIRS}))
# B8 of the pairs without the warp form runs the staged form
# (csrc/rmppi_staged.cuh); -DMPPI_RMPPI_ONE_THREAD builds the one-thread
# kernel beside the one-thread B4, B3 and B1
B8_STAGED_PAIRS = ("di_circle", "di_robust")
# the pairs without the warp form whose B8 launches its one-thread form
# (rmppi_form): a sticky crash (the AutoRally costs on the bicycle), or two
# stages past 227 KB of shared memory (the quadrotor's 13 states, 4 controls)
ONE_THREAD_B8_PAIRS = ("bicycle_ar", "quadrotor_quadratic", "quadrotor_map")
B8_SOURCE = "rmppi_rollout"
LADDER_ONE_THREAD = {}  # {"riccati": the loaded one-thread ladder build}
SAMPLE_ONE_THREAD = {}  # {source: the loaded one-thread B4, B3, B1 and B8 build}
MERGE = "flash_combine_tiled_kernel"  # the merge in the port's build (check_forms)
COST = "split_cost_cluster_kernel"  # the split cost pass there
TSALLIS = "tsallis_reduce_tiled_kernel"  # the Tsallis reduction there
# the merge's, the split cost pass's and the Tsallis reduction's earlier forms
# (one block of 256 threads for the merge, one block of 512 a 64-sample
# block for the cost pass, one block of 256 a 64-sample block for the
# Tsallis reduction): their sources, the split sources being those of the
# pairs whose cost pass AUTO or the flagship's split loop takes
EARLIER_DEFINES = ("MPPI_COMBINE_ONE_BLOCK", "MPPI_COST_ONE_BLOCK", "MPPI_TSALLIS_ONE_BLOCK")
EARLIER_SOURCES = ("flash_combine", "split_ar_nn", "split_bicycle_ar", "split_di_circle",
                   "split_racer_steering_ar", "split_racer_unc_ar", "split_quadrotor_quadratic",
                   "split_di_robust", "tsallis_reduce")
EARLIER = {}  # {source: the loaded earlier-form build}
# the passes after the warp forms (csrc/block_pass.cuh) and B6 in the port's
# build (check_forms); -DMPPI_PASS_UNSTAGED builds their earlier kernels
# (block_carry_kernel, block_min_kernel) over the merge's library, which
# launches the passes alone, and one network pair source for each warp entry
# that launches them (AutoRally's B1 and B3; its B4), and
# -DMPPI_BACKWARD_ONE_THREAD the one-thread B6 beside the one-thread ladder
CARRY = "block_carry_tiled_kernel"
MIN_PASS = "block_min_warp_kernel"
BACKWARD = "riccati_backward_warp_kernel"
PASS_UNSTAGED_SOURCES = ("flash_combine", _build.pair_entry("ar_nn", "solve")[0],
                         _build.pair_entry("ar_nn", "sample")[0])
PASS_UNSTAGED = {}  # {source: the loaded build with the earlier passes}
# the network pairs' combined B3 and B1 run the warp form
# (csrc/sample_warp.cuh, csrc/rollout_kernel.cuh); -DMPPI_SOLVE_ONE_THREAD
# -DMPPI_ROLLOUT_ONE_THREAD builds their one-thread B3 and B1 from the same
# sources, and the one-thread B1 from one x0 per sample from rollout_x0.cu
# (AutoRally's, and there also the DI's and the bicycle's)
WARP_SOLVE_SOURCES = tuple(_build.pair_entry(p, "solve")[0] for p in WARP_PAIRS) + (
    _build.pair_entry("ar_nn", "rollout_x0")[0],)
SOLVE_ONE_THREAD = {}  # {source: the loaded one-thread B3 and B1 build of a network pair}
# (libraries it fills, -D flags, build directory, sources)
VARIANTS = ((ONE_THREAD, ("MPPI_SPLIT_ONE_THREAD",), "one_thread", SPLIT_ONE_THREAD_SOURCES),
            (LADDER_ONE_THREAD, ("MPPI_LADDER_ONE_THREAD", "MPPI_BACKWARD_ONE_THREAD"),
             "ladder_one_thread", ("riccati",)),
            (SAMPLE_ONE_THREAD, ("MPPI_SAMPLE_ONE_THREAD", "MPPI_SOLVE_ONE_THREAD",
                                 "MPPI_ROLLOUT_ONE_THREAD", "MPPI_RMPPI_ONE_THREAD"),
             "sample_one_thread", STAGED_SOURCES + (B8_SOURCE,)),
            (SOLVE_ONE_THREAD, ("MPPI_SOLVE_ONE_THREAD", "MPPI_ROLLOUT_ONE_THREAD"),
             "solve_one_thread", WARP_SOLVE_SOURCES),
            (EARLIER, EARLIER_DEFINES, "earlier_forms", EARLIER_SOURCES),
            (PASS_UNSTAGED, ("MPPI_PASS_UNSTAGED",), "pass_unstaged", PASS_UNSTAGED_SOURCES))


def build_one_thread():
    """Build the VARIANTS: the split sources of the warp, lane and staged
    pairs (SPLIT_ONE_THREAD_SOURCES) with -DMPPI_SPLIT_ONE_THREAD (every
    model's split passes one thread a sample), riccati.cu with
    -DMPPI_LADDER_ONE_THREAD and -DMPPI_BACKWARD_ONE_THREAD, the staged
    pairs' sources and rmppi_rollout.cu with -DMPPI_SAMPLE_ONE_THREAD,
    -DMPPI_SOLVE_ONE_THREAD, -DMPPI_ROLLOUT_ONE_THREAD and
    -DMPPI_RMPPI_ONE_THREAD, the network pairs' sources and rollout_x0.cu
    with -DMPPI_SOLVE_ONE_THREAD and -DMPPI_ROLLOUT_ONE_THREAD,
    EARLIER_SOURCES with EARLIER_DEFINES and PASS_UNSTAGED_SOURCES with
    -DMPPI_PASS_UNSTAGED (build_variants)."""
    return build_variants(VARIANTS)


def build_variants(variants, csrc=_build.CSRC):
    """Build each (libraries, -D flags, build directory, sources) of
    ``variants`` from the sources in ``csrc`` (the port's by default), one
    nvcc per source, all started together, and load them into their dicts.
    Each is compiled as a unit of another name that includes the source, so
    that its kernels' symbols (nvcc names a source's anonymous namespace
    after its file) differ from those of the port's build loaded beside it.
    Returns {"<directory>/<source>": nvcc's log}."""
    procs = {}
    for libs, defines, tag, sources in variants:
        out = _build.BUILD_ROOT / tag
        out.mkdir(parents=True, exist_ok=True)
        for name in sources:
            unit = out / f"{name}_{tag}.cu"
            unit.write_text(f'#include "{name}.cu"\n')
            procs[f"{tag}/{name}"] = (libs, name, out / f"lib{name}.so", subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I",
                 str(csrc), "-o", str(out / f"lib{name}.so"), str(unit)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {key: proc.communicate()[0] for key, (_, _, _, proc) in procs.items()}
    for key, (libs, name, path, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"build {key} failed:\n{logs[key]}")
        libs[name] = _build.declare(ctypes.CDLL(str(path)), name)
    return logs


@contextlib.contextmanager
def swapped(libs=None, ladder=None):
    """Inside, the wrappers take the libraries of ``libs`` ({source: loaded
    build}) and the ladder ``ladder`` (a loaded build of riccati.cu) in place
    of the port's (their launches then run those builds' kernels)."""
    lib, ric = fr._lib, riccati._lib
    if libs:
        fr._lib = lambda name="flash_combine": libs[name] if name in libs else lib(name)
    if ladder is not None:
        riccati._lib = lambda: ladder
    try:
        yield
    finally:
        fr._lib, riccati._lib = lib, ric


def one_thread_split():
    """Inside, the wrappers take the warp, lane and staged pairs' split
    libraries from the one-thread build (their launches then run the
    one-thread passes)."""
    return swapped(ONE_THREAD)


def one_thread_ladder():
    """Inside, the ladder and B6 wrappers launch the one-thread ladder and
    the one-thread B6."""
    return swapped(ladder=LADDER_ONE_THREAD["riccati"])


def unstaged_passes():
    """Inside, the passes alone and AutoRally's B1, B3 and B4 launch the
    earlier passes (block_carry_kernel, block_min_kernel) after their warp
    kernels."""
    return swapped(PASS_UNSTAGED)


def one_thread_sample():
    """Inside, the staged pairs' B4, B3 and B1 (one x0) and B8 of
    B8_STAGED_PAIRS launch the one-thread kernels."""
    return swapped(SAMPLE_ONE_THREAD)


def earlier_forms():
    """Inside, the merge, the split cost pass of EARLIER_SOURCES and the
    Tsallis reduction launch their earlier one-block kernels."""
    return swapped(EARLIER)


def one_thread_solve():
    """Inside, the network pairs' B3 and B1 (one x0 and one per sample)
    launch the one-thread kernels."""
    return swapped(SOLVE_ONE_THREAD)


def earlier_form(pair, kind):
    """The context in which ``pair``'s entry ``kind`` launches the form its
    redesign replaced (the one-thread kernel), or None: B4, B3 and B1 of
    the staged pairs, B3 and B1 (one x0 and one per sample) of the network
    pairs, the staged split dynamics passes (the lane-group pass is timed
    apart: ``turns``)."""
    entry = _build.pair_entry(pair, kind)
    if entry is None:
        return None
    if (pair in STAGED_PAIRS and kind in ("sample", "solve", "rollout")
            and entry[0] in STAGED_SOURCES):
        return one_thread_sample
    if (pair in SPLIT_STAGED_PAIRS and kind in SPLIT_KINDS
            and not (pair in LANES_PAIRS and kind == "split_dynamics")
            and entry[0] in SPLIT_ONE_THREAD_SOURCES):
        return one_thread_split
    if (pair in WARP_PAIRS and kind in ("solve", "rollout", "rollout_x0")
            and entry[0] in WARP_SOLVE_SOURCES):
        return one_thread_solve
    return None


def check_forms():
    """Each warp pair's split dynamics entries report the warp form in the
    port's build and the one-thread form in build_one_thread's, each lane
    pair's B1 split dynamics entry the lane-group form and the one-thread
    form, each other split dynamics entry of SPLIT_STAGED_PAIRS the staged
    form and the one-thread form; each B4 and B8 entry the warp form for a
    warp pair, else the staged form (the one-thread kernel in the one-thread
    build);
    each B3 and B1 entry (one x0 or one per sample) the staged form for a
    staged pair (the one-thread kernel in the one-thread build), else the
    warp form (the one-thread kernel in the network pairs' one-thread
    build); the ladder the warp recursion and B6 the warp form (the one-thread
    kernels in their one-thread build); every library's passes after the
    warp forms the tiled carry and warp minima passes (the earlier kernels in
    PASS_UNSTAGED's build); the merge, the split cost
    pass and the Tsallis reduction their new forms (their one-block kernels
    in the earlier forms' build)."""
    for pair in WARP_PAIRS:
        for kind in ("split_dynamics", "split_solve_dynamics", "split_dynamics_x0"):
            if _build.pair_entry(pair, kind) is None:
                continue
            if _build.pair_entry(pair, kind)[0] not in SPLIT_ONE_THREAD_SOURCES:
                if not split_name(pair, kind).endswith("_warp_kernel"):
                    raise AssertionError(f"{pair} {kind}: reports {split_name(pair, kind)}")
                continue
            warp, one = split_name(pair, kind), None
            with one_thread_split():
                one = split_name(pair, kind)
            if not (warp.endswith("_warp_kernel") and not one.endswith("_warp_kernel")):
                raise AssertionError(f"{pair} {kind}: the builds report {warp} and {one}")
    for pair in LANES_PAIRS:
        lanes = split_name(pair, "split_dynamics")
        with one_thread_split():
            one = split_name(pair, "split_dynamics")
        if (lanes, one) != ("split_dynamics_lanes_kernel", "split_dynamics_kernel"):
            raise AssertionError(f"{pair} split_dynamics: the builds report {lanes} and {one}")
    for pair in SPLIT_STAGED_PAIRS:
        for kind in SPLIT_KINDS:
            if _build.pair_entry(pair, kind) is None or earlier_form(pair, kind) is None:
                continue
            staged = split_name(pair, kind)
            with one_thread_split():
                one = split_name(pair, kind)
            base = FORM_BASE[kind]
            if (staged, one) != (base + "_staged_kernel", base + "_kernel"):
                raise AssertionError(f"{pair} {kind}: the builds report {staged} and {one}")
    for pair in _build.PAIR_KERNELS:
        for kind, base in (("sample", "fused_sample_rollout"), ("rmppi", "rmppi_rollout")):
            if _build.pair_entry(pair, kind) is None:
                continue
            warp = pair in WARP_PAIRS + FAMILY_WARP_PAIRS
            want = f"{base}_warp_kernel" if warp else f"{base}_staged_kernel"
            if kind == "rmppi" and pair in ONE_THREAD_B8_PAIRS:
                want = f"{base}_kernel"  # B8's one-thread form
            if split_name(pair, kind) != want:
                raise AssertionError(f"{pair} {kind}: reports {split_name(pair, kind)}, "
                                     f"expected {want}")
    for pair in B8_STAGED_PAIRS:
        with one_thread_sample():
            one = split_name(pair, "rmppi")
        if one != "rmppi_rollout_kernel":
            raise AssertionError(f"{pair}: the one-thread B8 build reports {one}")
    for pair in _build.PAIR_KERNELS:
        for kind in ("solve", "rollout", "rollout_x0"):
            if _build.pair_entry(pair, kind) is None:
                continue
            base = FORM_BASE[kind]
            staged = pair in STAGED_PAIRS + FAMILY_STAGED_PAIRS
            want = base + ("_staged_kernel" if staged else "_warp_kernel")
            if split_name(pair, kind) != want:
                raise AssertionError(f"{pair} {kind}: reports {split_name(pair, kind)}, "
                                     f"expected {want}")
    for pair in WARP_PAIRS:
        for kind in ("solve", "rollout", "rollout_x0"):
            if earlier_form(pair, kind) is None:
                continue
            with one_thread_solve():
                one = split_name(pair, kind)
            if one != FORM_BASE[kind] + "_kernel":
                raise AssertionError(f"{pair}: the one-thread {kind} build reports {one}")
    for pair in STAGED_PAIRS:
        for kind in ("sample", "solve", "rollout"):
            if _build.pair_entry(pair, kind) is None:
                continue
            with one_thread_sample():
                one = split_name(pair, kind)
            if one != FORM_BASE[kind] + "_kernel":
                raise AssertionError(f"{pair}: the one-thread {kind} build reports {one}")
    with one_thread_ladder():
        one = riccati.ladder_kernel_name()
    if (riccati.ladder_kernel_name(), one) != (LADDER, "riccati_ladder_kernel"):
        raise AssertionError(f"the ladder builds report {riccati.ladder_kernel_name()}, {one}")
    with one_thread_ladder():
        one = riccati.backward_kernel_name()
    if (riccati.backward_kernel_name(), one) != (BACKWARD, "riccati_backward_kernel"):
        raise AssertionError(f"the B6 builds report {riccati.backward_kernel_name()}, {one}")
    libs = {_build.pair_entry(p, k)[0] for p in _build.PAIR_KERNELS
            for k in _build._PASS_KINDS if _build.pair_entry(p, k)}
    for lib in sorted(libs | {"flash_combine"}):
        got = (fr.pass_kernel_name("block_carry", lib), fr.pass_kernel_name("block_min", lib))
        if got != (CARRY, MIN_PASS):
            raise AssertionError(f"{lib}: its passes build reports {got}")
        if lib in PASS_UNSTAGED_SOURCES:
            with unstaged_passes():
                got = (fr.pass_kernel_name("block_carry", lib),
                       fr.pass_kernel_name("block_min", lib))
            if got != ("block_carry_kernel", "block_min_kernel"):
                raise AssertionError(f"{lib}: the earlier passes build reports {got}")
    with earlier_forms():
        one = fr.merge_kernel_name()
    if (fr.merge_kernel_name(), one) != (MERGE, "flash_combine_kernel"):
        raise AssertionError(f"the merge builds report {fr.merge_kernel_name()}, {one}")
    with earlier_forms():
        one = fr.tsallis_kernel_name()
    if (fr.tsallis_kernel_name(), one) != (TSALLIS, "tsallis_reduce_kernel"):
        raise AssertionError(f"the Tsallis builds report {fr.tsallis_kernel_name()}, {one}")
    for pair in _build.PAIR_KERNELS:
        if _build.pair_entry(pair, "split_cost") is None:
            continue
        # the port's build has the cluster form beside the one-block form,
        # the earlier build the one-block form alone
        entry = _build.pair_entry(pair, "split_cost")
        form = fr.form_kernel_name("split_cost", entry)
        if form != COST:
            raise AssertionError(f"{pair}: its cost pass build reports {form}")
        if entry[0] in EARLIER_SOURCES:
            with earlier_forms():
                one = fr.form_kernel_name("split_cost", entry)
            if one != "split_cost_kernel":
                raise AssertionError(f"{pair}: the earlier cost pass build reports {one}")


def abba_against(fn, other):
    """``fn`` timed in turns on the builds of the context ``other`` (A) and
    the port's (B): A B B A (CUDA events, medians of N_TIMED)."""
    with other():
        a1 = time_ms(fn, N_TIMED)
    b1, b2 = time_ms(fn, N_TIMED), time_ms(fn, N_TIMED)
    with other():
        a2 = time_ms(fn, N_TIMED)
    return {"ms": (b1 + b2) / 2, "other_ms": (a1 + a2) / 2, "abba_ms": [a1, b1, b2, a2],
            "faster": max(b1, b2) < min(a1, a2)}


FORM_TIMES = {}  # {("ladder" | "sample" | "solve" | "rollout" | a split kind, key):
#                  A B B A against the earlier form}


def form_time(fn, pair, kind, mode, at_path=True):
    """The ms of ``fn``, a launch of ``pair``'s B3 (kind "solve"), B1
    ("rollout", "rollout_x0") or split dynamics (SPLIT_KINDS) entry: at its
    path's shape (``at_path``), where the entry runs a redesigned form
    (``earlier_form``: the staged form, or the network pairs' warp forms of
    B3 and B1), A B B A against the one-thread build (kept in
    FORM_TIMES[(kind, pair)][mode] for the kernels line; the warp B3's also
    by the profiler's device time, its carry pass included;
    ``scripts/torch_network_rollout_abba.py`` has the warp B1's), else CUDA
    events alone. The A B B A takes the place of the single timing, so no
    entry is timed twice."""
    other = earlier_form(pair, kind)
    if not at_path or other is None:
        return time_ms(fn, N_TIMED)
    t = abba_against(fn, other)
    if other is one_thread_solve and kind == "solve":
        t["device"] = device_abba(fn, ("fused_solve_warp_kernel", CARRY),
                                  "fused_solve_kernel", other)
    FORM_TIMES.setdefault((kind, pair), {})[mode] = t
    return t["ms"]


def same_as_one_thread(what, fn, out, pair, kind):
    """Where ``pair``'s entry ``kind`` runs a redesigned form
    (``earlier_form``): ``fn`` (a B3 or B1 launch from one x0) on the
    one-thread build returns ``out``, the port's outputs, bit for bit."""
    other = earlier_form(pair, kind)
    if other is None:
        return
    with other():
        one = fn()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(out, one)):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} of the one-thread build differs")


def same_as_one_thread_b8(what, args, out):
    """B8 (``args`` of fused_rmppi_rollout, a pair of B8_STAGED_PAIRS) on the
    one-thread build returns ``out``, the port's outputs, bit for bit."""
    with one_thread_sample():
        one = fr.fused_rmppi_rollout(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("s_nom", "j_real", "s_fb", "crash", "U_real"), out, one):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} of the one-thread build differs")


def b8_form_time(pair, mode, fn):
    """The ms of ``fn``, a launch of ``pair``'s B8 entry at a loop's shape,
    A B B A against the one-thread build (kept in FORM_TIMES[("rmppi",
    pair)][mode] for the kernels line)."""
    t = abba_against(fn, one_thread_sample)
    FORM_TIMES.setdefault(("rmppi", pair), {})[mode] = t
    return dict(t)


# the merge at each shape a path launches it at: (label, carry rows, T, C,
# Tsallis rows merged with their sum num)
MERGE_SHAPES = (
    ("DI K=8192 T=100", 128, T, C, False),
    ("K=1920 T=150 (AutoRally, racer uncertainty)", 30, T_AR, C, False),
    ("DI K=8192 T=100, Tsallis rows with num", 128, T, C, True),
    ("K=1920 T=100 (racer steering, bicycle)", 30, T_BI, C, False),
    ("quadrotor K=8192 T=100", 128, T_ZOO, 4, False),
    ("cartpole K=8192 T=100", 128, T_ZOO, 1, False),
    ("K=2560 T=50 (RMPPI, Tube)", 40, T_R, C, False),
    ("K=1024 T=100", 16, T, C, False),
    ("quadrotor hover K=512 T=48", 8, 48, 4, False),
)
# the split cost pass at the shapes of AUTO's split paths and of the
# flagship's split loop: (label, pair, mode); "solve" is B3's (its LR sums),
# "x0" RMPPI's stage 1 on AutoRally (ARRobustCost, 9 candidates x 256)
COST_SHAPES = (
    ("AutoRally B1 epilogue+lr", "ar_nn", "epilogue+lr"),
    ("AutoRally B3", "ar_nn", "solve"),
    ("AutoRally x0 (ARRobustCost, 9 x 256)", "ar_nn", "x0"),
    ("racer steering B1 epilogue+lr", "racer_steering_ar", "epilogue+lr"),
    ("racer steering B3", "racer_steering_ar", "solve"),
    ("racer uncertainty B1 epilogue+lr", "racer_unc_ar", "epilogue+lr"),
    ("racer uncertainty B3", "racer_unc_ar", "solve"),
    ("bicycle B1 epilogue+lr", "bicycle_ar", "epilogue+lr"),
    ("DI B1 epilogue+lr", "di_circle", "epilogue+lr"),
    ("quadrotor hover B1 epilogue+lr (K=512 T=48)", "quadrotor_quadratic", "epilogue+lr"),
    ("DI robust x0 (9 x 64, T=48)", "di_robust", "x0"),
)
PROFILED_SHAPES = 2  # the first shapes of each kernel, A B B A by the profiler too
EARLIER_TIMES = {}  # {("merge" | "cost", label): A B B A against the earlier form}


def device_abba(fn, name, other_name, other):
    """``fn`` timed in turns by the profiler's device time (device_ms) on
    the builds of the context ``other`` (A, kernel ``other_name``) and the
    port's (B, kernel ``name``): A B B A."""
    with other():
        a1 = device_ms(fn, other_name)
    b1, b2 = device_ms(fn, name), device_ms(fn, name)
    with other():
        a2 = device_ms(fn, other_name)
    return {"ms": (b1 + b2) / 2, "other_ms": (a1 + a2) / 2, "abba_ms": [a1, b1, b2, a2],
            "faster": max(b1, b2) < min(a1, a2)}


def same_bits(what, got, want):
    """Each output of the port's build equal to the earlier build's bit for
    bit (NaN where it is NaN)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None and b is None:
            continue
        if not (torch.equal(a, b) or (torch.equal(a.isnan(), b.isnan())
                                      and torch.equal(a.nan_to_num(), b.nan_to_num()))):
            raise AssertionError(f"{what}: output {i} differs from the earlier form's")


def merge_rows(nb, TC, tsallis, g, dev):
    """nb carry rows of 2 + TC floats: m_b ~ 3 N(0, 1) (0 for Tsallis
    rows), d_b in [1, 64], num_b ~ d_b N(0, 1)."""
    m = torch.zeros((nb, 1), device=dev)
    if not tsallis:
        m = 3.0 * torch.randn((nb, 1), generator=g, device=dev)
    d = 1.0 + 63.0 * torch.rand((nb, 1), generator=g, device=dev)
    num = d * torch.randn((nb, TC), generator=g, device=dev)
    return torch.cat([m, d, num], dim=1).contiguous()


def cost_case(dev, pair, mode):
    """(dynamics, cost, U, Y (T, O, K), B1's LR tables, B3's LR sums, K, T)
    of one cost-pass shape: the split phases' inputs at the path's shape
    (the hover's K and T for the quadrotor; RMPPI's stage-1 candidates for
    "x0": AutoRally with ARRobustCost, the DI robust cost), Y from the
    port's dynamics pass."""
    if mode == "x0":
        if pair == "di_robust":
            dyn, cost = (DoubleIntegratorDynamics.create(device=dev),
                         DoubleIntegratorRobustCost(device=dev))
            xa, dx, n_per, T_, std = (torch.tensor(X0_RDI, device=dev),
                                      torch.tensor([0.3, 0.1, 0.4, -0.3], device=dev),
                                      S_PER_RDI, T_RDI, [1.0, 1.0])
        else:
            dyn, cost = robust_ar_parts("128", dev)
            xa, dx, n_per, T_, std = (ar_x0(dev),
                                      torch.tensor([0.5, 0.3, 0.1, 0.0, -0.5, 0.0, 0.0],
                                                   device=dev), S_PER_AR, T_AR, AR_STD)
        w = torch.linspace(0.0, 1.0, N_CAND_AR, device=dev)[:, None]
        x0 = (xa[None] + w * dx[None]).repeat_interleave(n_per, dim=0).contiguous()
        K = x0.shape[0]
        g = torch.Generator(device=dev).manual_seed(411)
        U = torch.tensor([std], device=dev) * torch.randn((K, T_, C), generator=g, device=dev)
        U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
        lr = None
    else:
        K = {"di_circle": K_MAIN, "quadrotor_quadratic": K_HOVER}.get(pair, pair_shape(pair)[0])
        dyn, cost, x0, _, U, lr, _, T_ = split_inputs(dev, pair, K, 0.0, 0, 421,
                                                      "128" if pair == "ar_nn" else None)
        lr = lr if mode.endswith("+lr") else None
        if pair == "quadrotor_quadratic":  # the hover's horizon: the first steps
            T_ = T_HOVER
            U = U[:, :T_].contiguous()
            lr = lr and (lr[0][:T_].contiguous(), lr[1][:T_].contiguous(), *lr[2:])
    lr_sum = None
    if mode == "solve":
        g = torch.Generator(device=dev).manual_seed(431)
        lr_sum = 0.1 * torch.randn((K,), generator=g, device=dev)
    Y = fr.split_dynamics_cuda(dyn, cost, x0, U, DT)
    return dyn, cost, U, Y, lr, lr_sum, K, T_


def plain_cost_pass(cost, Y, U, lr, lr_sum, gain, T_):
    """The plain cost pass on the outputs Y (T, O, K): (costs, crash)."""
    Yk = Y.permute(2, 0, 1)
    acc, crash = fr.split_sums_plain(*fr.split_step_values_plain(cost, Yk, U, lr))
    acc = acc + cost.terminal_cost(Yk[:, -1].T)
    if lr_sum is not None:
        acc = acc + gain * lr_sum
    return true_div(acc, T_), crash


def merge_cost_forms_phase(dev):
    """The tiled merge and the cluster cost pass at every shape of
    MERGE_SHAPES and COST_SHAPES: every output bit for bit against the
    earlier forms' build (EARLIER), the merge against its plain version
    (new mean, eta), the cost pass's costs and crash flags bit for bit and
    its carry rows within rtol 1e-5 against the plain cost pass; each timed
    A B B A against the earlier form by CUDA events (and, for the first
    PROFILED_SHAPES of each, by the profiler's device time), beside its
    bound and its plain version's time. Returns the checks."""
    checks = []
    g = torch.Generator(device=dev).manual_seed(401)

    def timed(kind, label, fn, plain, i, name, other_name, work, **shape):
        t = abba_against(fn, earlier_forms)
        if i < PROFILED_SHAPES:
            t["device"] = device_abba(fn, name, other_name, earlier_forms)
        t["plain_ms"] = time_ms(plain, N_TIMED_PLAIN, warmup=1)
        t["bound_ms"], t["bound_by"] = bound_ms(*work)
        EARLIER_TIMES[(kind, label)] = {**t, **shape}

    for i, (label, nb, T_, C_, tsallis) in enumerate(MERGE_SHAPES):
        carry = merge_rows(nb, T_ * C_, tsallis, g, dev)
        lam = 1.0 if tsallis else LAM
        fn = lambda: fr.flash_combine(carry, T_, C_, lam, with_num=tsallis)  # noqa: E731
        got = fn()
        with earlier_forms():
            one = fn()
        want = fr.flash_combine_plain(carry, T_, C_, fr._f32(lam), with_num=tsallis)
        torch.cuda.synchronize()
        same_bits(f"merge {label}", got, one)
        checks += [check(f"merge {label} new_mean", got[0], want[0], "new_mean"),
                   check(f"merge {label} eta", got[2], want[2], "eta")]
        timed("merge", label, fn,
              lambda: fr.flash_combine_plain(carry, T_, C_, fr._f32(lam), with_num=tsallis),
              i, MERGE, "flash_combine_kernel", combine_work(nb, T_, C_), rows=nb, T=T_, C=C_)
    gain = fr._lr_gain(LAM, ALPHA)
    for i, (label, pair, mode) in enumerate(COST_SHAPES):
        dyn, cost, U, Y, lr, lr_sum, K, T_ = cost_case(dev, pair, mode)
        epi = fr.EPI_NONE if mode == "x0" else fr.EPI_EXP
        g_sum = gain if lr_sum is not None else 0.0
        fn = lambda: fr.split_cost_cuda(dyn, cost, Y, U, lr, epi, LAM, lr_sum, g_sum)  # noqa: E731
        got = fn()
        with earlier_forms():
            one = fn()
        pc, pcrash = plain_cost_pass(cost, Y, U, lr, lr_sum, g_sum, T_)
        torch.cuda.synchronize()
        same_bits(f"cost pass {label}", got, one)
        same(f"cost pass {label} crash flags", got[1], pcrash)
        checks.append(check(f"cost pass {label} costs", got[0], pc, "bitwise"))
        if epi == fr.EPI_EXP:
            checks.append(check(f"cost pass {label} carry", got[2],
                                fr.block_carries_plain(pc, U, LAM), "carry",
                                fr.block_carries_plain(pc, U.abs(), LAM).abs()))
        timed("cost", label, fn,
              lambda: plain_cost_pass(cost, Y, U, lr, lr_sum, g_sum, T_), i, COST,
              "split_cost_kernel",
              split_pass_work(pair, dyn, cost, K, T_, "cost", "costs" if mode == "x0" else mode),
              pair=pair, K=K, T=T_, crashed_share=float(pcrash.float().mean()))
    emit("merge_cost_forms", checks=checks,
         times={f"{kind} {label}": t for (kind, label), t in EARLIER_TIMES.items()})
    return checks


def earlier_fields(kind, pair=None):
    """The kernels line's fields of the merge (``kind`` "merge") or of
    ``pair``'s cost pass ("cost"): each shape's time A B B A against the
    earlier form in this run (merge_cost_forms_phase) with its bound and
    its plain version's time."""
    return {"earlier_form_abba": {label: t for (k, label), t in EARLIER_TIMES.items()
                                  if k == kind and t.get("pair") == pair}}


# the carry pass alone at the shapes the paths launch it at (AutoRally and
# racer uncertainty, racer steering) and the ragged loops' (T = 31: rows
# not on 16 bytes): (label, K, T, C, timed)
CARRY_SHAPES = (("K=1920 T=150 (AutoRally, racer uncertainty)", K_AR, T_AR, C, True),
                ("K=1920 T=100 (racer steering)", K_RC, T_RACER["racer_steering_ar"], C, True),
                ("K=1901 T=31 (the ragged loops)", K_RC_RAGGED + 1, RACER_RAGGED_T, C, False))
PASS_TIMES = {}  # {("carry" | "min" | "backward", label): A B B A against the earlier form}


def pass_fields(kind, prefix=""):
    """The kernels line's fields of the carry pass (``kind`` "carry"), the
    minima pass ("min") or B6 ("backward", ``prefix`` its sizes): each
    shape's time A B B A against the earlier form in this run (pass_forms_phase:
    the passes' alone and with the warp kernel before them; backward_forms:
    B6 on the linearisations of riccati_phase and robust_kernel_phase)."""
    return {"earlier_form_abba": {label: t for (k, label), t in PASS_TIMES.items()
                                  if k == kind and label.startswith(prefix)}}


def pass_forms_phase(dev):
    """The tiled carry pass and the warp minima pass against their plain
    versions and their earlier build (-DMPPI_PASS_UNSTAGED) bit for bit,
    and timed A B B A against it: each pass alone on costs and X already on
    the device (nothing before it to overlap) by the profiler's device time
    at the paths' shapes; AutoRally's warp B3, B1 (epilogue + LR; Tsallis +
    LR) and B4 (Smooth's epilogue) with their pass by CUDA events, the pair
    the paths launch."""
    g = torch.Generator(device=dev).manual_seed(501)
    checks, times = [], {}
    for label, K, T_, C_, timed_pass in CARRY_SHAPES:
        costs = 50.0 * torch.rand((K,), generator=g, device=dev) + 10.0
        X = torch.randn((K, T_, C_), generator=g, device=dev)
        kout = fr._block_carries(costs, X, LAM)
        with unstaged_passes():
            oout = fr._block_carries(costs, X, LAM)
        pout = fr.block_carries_ordered(costs, X, fr._f32(LAM))
        torch.cuda.synchronize()
        checks.append(check(f"carry pass {label}", kout, pout, "bitwise"))
        same_bits(f"carry pass {label}", (kout,), (oout,))
        if timed_pass:
            fn = lambda costs=costs, X=X: fr._block_carries(costs, X, LAM)  # noqa: E731
            t = device_abba(fn, CARRY, "block_carry_kernel", unstaged_passes)
            t["events"] = abba_against(fn, unstaged_passes)
            t["bound_ms"], t["bound_by"] = bound_ms(*carry_pass_work(K, T_, C_))
            times[f"carry {label}"] = PASS_TIMES[("carry", f"alone {label}")] = t
    costs = 50.0 * torch.rand((K_AR,), generator=g, device=dev) + 10.0
    kout = fr._block_minima(costs)
    with unstaged_passes():
        oout = fr._block_minima(costs)
    torch.cuda.synchronize()
    checks.append(check(f"minima pass K={K_AR}", kout, fr.block_minima_plain(costs), "bitwise"))
    same_bits(f"minima pass K={K_AR}", (kout,), (oout,))
    t = device_abba(lambda: fr._block_minima(costs), MIN_PASS, "block_min_kernel",
                    unstaged_passes)
    t["library_ms"] = device_ms(lambda: costs.view(-1, fr.BLOCK).amin(1))
    t["bound_ms"], t["bound_by"] = bound_ms(*min_pass_work(K_AR))
    times[f"min K={K_AR}"] = PASS_TIMES[("min", f"alone K={K_AR}")] = t

    # the pairs the paths launch: the warp kernel, then its pass
    dyn, cost, x0, std, _, T_ = pair_parts("ar_nn", dev)
    mean = 0.2 * torch.randn((T_, C), generator=g, device=dev)
    dmean = 0.3 * torch.randn((T_, C), generator=g, device=dev)
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    gauss, smooth = zoo_sampler("gaussian", C, std, dev, 0.0, T_), zoo_sampler(
        "smooth", C, std, dev, 0.0, T_)
    U, _ = gauss.sample(g, mean, K_AR)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    lr = (mean, gauss._sigma(T_, 0).contiguous(), gauss.control_cost_coeff, LAM, ALPHA,
          gauss.pure_threshold(K_AR))
    pairs = {
        "carry": {
            "AutoRally B3 + carry pass": lambda: fused_solve.fused_solve_carries(
                dyn, cost, gauss, x0, mean, seed_t, DT, LAM, ALPHA, K_AR, split_cost=False),
            "AutoRally B1 epilogue+lr + carry pass": lambda: fr.rollout_block_carries(
                dyn, cost, x0, U, DT, LAM, lr, split_cost=False),
            "AutoRally B4 smooth epilogue + carry pass": lambda: fr._sample_rollout_cuda(
                dyn, cost, smooth, fr.noise_kind(smooth), x0, mean, seed_t, DT, LAM, ALPHA,
                K_AR, 0, 0, dmean, True, False, None)},
        "min": {
            "AutoRally B1 tsallis+lr + minima pass": lambda: fr.rollout_block_minima(
                dyn, cost, x0, U, DT, lr, split_cost=False)},
    }
    for kind, fns in pairs.items():
        for label, fn in fns.items():
            out = fn()
            with unstaged_passes():
                one = fn()
            torch.cuda.synchronize()
            same_bits(label, out, one)
            t = abba_against(fn, unstaged_passes)
            times[label] = PASS_TIMES[(kind, f"pair {label}")] = t

    emit("pass_forms", checks=checks, times=times)
    return checks


# the ragged ladders: (T, n_alpha), after each model's paths' shapes
LADDER_RAGGED = ((31, 1), (33, 33), (100, 128), (150, 14))


def ladder_form_phase(dev):
    """B7's warp form at every shape a path launches it at (AutoRally T=150,
    the cartpole T=100, the DI T=48 and T=50; 14 alphas) and at LADDER_RAGGED:
    gains, feedforward, costs, xs_new and us_new bit for bit against the
    plain version and the one-thread ladder, the gains and feedforward
    against B6's on the same linearisation. At the paths' shapes each is
    timed A B B A against the one-thread ladder, beside its bound."""
    cart = CartpoleDynamics.create(control_ranges=CART_RANGE, device=dev)
    models = {
        "ar_nn": (lambda: AutorallyNNDynamics.create(seed=0, device=dev), ar_x0, (T_AR,),
                  OPS_AR_DERIV, FNN_MACS + 68),
        "cartpole": (lambda: cart, lambda d: torch.tensor([0.0, 0.0, 0.5, 0.0], device=d),
                     (T_ZOO,), OPS_CART_DERIV, 3),
        "di": (lambda: DoubleIntegratorDynamics.create(device=dev),
               lambda d: torch.tensor(X0_RDI, device=d), (T_RDI, T_R), 0, 0),
    }
    outs = ("gains", "feedforward", "costs", "xs_new", "us_new")
    checks, times, seed = [], {}, 400
    for name, (make, x0, path_T, deriv_ops, n_params) in models.items():
        paths = [(T_, N_ALPHA) for T_ in path_T]
        for T_, n in paths + [c for c in LADDER_RAGGED if c not in paths]:
            seed += 1
            args = list(ladder_problem(make(), x0(dev), T_, seed))
            args[14] = _alpha_ladder(n, device=dev)
            kout = riccati.riccati_ladder_solve(*args)
            with one_thread_ladder():
                oout = riccati.riccati_ladder_solve(*args)
            pout = ladder_plain(args)
            bK, bk = riccati.riccati_backward(*(args[i] for i in (3, 4, 5, 6, 7, 8, 10, 11)),
                                              DT)
            torch.cuda.synchronize()
            label = f"B7 {name} T={T_} n_alpha={n}"
            for what, k, o, p_ in zip(outs, kout, oout, pout):
                checks += [check(f"{label} {what}", k, p_, "bitwise"),
                           check(f"{label} {what} (one-thread)", o, p_, "bitwise")]
            same(f"{label} gains against B6's", kout[0], bK)
            same(f"{label} feedforward against B6's", kout[1], bk)
            if (T_, n) in paths:
                t = abba_against(lambda args=args: riccati.riccati_ladder_solve(*args),
                         one_thread_ladder)
                t["bound_ms"], t["bound_by"] = bound_ms(*ladder_work(args, deriv_ops,
                                                                     n_params))
                times[f"{name} T={T_}"] = FORM_TIMES[("ladder", f"{name} T={T_}")] = t
    emit("ladder_forms", checks=checks, times=times)
    return checks, times


def staged_parts(pair, dev):
    """pair_parts, with the DI circle cost of the main path (make_inputs)."""
    if pair == "di_circle":
        return (DoubleIntegratorDynamics.create(device=dev),
                DoubleIntegratorCircleCost(device=dev), torch.tensor(X0, device=dev),
                [1.0, 1.0], 0.0, T)
    return pair_parts(pair, dev)


def staged_case(dev, pair, K, T_, p, stride, seed, timed):
    """B4 of one staged pair at (K, T_) against its plain version and the
    one-thread build: U, W, the costs, the crash flags and the carry rows
    bit for bit, in the four modes when ``timed`` (then each A B B A against
    the one-thread kernel), else in the Gaussian and Smooth-MPPI with its
    epilogue, and B3 and B1 (``staged_solve_rollout_checks``; at the path's
    shape the kernel phases check and time them)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn, cost, x0, std, offset, _ = staged_parts(pair, dev)
    C_ = dyn.CONTROL_DIM
    mean = 0.3 * torch.randn((T_, C_), generator=g, device=dev)
    mean[:, -1] += offset
    dmean = 0.3 * torch.randn((T_, C_), generator=g, device=dev)
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    checks, times = [], {}
    modes = ((("gaussian", False), ("nln", False), ("smooth", False), ("smooth", True))
             if timed else (("gaussian", False), ("smooth", True)))
    for kind, epilogue in modes:
        s = zoo_sampler(kind, C_, std, dev, p, T_)
        state = dmean if kind == "smooth" else None
        kid = fr.noise_kind(s)
        name = f"{pair} K={K} T={T_} B4 {kind}{' epilogue' if epilogue else ''}"

        def run(emit_u=True, s=s, state=state, kid=kid, epilogue=epilogue):
            return fr._sample_rollout_cuda(dyn, cost, s, kid, x0, mean, seed_t, DT, LAM,
                                           ALPHA, K, 0, stride, state, epilogue, emit_u, None)

        kout = run()
        pc, pcrash, pU, pW = fr.sample_rollout_plain(
            dyn, cost, s, x0, mean, seed_t, DT, LAM, ALPHA, K, optimization_stride=stride,
            sampler_state=state)
        with one_thread_sample():
            one = run()
        torch.cuda.synchronize()
        same(f"{name} crash flags", kout[1], pcrash)
        checks += [check(f"{name} costs", kout[0], pc, "bitwise"),
                   check(f"{name} U", kout[2], pU, "bitwise")]
        if kind == "smooth":
            checks.append(check(f"{name} W", kout[3], pW, "bitwise"))
        if epilogue:
            checks.append(check(f"{name} carry rows", kout[4],
                                fr.block_carries_ordered(pc, pW, fr._f32(LAM)), "bitwise"))
        for i, o in enumerate(one):
            if o is not None:
                same(f"{name} output {i} of the one-thread build", o, kout[i])
        if timed:
            t = abba_against(lambda: run(False), one_thread_sample)
            t["bound_ms"], t["bound_by"] = bound_ms(*zoo_sampling_work(
                dyn, cost, sum(PAIR_OPS[pair]), K, T_, kind, False, epilogue))
            times[f"B4 {kind}{' epilogue' if epilogue else ''}"] = t
    if not timed:
        checks += staged_solve_rollout_checks(dev, g, pair, K, T_, p, stride, mean, seed_t)
    return checks, times


def staged_solve_rollout_checks(dev, g, pair, K, T_, p, stride, mean, seed_t):
    """B3 (Gaussian) and B1 (costs; the exp epilogue and Tsallis pass 1 with
    LR; and, for a pair with a per-sample-x0 entry, its exp epilogue with LR
    from one x0 per sample) of a staged pair at (K, T_), B1 on B3's samples,
    against the plain versions: costs, crash flags, U, the carry rows in
    write_block_carry's order and the block minima bit for bit; B3 and B1
    from one x0 also against the one-thread build (rollout_x0.cu has
    none)."""
    dyn, cost, x0, std, _, _ = staged_parts(pair, dev)
    C_, lam = dyn.CONTROL_DIM, fr._f32(LAM)
    label = f"{pair} K={K} T={T_}"
    s = zoo_sampler("gaussian", C_, std, dev, p, T_)
    args = (dyn, cost, s, x0, mean, seed_t, DT, LAM, ALPHA, K)

    def solve():
        return fused_solve.fused_solve_carries(*args, optimization_stride=stride,
                                               split_cost=False)

    kc, kcrash, kU, kcarry = solve()
    pc, pcrash, pU, _ = fused_solve.fused_solve_plain(*args, optimization_stride=stride)
    torch.cuda.synchronize()
    same(f"{label} B3 crash flags", kcrash, pcrash)
    checks = [check(f"{label} B3 costs", kc, pc, "bitwise"),
              check(f"{label} B3 U", kU, pU, "bitwise"),
              check(f"{label} B3 carry rows", kcarry, fr.block_carries_ordered(pc, pU, lam),
                    "bitwise")]
    same_as_one_thread(f"{label} B3", solve, (kc, kcrash, kU, kcarry), pair, "solve")
    lr = (mean, s._sigma(T_, 0).contiguous(), s.control_cost_coeff, LAM, ALPHA,
          s.pure_threshold(K))
    x0s = (x0 + 0.05 * torch.randn((K, x0.numel()), generator=g, device=dev)).contiguous()
    modes = []
    if _build.pair_entry(pair, "rollout") is not None:
        modes += [("costs", x0, None, fr.EPI_NONE), ("epilogue+lr", x0, lr, fr.EPI_EXP),
                  ("tsallis+lr", x0, lr, fr.EPI_MIN)]
    if _build.pair_entry(pair, "rollout_x0") is not None:
        modes.append(("x0 epilogue+lr", x0s, lr, fr.EPI_EXP))
    plain = {}
    for mode, xin, lrp, epi in modes:
        def run(xin=xin, lrp=lrp, epi=epi):
            return fr._rollout_cuda(dyn, cost, xin, kU, DT, lrp, epi, LAM)

        kout = run()
        key = (xin.dim(), lrp is not None)
        if key not in plain:
            plain[key] = fr.rollout_costs_plain(dyn, cost, xin, kU, DT, lrp)
        pc, pcrash = plain[key]
        torch.cuda.synchronize()
        same(f"{label} B1 {mode} crash flags", kout[1], pcrash)
        checks.append(check(f"{label} B1 {mode} costs", kout[0], pc, "bitwise"))
        if epi == fr.EPI_EXP:
            checks.append(check(f"{label} B1 {mode} carry rows", kout[2],
                                fr.block_carries_ordered(pc, kU, lam), "bitwise"))
        if epi == fr.EPI_MIN:
            same(f"{label} B1 {mode} block minima", kout[2], fr.block_minima_plain(pc))
        if xin.dim() == 1:
            same_as_one_thread(f"{label} B1 {mode}", run, kout, pair, "rollout")
    return checks


def staged_form_phase(dev):
    """The staged forms of B4, B3 and B1 for every pair without the warp
    form: B4 at its path's K and T (timed; B3's and B1's path shapes are
    checked and timed A B B A in the kernel phases), all three at (65, 33)
    and (1, 31), the DI circle also at (8000, 100) and (63, 150), the
    bicycle at (1901, 100) and the quadrotor on its map at (1901, 150)
    (staged_case)."""
    checks, seed = [], 500
    for pair in STAGED_PAIRS:
        K, _, T_ = pair_shape(pair)
        cases = [(K, T_, 0.0, 0, True), (65, 33, 0.1, 2, False), (1, 31, 0.0, 1, False)]
        cases += {"di_circle": [(8000, 100, 0.1, 2, False), (63, 150, 0.1, 2, False)],
                  "bicycle_ar": [(1901, 100, 0.1, 2, False)],
                  "quadrotor_map": [(1901, 150, 0.1, 2, False)]}.get(pair, [])
        for K_, T__, p, stride, timed in cases:
            seed += 1
            c, t = staged_case(dev, pair, K_, T__, p, stride, seed, timed)
            checks += c
            if timed:
                FORM_TIMES[("sample", pair)] = t
    emit("staged_forms", checks=checks,
         times={pair: t for (kind, pair), t in FORM_TIMES.items() if kind == "sample"})
    return checks


def turns(fn, form="warp"):
    """``fn`` (a split dynamics pass) timed in turns on the one-thread build
    and its ``form`` (the warp or the lane-group form): one-thread, form,
    form, one-thread (CUDA events, medians of N_TIMED)."""
    t = abba_against(fn, one_thread_split)
    return {"ms": t["ms"], "one_thread_ms": t["other_ms"], "abba_ms": t["abba_ms"],
            f"{form}_faster": t["faster"]}


def warp_pass_checks(name, fn, plain, form="warp"):
    """The pass ``fn`` in its ``form`` (the warp or the lane-group form) and
    the one-thread one against the plain version: each output bit for bit
    (``fn`` and ``plain`` return tuples of tensors in the same order, named
    by ``name``)."""
    got = fn()
    with one_thread_split():
        one = fn()
    want = plain()
    torch.cuda.synchronize()
    checks = []
    for what, g, o, w in zip(name, got, one, want):
        checks += [check(f"{what} ({form})", g, w, "bitwise"),
                   check(f"{what} (one-thread)", o, w, "bitwise")]
    return checks


def warp_kernel_phase(dev, pair, K, p, stride, seed, timed):
    """The warp passes of a network pair against their plain versions: B1's
    dynamics pass (Y), B3's (U, Y, the LR sums; Gaussian and NLN) and, for
    AutoRally, B1's from one x0 per sample at RMPPI's stage-1 shape (9 x 256,
    T = 150). With ``timed``: each pass A B B A against the one-thread pass
    and its bound."""
    dyn, cost, x0, mean, U, _, samplers, T_ = split_inputs(
        dev, pair, K, p, stride, seed, "128" if pair == "ar_nn" else None)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    checks, times = [], {}

    def dynamics_case(key, dyn_, cost_, x0_, U_, x0_rows=1):
        nonlocal checks
        fn = lambda: (fr.split_dynamics_cuda(dyn_, cost_, x0_, U_, DT),)
        checks += warp_pass_checks(
            (f"{pair} {key} Y",), fn,
            lambda: (fr.split_outputs_plain(dyn_, x0_, U_, DT).permute(1, 2, 0),))
        if timed:
            t = turns(fn)
            t["bound_ms"], t["bound_by"] = bound_ms(*split_pass_work(
                pair, dyn_, cost_, U_.shape[0], T_, "dynamics", x0_rows=x0_rows))
            times[key] = t

    dynamics_case("B1 dynamics", dyn, cost, x0, U)
    for kind, samp in samplers.items():
        args = (dyn, cost, samp, fr.noise_kind(samp), x0, mean, seed_t, DT, K, 0, stride, None)

        def plain(samp=samp):
            pU, plr = fused_solve._samples_plain(dyn, samp, mean, seed_t, K, 0, stride, None)
            return pU, fr.split_outputs_plain(dyn, x0, pU, DT).permute(1, 2, 0), plr

        fn = lambda args=args: fused_solve.split_solve_dynamics_cuda(*args)
        checks += warp_pass_checks((f"{pair} B3 {kind} U", f"{pair} B3 {kind} Y",
                                    f"{pair} B3 {kind} LR sums"), fn, plain)
        if timed:
            t = turns(fn)
            t["bound_ms"], t["bound_by"] = bound_ms(*split_pass_work(
                pair, dyn, cost, K, T_, "solve_dynamics", kind=kind))
            times[f"B3 dynamics {kind}"] = t
    if pair == "ar_nn" and timed:
        rdyn, rcost = robust_ar_parts("128", dev)
        dx = torch.tensor([0.5, 0.3, 0.1, 0.0, -0.5, 0.0, 0.0], device=dev)
        w = torch.linspace(0.0, 1.0, N_CAND_AR, device=dev)[:, None]
        X0c = (ar_x0(dev)[None] + w * dx[None]).repeat_interleave(S_PER_AR, dim=0).contiguous()
        sigma = torch.tensor([AR_STD], device=dev)
        Ux = sigma * torch.randn((X0c.shape[0], T_AR, C), generator=g, device=dev)
        Ux = rdyn.enforce_constraints(None, Ux.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
        dynamics_case("B1-x0 dynamics", rdyn, rcost, X0c, Ux, x0_rows=X0c.shape[0])
    emit("warp_kernels", pair=pair, K=K, T=T_, pure_noise_percentage=p, stride=stride,
         checks=checks, times=times)
    return checks, times


PAIR_TYPES = {
    "di_circle": ("DoubleIntegrator", "DoubleIntegratorCircleCost"),
    "ar_nn": ("AutorallyNN", "ARCost"),
    "bicycle_ar": ("BicycleSlip", "ARCostBicycle"),
    "cartpole": ("Cartpole", "CartpoleQuadraticCost"),
    "quadrotor_quadratic": ("Quadrotor", "QuadrotorQuadraticCost"),
    "quadrotor_map": ("Quadrotor", "QuadrotorMapCost"),
    "dubins_quadratic": ("Dubins", "QuadraticCostT<3>"),
    "di_quadratic": ("DoubleIntegrator", "QuadraticCostT<4>"),
    "di_robust": ("DoubleIntegrator", "DoubleIntegratorRobustCost"),
    "racer_steering_ar": ("RacerLSTMSteering", "ARCostRacer"),
    "racer_unc_ar": ("RacerLSTMUnc", "ARCostRacer"),
}


def case_T(pair, K, T_):
    """The horizon of a kernel case of ``pair`` at K samples: T_, the path's,
    but RACER_RAGGED_T for a racer row's ragged K."""
    return RACER_RAGGED_T if pair in RACER_PAIRS and K != pair_shape(pair)[0] else T_


def pair_shape(pair):
    """(K, ragged K, T) of a pair's path."""
    if pair == "ar_nn":
        return K_AR, K_AR_RAGGED, T_AR
    if pair == "bicycle_ar":
        return K_BI, K_BI_RAGGED, T_BI
    if pair in RACER_PAIRS:
        return K_RC, K_RC_RAGGED, T_RACER[pair]
    return K_ZOO, K_ZOO_RAGGED, T_ZOO


def pair_kernel_phases(dev):
    """Every new entry against its plain version: B4 and the new B3 entries
    (``pair_sample_phase``), the split entries of the new pairs
    (``split_kernel_phase``) and the per-sample-x0 split
    (``split_x0_phase``), at the path's shape (timed), the ragged one and
    the partly-crashing map. Returns (max abs errors, times), each keyed by
    (phase, pair)."""
    errs, times = {}, {}

    def note(key, checks, t, timed_):
        errs[key] = max([errs.get(key, 0.0)] + [c["max_abs_err"] for c in checks])
        if timed_:
            times[key] = t

    seed = 201
    for pair in SAMPLE_PAIRS:
        K, K_rag, _ = pair_shape(pair)
        cases = [(K, 0.0, 0, None, True), (K_rag, 0.1, 2, None, False)]
        if pair in WARP_PAIRS:  # the warp form's last block partly empty
            cases.append((K_rag + 1, 0.1, 2, None, False))
        if pair in MAP_PAIRS:
            cases.append((K, 0.0, 0, "partial", False))
        for K_, p, stride, map_kind, timed_ in cases:
            seed += 1
            checks, t = pair_sample_phase(dev, pair, K_, p, stride, seed, map_kind, timed_)
            note(("sample", pair), checks, t, timed_)
    for pair in SPLIT_PAIRS:
        K, K_rag, _ = pair_shape(pair)
        cases = [(K, 0.0, 0, None, True), (K_rag, 0.1, 2, None, False)]
        if pair in MAP_PAIRS:
            cases.append((K, 0.0, 0, "partial", False))
        for K_, p, stride, map_kind, timed_ in cases:
            seed += 1
            checks, t = split_kernel_phase(dev, pair, K_, p, stride, seed, map_kind, timed_)
            note(("split", pair), checks, t, timed_)
            if pair in LANES_PAIRS:  # the lane-group pass's own Y checks
                note(("lanes", pair), [c for c in checks if "Y (" in c["check"]], t, False)
    for pair, map_kind, timed_ in (("di_robust", None, True), ("ar_nn", "128", True),
                                   ("ar_nn", "partial", False)):
        checks, t = split_x0_phase(dev, pair, map_kind, timed_)
        note(("split_x0", pair), checks, t, timed_)
    return errs, times


def warp_fields(pass_times, warp, key, by_path):
    """The ``kernels`` line's numbers of a warp pass: (its times, the fields
    to add): its time, the one-thread pass's and their A B B A
    (``warp_kernel_phase``), the bound, the plain version's time from the
    split phase (``pass_times``), and the launches per closed-loop step of
    each path that runs it (``by_path``)."""
    t = {**pass_times, **warp[key]}
    extra = {k: t[k] for k in ("one_thread_ms", "abba_ms", "warp_faster")}
    extra["launches_per_step"] = {p: n / STEPS_BY_PATH[p] if p in STEPS_BY_PATH else None
                                  for p, n in by_path.items()}
    return t, extra


def pair_kernel_entries(errs, times, paths, warp_times=None, carry_paths=None):
    """The ``kernels`` line's entries of the new kernels: launches counted
    per C entry over every path of ``paths`` ({path: (launches, entry
    launches)}); the carry pass's also over ``carry_paths`` ({path:
    launches})."""
    def line(name, pair, kind, replaces, t, err, warp_key=None, **extra):
        lib, fn = _build.pair_entry(pair, kind)
        by = {p: e.get(fn, 0) for p, (_, e) in paths.items() if e.get(fn, 0)}
        if warp_key is not None:
            t, more = warp_fields(t, warp_times[pair], warp_key, by)
            extra.update(more)
        return {"name": name, "route": "cuda",
                "source": f"mppi_generic_tpu_torch/csrc/{lib}.cu",
                "replaces": f"mppi_generic_tpu/ops/{replaces}",
                "launches": sum(by.values()), "launches_by_path": by, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t.get("plain_ms"), "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t.get("library_ms"), **extra}

    out = []
    for pair in SAMPLE_PAIRS:
        if pair == "dubins_trajectory":
            continue  # a mode of the Dubins entry
        dyn_name, cost_name = PAIR_TYPES[pair]
        t = times[("sample", pair)]
        K, _, T_ = pair_shape(pair)
        modes = {m: t[m] for m in ("B4 gaussian", "B4 nln", "B4 smooth")}
        err = errs[("sample", pair)]
        if pair == "dubins_quadratic":
            tt = times[("sample", "dubins_trajectory")]
            modes.update({f"goal trajectory {m}": v for m, v in tt.items()})
            err = max(err, errs[("sample", "dubins_trajectory")])
        out.append(line(f"{split_name(pair, 'sample')}<{dyn_name}, {cost_name}>", pair,
                        "sample", "pallas_rollout.py:1631", t["B4 smooth epilogue"], err,
                        K=K, T=T_, modes=modes, recurrent=pair in RACER_PAIRS,
                        **one_thread_fields("sample", pair),
                        **({"b3_split_warp_pass_gaussian_ms":
                            warp_times[pair]["B3 dynamics gaussian"]["ms"]}
                           if pair in WARP_PAIRS else {})))
        if pair in SOLVE_PAIRS:
            out.append(line(f"{b3_kernel(pair)}<{dyn_name}, {cost_name}>", pair, "solve",
                            "pallas_solve.py:103", t["B3 gaussian"], err, K=K, T=T_,
                            modes={"nln": t["B3 nln"]}, **one_thread_fields("solve", pair)))

    # the warp form's carry pass (Smooth-MPPI's epilogue): launches over every
    # path, timed at AutoRally's shape, the racers' as modes
    carry = {pair: times[("sample", pair)][CARRY] for pair in WARP_PAIRS}
    by = {p: l[CARRY] for p, l in (
        [(p, l) for p, (l, _) in paths.items()] + list((carry_paths or {}).items()))
          if l.get(CARRY, 0)}
    t = carry["ar_nn"]
    out.append({"name": CARRY, "route": "cuda",
                "source": "mppi_generic_tpu_torch/csrc/block_pass.cuh",
                "replaces": "mppi_generic_tpu/ops/pallas_rollout.py:1646-1650 (the "
                            "epilogue of _fused_sample_call, :1631), the carry rows "
                            "of pallas_solve.py:103 (_fused_solve_call, :355-388) "
                            "after B3's warp form and those of pallas_rollout.py:1005 "
                            "(_fused_call's _accum) after B1's warp form",
                "launches": sum(by.values()), "launches_by_path": by,
                "max_abs_err": max([errs[("sample", pair)] for pair in WARP_PAIRS]
                                   + [errs.get(CARRY, 0.0)]),
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None, "K": K_AR, "T": T_AR,
                "modes": {f"{pair} K={pair_shape(pair)[0]} T={pair_shape(pair)[2]}": carry[pair]
                          for pair in RACER_PAIRS},
                **pass_fields("carry")})

    def forms(st, prefix):
        keys = ("ms", "combined_ms", "abba_ms", "split_faster", "bound_ms")
        return {m[len(prefix):]: {k: v.get(k) for k in keys}
                for m, v in st.items() if m.startswith(prefix)}

    for pair in SPLIT_PAIRS:
        dyn_name, cost_name = PAIR_TYPES[pair]
        st, err = times[("split", pair)], errs[("split", pair)]
        K, _, T_ = pair_shape(pair)
        warp = pair in WARP_PAIRS
        dyn_pass = st["B1 split epilogue+lr"]["dynamics_pass"]
        # the lane-group pass A B B A against its one-thread build
        lanes = ({"one_thread_abba": {k: dyn_pass[k] for k in (
            "ms", "one_thread_ms", "abba_ms", "lanes_faster")}} if pair in LANES_PAIRS else {})
        out += [
            line(f"{split_name(pair, 'split_dynamics')}<{dyn_name}>", pair,
                 "split_dynamics", "pallas_rollout.py:548 (split mode, run_tile :663-696)",
                 dyn_pass, errs[("lanes", pair)] if pair in LANES_PAIRS else err, K=K, T=T_,
                 warp_key="B1 dynamics" if warp else None,
                 split_form=forms(st, "B1 split "), **lanes,
                 **one_thread_fields("split_dynamics", pair)),
            line(f"{split_name(pair, 'split_solve_dynamics')}<{dyn_name}>", pair,
                 "split_solve_dynamics", "pallas_solve.py:103 (split mode :274-290)",
                 st["B3 split gaussian"]["dynamics_pass"], err, K=K, T=T_,
                 warp_key="B3 dynamics gaussian" if warp else None,
                 modes={"nln": (warp_times[pair]["B3 dynamics nln"] if warp
                                else st["B3 split nln"]["dynamics_pass"])},
                 split_form=forms(st, "B3 split "),
                 **one_thread_fields("split_solve_dynamics", pair)),
            line(f"{cost_kernel(pair, K, T_)}<{cost_name}>", pair, "split_cost",
                 "pallas_rollout.py:698-768 and pallas_solve.py:292-332 (the split cost "
                 "pass)", st["B1 split epilogue+lr"]["cost_pass"], err, K=K, T=T_,
                 **earlier_fields("cost", pair),
                 modes={**{f"B1 {m}": st[f"B1 split {m}"]["cost_pass"]
                           for m in ("costs", "costs+lr", "tsallis+lr")},
                        **{f"B3 {k}": st[f"B3 split {k}"]["cost_pass"]
                           for k in ("gaussian", "nln")}}),
        ]
    for pair in ("di_robust", "ar_nn"):
        t, err = times[("split_x0", pair)]["B1-x0 split"], errs[("split_x0", pair)]
        shape = ({"K": N_CAND_AR * S_PER_RDI, "T": T_RDI} if pair == "di_robust"
                 else {"K": N_CAND_AR * S_PER_AR, "T": T_AR})
        form = {k: t.get(k) for k in ("ms", "combined_ms", "abba_ms", "split_faster",
                                      "bound_ms", "plain_ms")}
        out.append(line(f"{split_name(pair, 'split_dynamics_x0')}"
                        f"<{PAIR_TYPES[pair][0]}> (per-sample x0)",
                        pair, "split_dynamics_x0",
                        "pallas_rollout.py:548 (split mode with per_sample_x0, :646)",
                        t["dynamics_pass"], err,
                        warp_key="B1-x0 dynamics" if pair in WARP_PAIRS else None,
                        **shape, split_form=form,
                        **one_thread_fields("split_dynamics_x0", pair)))
        if pair == "di_robust":
            out.append(line(f"{cost_kernel(pair, shape['K'], shape['T'])}"
                            "<DoubleIntegratorRobustCost>", pair,
                            "split_cost", "pallas_rollout.py:698-768 (the split cost pass)",
                            t["cost_pass"], err, **shape, **earlier_fields("cost", pair)))
    return out


def pair_loops(dev):
    """The loops that put each new entry on a path: Tsallis, CEM and
    Smooth-MPPI on ``fused_solve`` (B4) for AutoRally's bench configuration,
    the racer rows, the quadrotor hover, the waypoint map, the Dubins car,
    the DI with QuadraticCost or its robust cost and the bicycle; the
    bicycle's and the DI robust cost's Gaussian ``fused_solve`` (B3); the
    split form forced on ``fused_solve`` for the cartpole swing-up and the
    quadrotor hover (their bars) and on ``fused`` and ``fused_solve`` for
    each split pair (the racer rows on AUTO where it splits, ``split_choice``); RMPPI
    with stage 1's split forced on the DI robust cost (its band bar) and
    on AUTO for AutoRally. Returns {path: (launches, entry
    launches)}."""
    n, nh = PAIR_LOOP_STEPS, PAIR_LOOP_STEPS_HEAVY
    paths = {}

    def run(path, *a, **kw):
        out = model_loop_phase(path, *a, profile=kw.pop("profile", False), **kw)
        paths[path] = out[:2]
        return out

    b4 = sample_launches
    b4_smooth = lambda k, pair: sample_launches(pair, k, epilogue=True)
    solve_want = lambda k, pair: solve_launches(pair, k)
    smooth = lambda C_, std, T_: SmoothMPPIDistribution.create(
        std_dev=std, control_cost_coeff=[1.0] * C_, num_timesteps=T_, dt=DT_SMOOTH)
    # AutoRally's bench configuration (bench.py:704-717) with Tsallis weights
    # and with the Smooth-MPPI sampler
    dyn, cost = ar_parts("128")
    ar = dict(dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T_AR, num_rollouts=K_AR,
              num_iters=1, kernel="fused_solve", split_cost=False)
    run("autorally_tsallis_fused_solve", VanillaMPPI(
        dyn, cost, ar_sampler("gaussian"), weight_transform="tsallis", tsallis_gamma=GAMMA,
        tsallis_r=R_TS, **ar), ar_x0(dev), n, b4("ar_nn", n), map="128", profile=1)
    run("autorally_smooth_fused_solve", VanillaMPPI(
        dyn, cost, smooth(C, AR_STD, T_AR), **ar), ar_x0(dev), n, b4_smooth(n, "ar_nn"),
        map="128")
    # the same with Tsallis weights on kernel="fused": B1's Tsallis pass 1 (the
    # combined kernel, forced where AUTO splits)
    nt = AR_TSALLIS_FUSED_STEPS
    run("autorally_tsallis_fused", VanillaMPPI(
        dyn, cost, ar_sampler("gaussian"), weight_transform="tsallis", tsallis_gamma=GAMMA,
        tsallis_r=R_TS, **dict(ar, kernel="fused")), ar_x0(dev), nt,
        rollout_launches("ar_nn", nt, "tsallis"), map="128")
    # the racer rows: CEM on the steering row, Smooth-MPPI on the uncertainty row
    for pair, path, extra in (
            ("racer_steering_ar", "racer_steering_cem_fused_solve",
             dict(sampler=GaussianDistribution.create(std_dev=RACER_STD),
                  weight_transform="cem")),
            ("racer_unc_ar", "racer_unc_smooth_fused_solve",
             dict(sampler=smooth(C, RACER_STD, T_RACER["racer_unc_ar"])))):
        rdyn, rcost = racer_parts(pair)
        samp = extra.pop("sampler")
        want = (b4_smooth(nh, pair) if isinstance(samp, SmoothMPPIDistribution)
                else b4(pair, nh))
        run(path, VanillaMPPI(rdyn, rcost, samp, dt=DT, lam=LAM, alpha=ALPHA,
                              num_timesteps=T_RACER[pair], num_rollouts=K_RC, num_iters=1,
                              kernel="fused_solve", split_cost=False, **extra),
            racer_x0(pair, dev), nh, want, pair=pair)
    # the bicycle (bench.py:641-665) on the fused solve: Gaussian (B3) and
    # Tsallis (B4)
    bdyn, bcost = bicycle_parts()
    bi = dict(dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T_BI, num_rollouts=K_BI,
              num_iters=1, kernel="fused_solve", split_cost=False)
    bx0 = torch.zeros(S_BI, device=dev)
    run("bicycle_fused_solve", VanillaMPPI(bdyn, bcost, GaussianDistribution.create(
        std_dev=BI_STD), **bi), bx0, n, solve_want(n, "bicycle_ar"), map="128", profile=1)
    run("bicycle_tsallis_fused_solve", VanillaMPPI(
        bdyn, bcost, GaussianDistribution.create(std_dev=BI_STD), weight_transform="tsallis",
        tsallis_gamma=GAMMA, tsallis_r=R_TS, **bi), bx0, n, b4("bicycle_ar", n), map="128")
    # the quadrotor hover (tests/test_model_zoo.py:60-92) with Tsallis weights:
    # states finite, the position error recorded
    hover_mean = torch.tensor([0.0, 0.0, 0.0, HOVER_THRUST], device=dev).expand(T_HOVER, 4)
    qx0 = zoo_parts("quadrotor_quadratic", dev)[2]
    _, _, X, _ = run("quadrotor_hover_tsallis_fused_solve", build_zoo(
        "quadrotor_quadratic", "fused_solve", K=K_HOVER, T_=T_HOVER,
        weight_transform="tsallis", tsallis_gamma=GAMMA, tsallis_r=R_TS), qx0,
        TSALLIS_HOVER_STEPS, b4("quadrotor_quadratic", TSALLIS_HOVER_STEPS),
        initial_mean=hover_mean)
    emit("quadrotor_hover_tsallis_position", position_error=float(
        torch.linalg.vector_norm(X[-1, :3])), final_state=X[-1].tolist())
    # the waypoint map, the Dubins car, the DI with QuadraticCost or its
    # robust cost: 20-step Tsallis loops; the robust cost's Gaussian B3
    qz = torch.zeros(13, device=dev)
    qz[6] = 1.0
    tsallis = dict(weight_transform="tsallis", tsallis_gamma=GAMMA, tsallis_r=R_TS)
    run("quadrotor_waypoint_tsallis_fused_solve", build_zoo(
        "quadrotor_map", "fused_solve", K=K_WAYPOINT, T_=T_HOVER, **tsallis), qz, n,
        b4("quadrotor_map", n),
        initial_mean=hover_mean)
    for pair, x0 in (("dubins_quadratic", torch.tensor([0.0, 0.0, 3.0], device=dev)),
                     ("dubins_trajectory", torch.tensor([0.0, 0.0, 3.0], device=dev)),
                     ("di_quadratic", torch.tensor([-9.0, -9.0, 0.1, 0.1], device=dev))):
        run(f"{pair}_tsallis_fused_solve", build_zoo(pair, "fused_solve", **tsallis), x0, n,
            b4("dubins_quadratic" if pair == "dubins_trajectory" else pair, n))
    rdi = lambda **kw: VanillaMPPI(
        DoubleIntegratorDynamics.create(), DoubleIntegratorRobustCost(),
        GaussianDistribution.create(std_dev=[1.0, 1.0]), dt=DT, lam=LAM, alpha=ALPHA,
        num_timesteps=T_ZOO, num_rollouts=K_ZOO, num_iters=1, kernel="fused_solve",
        split_cost=False, **kw)
    rx0 = torch.tensor(X0_RDI, device=dev)
    run("di_robust_fused_solve", rdi(), rx0, n, solve_want(n, "di_robust"))
    run("di_robust_tsallis_fused_solve", rdi(**tsallis), rx0, n, b4("di_robust", n))
    # the split form forced: the cartpole swing-up and the quadrotor hover
    # with their bars (the zoo loops' configurations)
    swing = VanillaMPPI(CartpoleDynamics.create(), CartpoleQuadraticCost(coeffs=CART_COEFFS),
                        GaussianDistribution.create(std_dev=CART_STD, control_cost_coeff=[1.0],
                                                    pure_noise_percentage=0.01),
                        dt=0.01, lam=0.25, alpha=0.0, slide_scale=[1.0], num_timesteps=T_ZOO,
                        num_rollouts=K_ZOO, num_iters=1, kernel="fused_solve",
                        split_cost=True)
    ns = SWINGUP_STEPS
    # the loops' K and T: the hover's for the quadrotor, else the pair's path's
    loop_KT = lambda pair: ((K_HOVER, T_HOVER) if pair == "quadrotor_quadratic"
                            else pair_shape(pair)[::2])
    split_b3 = lambda k, pair: {
        split_name(pair, "split_solve_dynamics"): k, cost_kernel(pair, *loop_KT(pair)): k,
        MERGE: k}
    split_b1 = lambda k, pair: {
        split_name(pair, "split_dynamics"): k, cost_kernel(pair, *loop_KT(pair)): k,
        MERGE: k}
    _, _, X, res = run("cartpole_swingup_split", swing, torch.zeros(4, device=dev), ns,
                       split_b3(ns, "cartpole"),
                       plant=lambda x, u: x + swing.dynamics.state_deriv(x, u) * swing.dt,
                       slide_first=False)
    theta_err = abs(float(torch.remainder(X[-1, 2], 2 * np.pi)) - np.pi)
    emit("cartpole_swingup_split_bar", final_baseline=float(res.baseline),
         theta_error=theta_err, final_state=X[-1].tolist(),
         bar={"baseline": 1.0, "theta_error": 0.3})
    if not (float(res.baseline) < 1.0 and theta_err < 0.3):
        raise AssertionError(f"split cartpole swing-up missed its bar: baseline "
                             f"{float(res.baseline)}, pole angle error {theta_err}")
    nq = HOVER_STEPS
    _, _, X, _ = run("quadrotor_hover_split", build_zoo(
        "quadrotor_quadratic", "fused_solve", K=K_HOVER, T_=T_HOVER, split_cost=True), qx0,
        nq, split_b3(nq, "quadrotor_quadratic"), initial_mean=hover_mean)
    pos_err = float(torch.linalg.vector_norm(X[-1, :3]))
    emit("quadrotor_hover_split_bar", position_error=pos_err, final_state=X[-1].tolist(),
         bar={"position_error": 0.5})
    if not pos_err < 0.5:
        raise AssertionError(f"split quadrotor hover missed its bar: position error {pos_err}")
    # each split pair's B1 and B3 split entries on short forced-split loops
    # (the racer steering row on "fused": racer_steering_split_fused); the
    # racer rows on AUTO where it takes the split form (split_choice), its
    # dynamics passes in their warp form
    for pair in SPLIT_PAIRS:
        k = nh if pair in RACER_PAIRS else SPLIT_LOOP_STEPS
        qmean = None
        for kernel, want in (("fused", split_b1(k, pair)), ("fused_solve", split_b3(k, pair))):
            if kernel == "fused_solve" and pair in ("cartpole", "quadrotor_quadratic"):
                continue  # the swing-up and the hover above
            if pair == "racer_steering_ar":
                path = "racer_steering_split_fused" + ("" if kernel == "fused" else "_solve")
            else:
                path = f"{pair}_split_{kernel}"
            if pair in RACER_PAIRS:
                pdyn, pcost = racer_parts(pair)
                ctrl = VanillaMPPI(pdyn, pcost, GaussianDistribution.create(std_dev=RACER_STD),
                                   dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T_RACER[pair],
                                   num_rollouts=K_RC, num_iters=1, kernel=kernel,
                                   split_cost=split_choice(pdyn, pcost, kernel))
                x0 = racer_x0(pair, dev)
            elif pair == "bicycle_ar":
                ctrl = VanillaMPPI(bdyn, bcost, GaussianDistribution.create(std_dev=BI_STD),
                                   **dict(bi, kernel=kernel, split_cost=True))
                x0 = bx0
            elif pair == "quadrotor_quadratic":
                ctrl = build_zoo(pair, kernel, K=K_HOVER, T_=T_HOVER, split_cost=True)
                x0, qmean = qx0, hover_mean
            else:
                ctrl = build_zoo(pair, kernel, split_cost=True)
                x0 = zoo_parts(pair, dev)[2]
            run(path, ctrl, x0, k, want, initial_mean=qmean)
    # RMPPI with stage 1's split: the JAX suite's loop on the DI robust cost
    # (forced; its band bar) and AutoRally's
    nr = ROBUST_DI_STEPS
    rng = np.random.RandomState(1)
    disturb = torch.zeros((nr, S), device=dev)
    disturb[:, 2:] = torch.tensor(np.stack([rng.randn(2) * 0.02 for _ in range(nr)]),
                                  dtype=torch.float32, device=dev)
    x1 = lambda k, pair: {
        split_name(pair, "split_dynamics_x0"): k - 1, split_name(pair, "rmppi"): k, LADDER: k,
        cost_kernel(pair, *((N_CAND_AR * S_PER_RDI, T_RDI) if pair == "di_robust"
                            else (N_CAND_AR * S_PER_AR, T_AR))): k - 1}
    out = robust_family_loop("rmppi_di_robust_split",
                             build_rmppi_di_robust("fused", split_cost=True), rx0, nr,
                             x1(nr, "di_robust"), disturb=disturb, profile=False)
    band_check("rmppi_di_robust_split", out[2])
    paths["rmppi_di_robust_split"] = out[:2]
    na = SPLIT_LOOP_STEPS
    # AutoRally on the default split choice (AUTO: stage 1's split form)
    out = robust_family_loop("rmppi_autorally_split", build_rmppi_ar("fused", split_cost=None),
                             ar_x0(dev), na, x1(na, "ar_nn"), profile=False, map="128",
                             cost="ARRobustCost")
    paths["rmppi_autorally_split"] = out[:2]
    return paths


# ---------------------------------------------------------------------------
# The robust family finished: the entries of the pairs the JAX package runs
# in its kernels and the port refused before (B1 from one x0 per sample, its
# split dynamics pass and B8 for the later pairs, csrc/robust_<pair>.cu; the
# DI robust cost's B1 from one x0 and its split dynamics passes; the DI
# circle cost's split pass from one x0 per sample; the Dubins ladder), each
# held against its plain version at the shape its loop launches it at and
# timed by CUDA events beside its bound; then their loops at full width:
# RMPPI on each later pair (stage 1 on the combined kernel, then forced
# split where the cost is eligible), Tube and vanilla on the DI robust cost,
# the bench RMPPI row with split_cost=True, Tube and RMPPI with Smooth-MPPI,
# RMPPI with BoxQP; and CCM's law on the card against its CPU run.
# ---------------------------------------------------------------------------
FINISH_PAIRS = ("cartpole", "quadrotor_quadratic", "quadrotor_map", "dubins_quadratic",
                "di_quadratic", "bicycle_ar", "racer_steering_ar", "racer_unc_ar")
# each RMPPI loop's steps, and the step from which stage 1 runs split
# (eligible costs; the first step evaluates no candidate). The racer
# uncertainty model has no loop: DDP cannot track it in either package (its
# state_deriv gives 9 of its 26 state components; JAX's ilqr raises on the
# shapes too), and without DDP's gains JAX's RMPPI does not run on the
# kernel path; its entries count their launches in finish_kernel_phase.
FINISH_STEPS = {"cartpole": (4, 2), "dubins_quadratic": (4, 2), "quadrotor_quadratic": (3, 2),
                "quadrotor_map": (2, None), "di_quadratic": (3, 2), "bicycle_ar": (3, 2),
                "racer_steering_ar": (3, 2)}
PHASE_LAUNCHES = {}  # {C entry: its launches in finish_kernel_phase}
FINISH_LOOP_STEPS = 5  # the DI loops (Tube, vanilla split, bench RMPPI split, Smooth)
BOXQP_STEPS = 3
OPS_DUBINS_DERIV = 2 + 2 * OPS_TRANSCENDENTAL  # u0 cos(yaw), u0 sin(yaw)
FINISH_DELTA = {"cartpole": [0.2, 0.1, 0.3, 0.0], "dubins_quadratic": [0.3, 0.2, 0.4],
                "di_quadratic": [0.4, 0.2, 0.3, -0.3], "bicycle_ar": [0.2, 0.1, 0.05],
                "quadrotor_quadratic": [0.2, 0.1, -0.1], "quadrotor_map": [0.2, 0.1, -0.1],
                "racer_steering_ar": [0.2, 0.1, 0.05], "racer_unc_ar": [0.2, 0.1, 0.05]}


def finish_parts(pair, dev=None):
    """(dynamics, cost, x0, std, mean offset, K, T) of a later pair's RMPPI
    configuration: the zoo pairs at the zoo's K and T (the cartpole's is
    cartpole_example_K8192's), the bicycle and the racers at their rows'."""
    if pair == "bicycle_ar":
        dyn, cost = bicycle_parts(dev or "cuda")
        return dyn, cost, torch.zeros(S_BI, device=dev or "cuda"), BI_STD, 0.0, K_BI, T_BI
    dyn, cost, x0, std, offset, _ = zoo_parts(pair, dev)
    if pair == "cartpole":
        std = CART_STD
    K_ = K_RC if pair in RACER_PAIRS else K_ZOO
    return dyn, cost, x0, std, offset, K_, T_RACER.get(pair, T_ZOO)


def finish_candidates(pair, x0, s_per=S_PER):
    """RMPPI's stage-1 layout: N_CAND candidates on a segment from x0, each
    repeated for its s_per samples, (N_CAND s_per, S)."""
    d = torch.zeros_like(x0)
    delta = torch.tensor(FINISH_DELTA.get(pair, [0.3, 0.1, 0.2, -0.2]), device=x0.device)
    d[:delta.shape[0]] = delta
    w = torch.linspace(0.0, 1.0, N_CAND, device=x0.device)[:, None]
    return (x0[None] + w * d[None]).repeat_interleave(s_per, dim=0).contiguous()


def finish_kernel_phase(dev):
    """Every new entry against its plain version at the shape its loop
    launches it at: B1 from one x0 per sample (9 x 256 candidates' samples,
    the pair's T), its split dynamics pass (Y and the split form's costs),
    B8 (the loop's K and T, the DDP gains of the configuration) for each
    later pair; the DI robust cost's B1 from one x0 (exp epilogue + LR, its
    carry rows and merge), its split dynamics pass (the split form with the
    epilogue) and B3's split dynamics pass (U and the carry rows) at K=8192,
    T=100; the DI circle cost's split pass from one x0 per sample at the
    bench RMPPI row's 9 x 256 x 50; the Dubins ladder at T=100 from a yaw of
    3.0, past pi. U, Y, costs, crash flags, U_real, gains and the ladder's
    outputs to the last bit (TOL "bitwise"; the ladder's at TOL "exact"),
    carries and merges at their tolerances. Times by CUDA events, the plain
    versions' after one warm-up (the racers' one run), bounds from the .cuh
    operation counts; each new split dynamics entry's whole split form also
    A B B A against the combined kernel on the same inputs (``abba``, the
    measurement ``fr.AUTO_SPLIT`` reads). Returns ({entry: checks}, {entry:
    times})."""
    g = torch.Generator(device=dev).manual_seed(171)
    checks, times = {}, {}

    def timing(fn, kernel, plain, work, pair=None, run_ms=None):
        # run_ms: the check's own run of the plain version, timed, which a
        # racer pair's plain time is (time_plain would repeat that one run)
        plain_ms = run_ms if pair in RACER_PAIRS else time_plain(plain, pair)
        t = {"ms": time_ms(kernel, N_TIMED), "plain_ms": plain_ms, "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound_ms(*work)
        times[fn] = t

    for pair in FINISH_PAIRS:
        fr.reset_launch_counts()
        dyn, cost, x0, std, offset, K_, T_ = finish_parts(pair, dev)
        S_, C_ = dyn.STATE_DIM, dyn.CONTROL_DIM
        step_ops, cost_ops = PAIR_OPS[pair]
        sigma = torch.tensor([std], device=dev).expand(T_, C_).contiguous()
        mean = 0.2 * torch.randn((T_, C_), generator=g, device=dev)
        mean[:, -1] += offset
        X0c = finish_candidates(pair, x0)
        Kx = X0c.shape[0]
        Ux = mean + sigma * torch.randn((Kx, T_, C_), generator=g, device=dev)
        Ux = dyn.enforce_constraints(None, Ux.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
        if pair != "bicycle_ar":  # its B1 from one x0 per sample: robust_kernels
            fn = f"rollout_costs_x0_{pair}"
            kc, kcrash = fr.fused_rollout_costs(dyn, cost, X0c, Ux, DT, split_cost=False)
            (pc, pcrash), run_ms = plain_timed(
                lambda: fr.rollout_costs_plain(dyn, cost, X0c, Ux, DT))
            same(f"{fn} crash flags", kcrash, pcrash)
            checks[fn] = [check(f"{fn} costs", kc, pc, "bitwise")]
            n_bytes, n_ops = zoo_rollout_work(dyn, cost, step_ops + cost_ops, Kx, T_, "costs")
            timing(fn, lambda: fr.fused_rollout_costs(dyn, cost, X0c, Ux, DT, split_cost=False),
                   lambda: fr.rollout_costs_plain(dyn, cost, X0c, Ux, DT),
                   (n_bytes + 4 * (Kx - 1) * S_, n_ops), pair, run_ms)
        if _build.pair_entry(pair, "split_dynamics_x0") is not None:
            fn = f"split_dynamics_x0_{pair}"
            kY = fr.split_dynamics_cuda(dyn, cost, X0c, Ux, DT)
            pY, run_ms = plain_timed(lambda: fr.split_outputs_plain(dyn, X0c, Ux, DT))
            pY = pY.permute(1, 2, 0)
            kc, kcrash = fr.fused_rollout_costs(dyn, cost, X0c, Ux, DT, split_cost=True)
            pc, pcrash = fr.split_rollout_plain(dyn, cost, X0c, Ux, DT)
            torch.cuda.synchronize()
            same(f"{fn} split crash flags", kcrash, pcrash)
            checks[fn] = [check(f"{fn} Y", kY, pY, "bitwise"),
                          check(f"{fn} split costs", kc, pc, "bitwise")]
            timing(fn, lambda: fr.split_dynamics_cuda(dyn, cost, X0c, Ux, DT),
                   lambda: fr.split_outputs_plain(dyn, X0c, Ux, DT),
                   split_pass_work(pair, dyn, cost, Kx, T_, "dynamics", x0_rows=Kx), pair,
                   run_ms)
            # the whole split form against the combined kernel, for AUTO_SPLIT
            times[fn]["split_form"] = abba(
                lambda: fr.fused_rollout_costs(dyn, cost, X0c, Ux, DT, split_cost=False),
                lambda: fr.fused_rollout_costs(dyn, cost, X0c, Ux, DT, split_cost=True))
        if _build.pair_entry(pair, "rmppi") is not None:
            fn = f"rmppi_rollout_{pair}"
            x_real = X0c[-1]  # the far candidate: the feedback acts
            traj = rollout_single(dyn, x0, mean, DT)[0][:-1]
            gains = DDPFeedback.create(dyn, DT).compute_feedback(x_real, traj, mean).gains
            U = (mean + sigma * torch.randn((K_, T_, C_), generator=g, device=dev)).contiguous()
            coeff = torch.full((C_,), 0.5, device=dev)
            args = (dyn, cost, x0, x_real, U, gains, sigma, coeff, DT, LAM, ALPHA)
            kout = fr.fused_rmppi_rollout(*args)
            pout = fr.rmppi_rollout_plain(*args)
            torch.cuda.synchronize()
            same(f"{fn} crash flags", kout[3], pout[3])
            checks[fn] = [check(f"{fn} {n}", a, b, "bitwise")
                          for n, a, b in zip(("s_nom", "j_real", "s_fb", "U_real"),
                                             (*kout[:3], kout[4]), (*pout[:3], pout[4]))]
            n_bytes = zoo_fixed_bytes(dyn, cost) + 4 * (
                2 * K_ * T_ * C_ + 4 * K_ + T_ * C_ * (S_ + 1) + C_ + 2 * S_)
            timing(fn, lambda: fr.fused_rmppi_rollout(*args),
                   lambda: fr.rmppi_rollout_plain(*args),
                   (n_bytes, K_ * T_ * rmppi_ops(S_, C_, step_ops, cost_ops) + 3 * K_), pair)
        PHASE_LAUNCHES.update(fr.entry_counts)
        emit("finish_kernels", pair=pair, K=K_, T=T_, K_x0=Kx,
             checks=[c for fn, cs in checks.items() if fn.endswith(pair) for c in cs],
             times={fn: t for fn, t in times.items() if fn.endswith(pair)})

    # the DI robust cost from one x0 at the flagship's K and T
    ddyn, dcost = DoubleIntegratorDynamics.create(device=dev), DoubleIntegratorRobustCost(device=dev)
    x0 = torch.tensor(X0_RDI, device=dev)
    mean = 0.3 * torch.randn((T, C), generator=g, device=dev)
    sigma = torch.ones((T, C), device=dev)
    U = (mean + torch.randn((K_MAIN, T, C), generator=g, device=dev)).contiguous()
    U = ddyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    lrp = (mean, sigma, torch.full((C,), 0.01, device=dev), LAM, ALPHA,
           float(np.float32(K_MAIN)))
    fn = "rollout_costs_di_robust"
    kc, kcrash, kcarry = fr.rollout_block_carries(ddyn, dcost, x0, U, DT, LAM, lrp,
                                                  split_cost=False)
    pc, pcrash = fr.rollout_costs_plain(ddyn, dcost, x0, U, DT, lrp)
    torch.cuda.synchronize()
    same(f"{fn} crash flags", kcrash, pcrash)
    checks[fn] = [check(f"{fn} costs", kc, pc, "bitwise")] + merge_checks(
        fn, kcarry, fr.block_carries_plain(pc, U, LAM), pc, U, T, C)
    n_bytes, n_ops = zoo_rollout_work(ddyn, dcost, OPS_STEP + OPS_DI_ROBUST_COST, K_MAIN, T,
                                      "epilogue+lr")
    timing(fn, lambda: fr.rollout_block_carries(ddyn, dcost, x0, U, DT, LAM, lrp,
                                                split_cost=False),
           lambda: fr.rollout_costs_plain(ddyn, dcost, x0, U, DT, lrp), (n_bytes, n_ops))
    fn = "split_dynamics_di_robust"
    kY = fr.split_dynamics_cuda(ddyn, dcost, x0, U, DT)
    pY = fr.split_outputs_plain(ddyn, x0, U, DT).permute(1, 2, 0)
    kc, kcrash, kcarry = fr.rollout_block_carries(ddyn, dcost, x0, U, DT, LAM, lrp,
                                                  split_cost=True)
    pc, pcrash = fr.split_rollout_plain(ddyn, dcost, x0, U, DT, lrp)
    torch.cuda.synchronize()
    same(f"{fn} split crash flags", kcrash, pcrash)
    checks[fn] = [check(f"{fn} Y", kY, pY, "bitwise"),
                  check(f"{fn} split costs", kc, pc, "bitwise")] + merge_checks(
        f"{fn} split", kcarry, fr.block_carries_plain(pc, U, LAM), pc, U, T, C)
    timing(fn, lambda: fr.split_dynamics_cuda(ddyn, dcost, x0, U, DT),
           lambda: fr.split_outputs_plain(ddyn, x0, U, DT),
           split_pass_work("di_robust", ddyn, dcost, K_MAIN, T, "dynamics"))
    times[fn]["split_form"] = abba(
        lambda: fr.rollout_block_carries(ddyn, dcost, x0, U, DT, LAM, lrp, split_cost=False),
        lambda: fr.rollout_block_carries(ddyn, dcost, x0, U, DT, LAM, lrp, split_cost=True))
    fn = "split_solve_dynamics_di_robust"
    samp = GaussianDistribution.create(std_dev=[1.0, 1.0], control_cost_coeff=[0.01, 0.01],
                                       device=dev)
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    sargs = (ddyn, dcost, samp, x0, mean, seed_t, DT, LAM, ALPHA, K_MAIN)
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*sargs, split_cost=True)
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_split_plain(*sargs)
    torch.cuda.synchronize()
    same(f"{fn} crash flags", kcrash, pcrash)
    checks[fn] = [check(f"{fn} U", kU, pU, "bitwise"),
                  check(f"{fn} costs", kc, pc, "bitwise")] + merge_checks(
        fn, kcarry, pcarry, pc, pU, T, C)
    kind = fr.noise_kind(samp)
    timing(fn, lambda: fused_solve.split_solve_dynamics_cuda(
               ddyn, dcost, samp, kind, x0, mean, seed_t, DT, K_MAIN, 0, 0, None),
           lambda: fused_solve.fused_solve_split_plain(*sargs),
           split_pass_work("di_robust", ddyn, dcost, K_MAIN, T, "solve_dynamics"))
    times[fn]["split_form"] = abba(
        lambda: fused_solve.fused_solve_carries(*sargs, split_cost=False),
        lambda: fused_solve.fused_solve_carries(*sargs, split_cost=True))
    # the DI circle cost's split pass from one x0 per sample, the bench
    # RMPPI row's stage 1 (9 x 256 x 50)
    fn = "split_dynamics_x0_di_circle"
    cdyn, ccost = DoubleIntegratorDynamics.create(device=dev), DoubleIntegratorCircleCost(device=dev)
    X0c = finish_candidates("di_circle", torch.tensor(X0, device=dev))
    Ux = torch.randn((X0c.shape[0], T_R, C), generator=g, device=dev).contiguous()
    kY = fr.split_dynamics_cuda(cdyn, ccost, X0c, Ux, DT)
    pY = fr.split_outputs_plain(cdyn, X0c, Ux, DT).permute(1, 2, 0)
    kc, kcrash = fr.fused_rollout_costs(cdyn, ccost, X0c, Ux, DT, split_cost=True)
    pc, pcrash = fr.split_rollout_plain(cdyn, ccost, X0c, Ux, DT)
    torch.cuda.synchronize()
    same(f"{fn} split crash flags", kcrash, pcrash)
    checks[fn] = [check(f"{fn} Y", kY, pY, "bitwise"),
                  check(f"{fn} split costs", kc, pc, "bitwise")]
    timing(fn, lambda: fr.split_dynamics_cuda(cdyn, ccost, X0c, Ux, DT),
           lambda: fr.split_outputs_plain(cdyn, X0c, Ux, DT),
           split_pass_work("di_circle", cdyn, ccost, X0c.shape[0], T_R, "dynamics",
                           x0_rows=X0c.shape[0]))
    times[fn]["split_form"] = abba(
        lambda: fr.fused_rollout_costs(cdyn, ccost, X0c, Ux, DT, split_cost=False),
        lambda: fr.fused_rollout_costs(cdyn, ccost, X0c, Ux, DT, split_cost=True))
    # the Dubins ladder: the RMPPI loop's T, the tracked yaw turning from 3.0
    # past pi (a yaw rate about 1.2)
    fn = "riccati_ladder_dubins"
    args = ladder_problem(DubinsDynamics.create(device=dev),
                          torch.tensor([0.0, 0.0, 3.0], device=dev), T_ZOO, 173,
                          u_offset=[1.0, 1.2])
    kout = riccati.riccati_ladder_solve(*args)
    pout = ladder_plain(args)
    torch.cuda.synchronize()
    checks[fn] = [check(f"{fn} {n}", a, b, "exact")
                  for n, a, b in zip(("gains", "feedforward", "costs", "xs_new", "us_new"),
                                     kout, pout)]
    if not float(kout[3][..., 2].abs().max()) > np.pi:
        raise AssertionError(f"{fn}: no candidate's yaw passed pi")
    timing(fn, lambda: riccati.riccati_ladder_solve(*args), lambda: ladder_plain(args),
           ladder_work(args, OPS_DUBINS_DERIV, 0))
    times[fn]["chain_steps"] = T_ZOO - 1
    emit("finish_kernels", pair="di_robust, di_circle, dubins ladder",
         checks=[c for fn, cs in checks.items() if not fn.endswith(FINISH_PAIRS) for c in cs],
         times={fn: t for fn, t in times.items() if not fn.endswith(FINISH_PAIRS)})
    return checks, times


def build_rmppi_pair(pair, feedback=None):
    """RMPPI on a later pair (finish_parts): its Gaussian std (the
    quadrotor's without a control cost, as build_zoo), DDP feedback (Q, R,
    Q_f the identity; on the ladder where ops.riccati takes the sizes), 9
    candidates x 256 samples, the JAX default threshold, the combined kernel
    for stage 1 (finish_loop forces the split from its split step)."""
    dyn, cost, _, std, _, K_, T_ = finish_parts(pair)
    coeff = [0.0] * dyn.CONTROL_DIM if pair.startswith("quadrotor") else None
    return RobustMPPI(dyn, cost, GaussianDistribution.create(std_dev=std,
                                                             control_cost_coeff=coeff),
                      feedback=feedback or DDPFeedback.create(dyn, DT), dt=DT, lam=LAM,
                      alpha=ALPHA, num_timesteps=T_, num_rollouts=K_, num_candidates=N_CAND,
                      samples_per_condition=S_PER, kernel="fused", split_cost=False)


def finish_rmppi_want(pair, n, split_from, ladder):
    """The launches of n RMPPI steps on ``pair``: stage 1's B1 from one x0
    per sample (combined before ``split_from``, the split form from it; the
    first step evaluates no candidate), B8 (the racers': none, their stage 2
    is eager), the ladder."""
    dyn, _, _, _, _, _, T_ = finish_parts(pair)
    n_split = 0 if split_from is None else n - split_from
    want = {b1_kernel(pair, x0=True): n - 1 - n_split}
    if n_split:
        want[split_name(pair, "split_dynamics_x0")] = n_split
        want[cost_kernel(pair, N_CAND * S_PER, T_)] = n_split
    if _build.pair_entry(pair, "rmppi") is not None:
        want[split_name(pair, "rmppi")] = n
    if ladder:
        want[LADDER] = n
    return {k: v for k, v in want.items() if v}


def finish_loops(dev):
    """The new entries' loops (each through the entry points, its launches
    counted and held to what it must launch): RMPPI on each later pair
    (FINISH_STEPS; stage 1 forced split from its split step where the cost
    is eligible), Tube (kernel="fused") on the DI robust cost, vanilla
    ``fused`` and ``fused_solve`` with split_cost=True on it, the bench
    RMPPI row with split_cost=True, Tube (``fused_solve``, B4 with the
    epilogue) and RMPPI with Smooth-MPPI, and RMPPI with BoxQP (its DDP on
    the eager scan). Returns {path: (launches, entry launches)}."""
    paths = {}
    for pair, (n, split_from) in FINISH_STEPS.items():
        ctrl = build_rmppi_pair(pair)
        ladder = riccati.supported(ctrl.dynamics.STATE_DIM, ctrl.dynamics.CONTROL_DIM,
                                   ctrl.num_timesteps)
        out = robust_family_loop(f"rmppi_{pair}", ctrl, finish_parts(pair)[2], n,
                                 finish_rmppi_want(pair, n, split_from, ladder),
                                 profile=0, split_from=split_from, pair=pair)
        paths[f"rmppi_{pair}"] = out[:2]
    n = FINISH_LOOP_STEPS
    ddyn = DoubleIntegratorDynamics.create()
    rsamp = GaussianDistribution.create(std_dev=[1.0, 1.0], control_cost_coeff=[0.01, 0.01])
    tube = TubeMPPI(ddyn, DoubleIntegratorRobustCost(), rsamp,
                    feedback=DDPFeedback.create(ddyn, DT), dt=DT, lam=LAM, alpha=ALPHA,
                    num_timesteps=T, num_rollouts=K_MAIN, kernel="fused", split_cost=False)
    out = robust_family_loop("tube_di_robust", tube, torch.tensor(X0_RDI, device=dev), n,
                             {**rollout_launches("di_robust", 2 * n), LADDER: n}, profile=0)
    paths["tube_di_robust"] = out[:2]
    for kernel, want in (
            ("fused", {split_name("di_robust", "split_dynamics"): n,
                       cost_kernel("di_robust", K_MAIN, T): n, MERGE: n}),
            ("fused_solve", {split_name("di_robust", "split_solve_dynamics"): n,
                             cost_kernel("di_robust", K_MAIN, T): n, MERGE: n})):
        ctrl = VanillaMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorRobustCost(),
                           GaussianDistribution.create(std_dev=[1.0, 1.0],
                                                       control_cost_coeff=[0.01, 0.01]),
                           dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T, num_rollouts=K_MAIN,
                           num_iters=1, kernel=kernel, split_cost=True)
        path = f"di_robust_split_{kernel}"
        paths[path] = model_loop_phase(path, ctrl, torch.tensor(X0_RDI, device=dev), n, want,
                                       profile=0)[:2]
    # the bench RMPPI row with split_cost=True (stage 1's split from one x0
    # per sample); Tube and RMPPI with Smooth-MPPI; RMPPI with BoxQP
    rs = build_robust()
    rs.split_cost = True
    out = robust_family_loop(
        "rmppi_split", rs, torch.tensor(X0, device=dev), n,
        {split_name("di_circle", "split_dynamics_x0"): n - 1,
         cost_kernel("di_circle", N_CAND * S_PER, T_R): n - 1,
         split_name("di_circle", "rmppi"): n, LADDER: n}, profile=0)
    paths["rmppi_split"] = out[:2]
    smooth = SmoothMPPIDistribution.create(std_dev=[1.0, 1.0], num_timesteps=T_R,
                                           dt=DT_SMOOTH)
    tube = TubeMPPI(ddyn, DoubleIntegratorCircleCost(), smooth,
                    feedback=DDPFeedback.create(ddyn, DT), dt=DT, lam=LAM_R, alpha=ALPHA,
                    num_timesteps=T_R, num_rollouts=K_R, nominal_threshold=THRESH_R,
                    kernel="fused_solve")
    out = robust_family_loop("tube_smooth", tube, torch.tensor(X0, device=dev), n,
                             {**sample_launches("di_circle", 2 * n, epilogue=True), LADDER: n},
                             profile=0)
    if not float(out[4].sampler_state.abs().max()) > 0:
        raise AssertionError("tube_smooth: the derivative mean never moved")
    paths["tube_smooth"] = out[:2]
    rmppi = RobustMPPI(ddyn, DoubleIntegratorCircleCost(),
                       SmoothMPPIDistribution.create(std_dev=[1.0, 1.0], num_timesteps=T_R,
                                                     dt=DT_SMOOTH),
                       feedback=DDPFeedback.create(ddyn, DT), dt=DT, lam=LAM_R, alpha=ALPHA,
                       num_timesteps=T_R, num_rollouts=K_R, num_candidates=N_CAND,
                       samples_per_condition=S_PER, value_function_threshold=THRESH_R,
                       split_cost=False)
    out = robust_family_loop("rmppi_smooth", rmppi, torch.tensor(X0, device=dev), n,
                             {b1_kernel("di_circle", x0=True): n - 1,
                              split_name("di_circle", "rmppi"): n, LADDER: n}, profile=0)
    if not float(out[4].sampler_state.abs().max()) > 0:
        raise AssertionError("rmppi_smooth: the derivative mean never moved")
    paths["rmppi_smooth"] = out[:2]
    m = BOXQP_STEPS
    boxqp = build_robust()
    boxqp.split_cost = False  # the combined B1-x0 on a loop (AUTO splits the row)
    boxqp.feedback = DDPFeedback.create(boxqp.dynamics, DT, use_boxqp=True).to(dev)
    out = robust_family_loop("rmppi_boxqp", boxqp, torch.tensor(X0, device=dev), m,
                             {b1_kernel("di_circle", x0=True): m - 1,
                              split_name("di_circle", "rmppi"): m}, profile=0)
    paths["rmppi_boxqp"] = out[:2]
    return paths


def ccm_boxqp_phase(dev):
    """CCM's law (feedback/ccm.py, plain PyTorch) and BoxQP's gains on the
    card against their CPU runs on the same inputs: the law on 64 state
    pairs of the DI and on the nominal itself (its zero), k through its
    state; DDP with BoxQP on the bench RMPPI row's DI (T=50, bounds
    +-0.5 that bind). TOL "solve", rtol 1e-4 / atol 1e-5 (the card's and
    the CPU's small matrix products, solves and 4 x 4 inverse sum in other
    orders)."""
    u_init = (0.8 * np.random.default_rng(181).normal(size=(T_R, C))).astype("f")
    out = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        fb = CCMFeedback.create(DoubleIntegratorDynamics.create(device=d))
        rows = []
        for i in range(64):
            rng = np.random.default_rng(1000 + i)
            x_nom = torch.tensor(rng.normal(size=4).astype("f"), device=d)
            x_act = x_nom + torch.tensor(0.5 * rng.normal(size=4).astype("f"), device=d)
            u_nom = torch.tensor(rng.normal(size=2).astype("f"), device=d)
            rows.append(fb.u_feedback(x_act, x_nom, u_nom))
        rows.append(fb.u_feedback(x_nom, x_nom, u_nom))  # on the nominal: no feedback
        goal = torch.zeros((16, 4), device=d)
        ctrls = torch.tensor(0.3 * np.random.default_rng(2).normal(size=(16, 2)).astype("f"),
                             device=d)
        st = fb.compute_feedback(goal[0], goal, ctrls)
        rows.append(fb.k(torch.tensor([0.1, 0.0, 1.0, 0.0], device=d), goal[3], 3, st))
        ddp = DDPFeedback.create(DoubleIntegratorDynamics.create(
            control_ranges=[[-0.5, 0.5], [-0.5, 0.5]], device=d), DT, use_boxqp=True)
        x0 = torch.tensor(X0, device=d)
        u = torch.tensor(u_init, device=d)
        traj = torch.tensor(X0, device=d).expand(T_R, 4).contiguous()
        out[where] = (torch.stack(rows).cpu(), ddp.compute_feedback(x0, traj, u).gains.cpu())
    checks = [check("ccm u_feedback and k", out["cuda"][0], out["cpu"][0], "solve"),
              check("boxqp DDP gains", out["cuda"][1], out["cpu"][1], "solve")]
    acts = int((out["cuda"][0].abs().sum(1) > 0).sum())
    if not 0 < acts < len(out["cuda"][0]):
        raise AssertionError(f"ccm: the law acted on {acts} of {len(out['cuda'][0])} cases")
    if not bool((out["cuda"][1].abs().sum(-1) == 0).any()):
        raise AssertionError("boxqp: no control was clamped, the bounds never bound")
    emit("ccm_boxqp", checks=checks, law_active_cases=acts)
    return checks


# the C entry, the source and the TPU kernel of each new entry on the
# kernels line
FINISH_REPLACES = {"rollout_x0": "pallas_rollout.py:548 (per_sample_x0 mode, :646)",
                   "split_dynamics_x0": "pallas_rollout.py:548 (split mode, run_tile "
                                        ":663-696, per_sample_x0)",
                   "rmppi": "pallas_rollout.py:2127",
                   "rollout": "pallas_rollout.py:548",
                   "split_dynamics": "pallas_rollout.py:548 (split mode, run_tile :663-696)",
                   "split_solve_dynamics": "pallas_solve.py:103 (split mode :274-290)"}


def finish_entries(checks, times, paths):
    """The kernels line's rows of the new entries: launches by path from the
    loops' entry counts (the racer uncertainty model's, which has no loop,
    from finish_kernel_phase), the max error of their checks, the times."""
    fns = [(f"rollout_costs_x0_{p}", p, "rollout_x0") for p in FINISH_PAIRS
           if p != "bicycle_ar"]
    fns += [(f"split_dynamics_x0_{p}", p, "split_dynamics_x0") for p in FINISH_PAIRS
            if _build.pair_entry(p, "split_dynamics_x0") is not None]
    fns += [(f"rmppi_rollout_{p}", p, "rmppi") for p in FINISH_PAIRS
            if _build.pair_entry(p, "rmppi") is not None]
    fns += [("rollout_costs_di_robust", "di_robust", "rollout"),
            ("split_dynamics_di_robust", "di_robust", "split_dynamics"),
            ("split_solve_dynamics_di_robust", "di_robust", "split_solve_dynamics"),
            ("split_dynamics_x0_di_circle", "di_circle", "split_dynamics_x0"),
            ("riccati_ladder_dubins", "dubins_quadratic", "ladder")]
    rows = []
    for fn, pair, kind in fns:
        t = times[fn]
        by = {p: e.get(fn, 0) for p, (_, e) in paths.items() if e.get(fn, 0)}
        row = {"route": "cuda", "launches": sum(by.values()), "launches_by_path": by,
               "max_abs_err": max(c["max_abs_err"] for c in checks[fn]),
               "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": None}
        if "split_form" in t:  # the whole split form A B B A against the combined
            row["split_form"] = t["split_form"]
        if kind == "ladder":
            row.update(name=f"{LADDER}<Dubins> ({fn})",
                       source="mppi_generic_tpu_torch/csrc/riccati.cu",
                       replaces="mppi_generic_tpu/ops/pallas_riccati.py:203", T=T_ZOO,
                       n_alpha=N_ALPHA, chain_steps=t["chain_steps"])
        else:
            row.update(name=f"{split_name(pair, kind)} ({fn})",
                       source=f"mppi_generic_tpu_torch/csrc/{_build.pair_entry(pair, kind)[0]}.cu",
                       replaces=f"mppi_generic_tpu/ops/{FINISH_REPLACES[kind]}")
        if pair in FINISH_PAIRS and pair not in FINISH_STEPS:  # no loop: the phase's
            row.update(launches=PHASE_LAUNCHES.get(fn, 0), on_main_path=False,
                       launches_from="finish_kernels")
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: nothing launched it")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# The rest of the racer family: RACER Dubins, its elevation model without an
# LSTM, the full-suspension RacerSuspension, the bicycle on its elevation
# map, the suspension model with its steering LSTM, each with its new B1, B3
# and B4 entries, and the LSTM-uncertainty model on the map (the map mode of
# the racer_unc_ar entries, built by instantiations.racer_lstm_mppi), all on
# the bench's 128^2 elevation map (racer_elevation_data, bench.py:724-727)
# with ARStandardCost on the 128^2 track map (bench.py:642-645), std [0.3,
# 0.5], lambda 1, dt 0.02, K = 1920 (ragged 1901), T = 100 (the uncertainty
# model 150), random LSTMs from numpy seeds. Each entry against its plain
# version (family_kernel_phase, phase "racer_family"), then two steps of each
# on fused_solve and on fused and one on fused_solve with Smooth-MPPI, so
# that B3, B1 and B4 are each on a path (family_loops), and the bicycle once
# with a normals map, which the wrappers refuse (the eager path: no launch).
# ---------------------------------------------------------------------------
FAMILY_PAIRS = ("racer_dubins_ar", "racer_elevation_ar", "racer_suspension_ar",
                "bicycle_elevation_ar", "racer_elev_susp_ar", "racer_unc_map")
# the entries of each configuration: the uncertainty model's map mode runs
# the racer_unc_ar entries; the new pairs' forms (check_forms)
FAMILY_ENTRY = {**{p: p for p in FAMILY_PAIRS}, "racer_unc_map": "racer_unc_ar"}
FAMILY_STAGED_PAIRS = ("racer_dubins_ar", "racer_elevation_ar", "racer_suspension_ar",
                       "bicycle_elevation_ar")
FAMILY_WARP_PAIRS = ("racer_elev_susp_ar",)
K_FAMILY, K_FAMILY_RAGGED = 1920, 1901
T_FAMILY = {**dict.fromkeys(FAMILY_PAIRS, 100), "racer_unc_map": 150}
# the ragged case: the last 64-sample block partly empty, one partial chunk
# of steps (its plain versions take seconds at the paths' T)
FAMILY_RAGGED_T = 17
FAMILY_LOOP_STEPS = 2  # the eager re-rollout of the mean dominates a step
FAMILY_SMOOTH_STEPS = 1  # the Smooth-MPPI loops: B4 on a path
FAMILY_TYPES = {"racer_dubins_ar": "RacerDubins, ARCostRacer",
                "racer_elevation_ar": "RacerElevation, ARCostRacer",
                "racer_suspension_ar": "RacerSuspension, ARCostSuspension",
                "bicycle_elevation_ar": "BicycleElevation, ARCostRacer",
                "racer_elev_susp_ar": "RacerElevSusp, ARCostRacer",
                "racer_unc_map": "RacerLSTMUnc (elevation map), ARCostRacer"}
# Operations of each step (counted from the .cuh as OPS_RACER_STEER is): RACER
# Dubins the forces 10, the yaw rate (two divisions, tanf), the kinematics
# (cosf, sinf, 2), the lags 11, the Euler update 14, the wrap (fmodf and 4),
# the clamps 5; the elevation model OPS_RACER_STEER without its LSTM; the
# rigid body: the rotation 45, the engine 20, per wheel about 250 (two
# rotations 30, the map query 54, the spring 12, the contact frame 30 with
# cosf, sinf, sqrtf, the forces 40, the torque 30, its force's sqrtf; the
# front wheels' atan2_approx 28), the derivative 80 with six divisions, the
# outputs 80 with three polynomial angles, the update and renormalization 40
# (tanf, 16 transcendentals in the wheels, sqrtf); the bicycle elevation
# model OPS_BI_STEP, the Jacobian 30 and Q 30 with seven transcendentals, the
# propagation 320, the settling as the elevation model's 400 with ten; the
# suspension model OPS_RACER_UNC's parametric part (52 and four), the
# suspension 129 (and four map queries of 62 with cosf and sinf), the brake
# 10, Q 30 with four, the Jacobian 43 with five, the propagation 320, the
# update 36 with fmodf, its steering LSTM; the uncertainty model on the map
# OPS_RACER_UNC, the four queries and the settling.
OPS_RACER_DUBINS = 58 + 5 * OPS_TRANSCENDENTAL
OPS_RACER_ELEVATION = 479 + 15 * OPS_TRANSCENDENTAL
OPS_RACER_SUSPENSION = 1400 + 21 * OPS_TRANSCENDENTAL
OPS_BICYCLE_ELEVATION = OPS_BI_STEP + 780 + 17 * OPS_TRANSCENDENTAL
OPS_SUSP_MAP = 4 * 62 + 2 * OPS_TRANSCENDENTAL  # the suspension's four ground queries
OPS_RACER_ELEV_SUSP = 620 + 15 * OPS_TRANSCENDENTAL + OPS_SUSP_MAP + lstm_ops(4, 1)
OPS_FAMILY = {
    "racer_dubins_ar": OPS_RACER_DUBINS, "racer_elevation_ar": OPS_RACER_ELEVATION,
    "racer_suspension_ar": OPS_RACER_SUSPENSION, "bicycle_elevation_ar": OPS_BICYCLE_ELEVATION,
    "racer_elev_susp_ar": OPS_RACER_ELEV_SUSP,
    "racer_unc_map": OPS_RACER_UNC + OPS_SUSP_MAP + 400 + 10 * OPS_TRANSCENDENTAL,
}


@functools.lru_cache(maxsize=None)
def family_maps(dev):
    """The bench's 128^2 elevation map and 128^2 track map on ``dev``."""
    elev = MapTexture2D(racer_elevation_data(), origin=(-64.0, -64.0, 0.0), resolution=1.0,
                        device=dev)
    data, origin, res, _ = ar_map_data("128")
    return elev, MapTexture2D(data, origin=origin, resolution=res, device=dev)


def family_normals(dev):
    """Unit normals (128, 128, 3) of the bench's elevation map, for the
    bicycle's refused configuration."""
    h = racer_elevation_data().astype(np.float64)
    gy, gx = np.gradient(h, 1.0)
    n = np.stack([-gx, -gy, np.ones_like(h)], -1)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    return MapTexture2D(n, origin=(-64.0, -64.0, 0.0), resolution=1.0, device=dev)


def family_x0(pair, dev):
    """The configuration's x0: at rest but for 3 m/s forward, at the origin
    (the rigid body on its wheels, identity attitude)."""
    if pair == "racer_suspension_ar":
        x0 = RacerSuspensionDynamics.create(device=dev).get_zero_state()
        x0[7] = 3.0
        return x0
    S_ = {"racer_dubins_ar": 7, "racer_elevation_ar": 9, "bicycle_elevation_ar": 22,
          "racer_elev_susp_ar": 23, "racer_unc_map": 26}[pair]
    x0 = torch.zeros(S_, device=dev)
    x0[5 if pair == "bicycle_elevation_ar" else 0] = 3.0
    return x0


def family_parts(pair, dev):
    """(dynamics, cost) of a configuration on ``dev``."""
    elev, track = family_maps(dev)
    kw = dict(device=dev)
    if pair == "racer_dubins_ar":
        dyn = RacerDubinsDynamics.create(**kw)
    elif pair == "racer_elevation_ar":
        dyn = RacerDubinsElevationDynamics.create(elevation_map=elev, **kw)
    elif pair == "racer_suspension_ar":
        dyn = RacerSuspensionDynamics.create(elevation_map=elev, **kw)
    elif pair == "bicycle_elevation_ar":
        dyn = BicycleSlipParametricElevation.create(elevation_map=elev, **kw)
    elif pair == "racer_elev_susp_ar":
        dyn = RacerDubinsElevationSuspension.create(elevation_map=elev, seed=0, **kw)
    else:
        dyn = RacerDubinsElevationLSTMUncertainty.create(elevation_map=elev, seed=0, **kw)
    indices = (0, 1, 5, 6, 3, 4) if pair == "racer_suspension_ar" else RACER_INDICES
    return dyn, ARStandardCost(costmap=track, output_indices=indices, **kw)


# the modes a family configuration's loops launch (B1's LR modes share one
# plain run): held against their plain versions at the path's shape; every
# mode is held at the ragged shape, and timed at the path's
FAMILY_PATH_MODES = ("B1 costs+lr", "B1 epilogue+lr", "B1 tsallis+lr", "B3 gaussian",
                     "B4 smooth")


def family_kernel_phase(dev, pair, K, p, stride, seed, full):
    """A configuration's B1 entry in its four modes (costs, costs + LR, the
    exp epilogue + LR, Tsallis pass 1 + LR), B3 (Gaussian, NLN) and B4
    (Gaussian, NLN, Smooth-MPPI, Smooth-MPPI with its epilogue), each against
    its plain version on the same inputs: U, W, costs, crash flags, block
    minima and (the warp form's) ordered carry rows to the last bit, carries
    at rtol 1e-5, merged means at rtol 1e-4 / atol 1e-5. ``full``: the path's
    K and T, the modes of FAMILY_PATH_MODES held (the plain versions take
    seconds there; their single runs are timed), every kernel timed by CUDA
    events against its bound from the step's operation count, and the
    library yardstick softmax(-J / lambda) @ U beside the epilogue; else the
    ragged K at FAMILY_RAGGED_T steps (one partial chunk), every mode held.
    Returns ({kernel: checks}, {mode: times})."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn, cost = family_parts(pair, dev)
    x0, ops, entry = family_x0(pair, dev), OPS_FAMILY[pair], FAMILY_ENTRY[pair]
    T_ = T_FAMILY[pair] if full else FAMILY_RAGGED_T
    mean = 0.3 * torch.randn((T_, C), generator=g, device=dev)
    mean[:, 0] += 0.3
    seed_t = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    by_kernel = {"rollout_costs_kernel": [], "fused_solve_kernel": [],
                 "fused_sample_rollout_kernel": [], "flash_combine_kernel": []}
    times, crashed = {}, {}
    warp = b1_kernel(entry) == "rollout_costs_warp_kernel"

    def held(name):
        return not full or name in FAMILY_PATH_MODES

    def timing(name, kernel, work, plain_ms=None):
        if full:
            t = {"ms": time_ms(kernel, N_TIMED), "plain_ms": plain_ms, "library_ms": None}
            t["bound_ms"], t["bound_by"] = bound_ms(*work)
            times[name] = t

    def merges(name, kcarry, pcarry, pc, X):
        km, kb, ke = fr.flash_combine(kcarry, T_, C, LAM)
        pm, pb, pe = fr.flash_combine_plain(pcarry, T_, C, LAM)
        by_kernel["flash_combine_kernel"] += [
            check(f"{pair} {name} new_mean", km, pm, "new_mean"),
            check(f"{pair} {name} baseline", kb, pb, "baseline"),
            check(f"{pair} {name} eta", ke, pe, "eta")]
        return check(f"{pair} {name} carry", kcarry, pcarry, "carry",
                     fr.block_carries_plain(pc, X.abs(), LAM).abs())

    # B1 on the sampler's clamped samples
    samp = zoo_sampler("gaussian", C, RACER_STD, dev, p, T_)
    U, _ = samp.sample(g, mean, K, optimization_stride=stride)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    lr = (mean, samp._sigma(T_, 0).contiguous(), samp.control_cost_coeff, LAM, ALPHA,
          samp.pure_threshold(K))
    plain = {w: plain_timed(lambda w=w: fr.rollout_costs_plain(dyn, cost, x0, U, DT,
                                                                lr if w else None))
             for w in ((True,) if full else (False, True))}
    for mode in ("costs", "costs+lr", "epilogue+lr", "tsallis+lr"):
        lrp = lr if mode.endswith("+lr") else None
        name = f"B1 {mode}"

        def kernel(mode=mode, lrp=lrp):
            if mode.startswith("epilogue"):
                return fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lrp)
            if mode.startswith("tsallis"):
                return fr.rollout_block_minima(dyn, cost, x0, U, DT, lrp)
            return fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp)

        kout = kernel()
        crashed[name] = float(kout[1].float().mean())
        if not held(name):
            timing(name, kernel, zoo_rollout_work(dyn, cost, ops, K, T_, mode))
            continue
        (pc, pcrash), pms = plain[lrp is not None]
        torch.cuda.synchronize()
        same(f"{pair} {name} crash flags", kout[1], pcrash)
        by_kernel["rollout_costs_kernel"].append(check(f"{pair} {name} costs", kout[0], pc,
                                                       "bitwise"))
        if mode.startswith("epilogue"):
            if warp:  # the warp form's carry pass
                same(f"{pair} {name} carry rows in write_block_carry's order", kout[2],
                     fr.block_carries_ordered(pc, U, fr._f32(LAM)))
            by_kernel["rollout_costs_kernel"].append(
                merges(name, kout[2], fr.block_carries_plain(pc, U, LAM), pc, U))
        if mode.startswith("tsallis"):
            same(f"{pair} {name} block minima", kout[2], fr.block_minima_plain(pc))
        timing(name, kernel, zoo_rollout_work(dyn, cost, ops, K, T_, mode), pms)
        if full and mode == "epilogue+lr":
            # one-call yardstick for the weighting + weighted sum (not used by the port)
            times[name]["library_ms"] = time_ms(
                lambda: torch.softmax(-pc / LAM, 0) @ U.view(K, -1), N_TIMED)
    # B3
    for kind in ("gaussian", "nln"):
        s = zoo_sampler(kind, C, RACER_STD, dev, p, T_)
        args = (dyn, cost, s, x0, mean, seed_t, DT, LAM, ALPHA, K)
        kw = dict(optimization_stride=stride)
        name = f"B3 {kind}"
        kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, **kw)
        crashed[name] = float(kcrash.float().mean())
        pms = None
        if held(name):
            (pc, pcrash, pU, pcarry), pms = plain_timed(
                lambda: fused_solve.fused_solve_plain(*args, **kw))
            same(f"{pair} {name} crash flags", kcrash, pcrash)
            if warp:  # the warp form's carry pass
                same(f"{pair} {name} carry rows in write_block_carry's order", kcarry,
                     fr.block_carries_ordered(pc, pU, fr._f32(LAM)))
            by_kernel["fused_solve_kernel"] += [
                check(f"{pair} {name} U", kU, pU, "bitwise"),
                check(f"{pair} {name} costs", kc, pc, "bitwise"),
                merges(name, kcarry, pcarry, pc, pU)]
        timing(name, lambda args=args, kw=kw: fused_solve.fused_solve_carries(*args, **kw),
               zoo_sampling_work(dyn, cost, ops, K, T_, kind, True), pms)
    # B4: each sampler, Smooth-MPPI also with its epilogue over W
    dmean = 0.3 * torch.randn((T_, C), generator=g, device=dev)
    for kind in ("gaussian", "nln", "smooth"):
        s = zoo_sampler(kind, C, RACER_STD, dev, p, T_)
        state = dmean if kind == "smooth" else None
        args = (dyn, cost, s, x0, mean, seed_t, DT, LAM, ALPHA, K)
        name = f"B4 {kind}"
        kout = fr.fused_sample_rollout_costs(*args, optimization_stride=stride,
                                             sampler_state=state)
        crashed[name] = float(kout[1].float().mean())
        kid = fr.noise_kind(s)

        def kernel(s=s, state=state, kid=kid, epilogue=False):
            # the kernel alone, as the main path launches it (U not kept)
            return fr._sample_rollout_cuda(dyn, cost, s, kid, x0, mean, seed_t, DT, LAM,
                                           ALPHA, K, 0, stride, state, epilogue, False, None)

        pms = None
        if held(name):
            (pc, pcrash, pU, pW), pms = plain_timed(lambda args=args, state=state: (
                fr.sample_rollout_plain(*args, optimization_stride=stride,
                                        sampler_state=state)))
            same(f"{pair} {name} crash flags", kout[1], pcrash)
            by_kernel["fused_sample_rollout_kernel"] += [
                check(f"{pair} {name} U", kout[2], pU, "bitwise"),
                check(f"{pair} {name} costs", kout[0], pc, "bitwise")]
        timing(name, kernel, zoo_sampling_work(dyn, cost, ops, K, T_, kind, False), pms)
        if kind == "smooth":
            by_kernel["fused_sample_rollout_kernel"].append(
                check(f"{pair} {name} W", kout[3], pW, "bitwise"))
            kepi = fr.fused_sample_rollout_costs(*args, optimization_stride=stride,
                                                 sampler_state=state, epilogue=True)
            pm, pb, pe = fr.flash_combine_plain(fr.block_carries_plain(pc, pW, LAM), T_, C, LAM)
            name = "B4 smooth epilogue"
            same(f"{pair} {name} crash flags", kepi[1], pcrash)
            by_kernel["fused_sample_rollout_kernel"].append(
                check(f"{pair} {name} costs", kepi[0], pc, "bitwise"))
            by_kernel["flash_combine_kernel"] += [
                check(f"{pair} {name} new_deriv_mean", kepi[3], pm, "new_mean"),
                check(f"{pair} {name} baseline", kepi[4], pb, "baseline"),
                check(f"{pair} {name} eta", kepi[5], pe, "eta")]
            timing(name, lambda kernel=kernel: kernel(epilogue=True),
                   zoo_sampling_work(dyn, cost, ops, K, T_, kind, False, True), pms)
    emit("racer_family", pair=pair, entries=entry, K=K, T=T_, pure_noise_percentage=p,
         stride=stride, held=[m for m in crashed if held(m)], crashed_share=crashed,
         checks=[c for cs in by_kernel.values() for c in cs], times=times)
    return by_kernel, times


def family_kernels(dev):
    """``family_kernel_phase`` of every configuration at its path's shape and
    at the ragged K. Returns ({pair: {kernel: max abs error}}, {pair: times
    at the path's shape})."""
    errs, times = {}, {}
    for i, pair in enumerate(FAMILY_PAIRS):
        for K, p, stride, full in ((K_FAMILY, 0.0, 0, True), (K_FAMILY_RAGGED, 0.1, 2, False)):
            by_kernel, t = family_kernel_phase(dev, pair, K, p, stride, 401 + 2 * i + full, full)
            e = errs.setdefault(pair, dict.fromkeys(by_kernel, 0.0))
            for kernel, checks in by_kernel.items():
                e[kernel] = max([e[kernel]] + [c["max_abs_err"] for c in checks])
            if full:
                times[pair] = t
    return errs, times


def build_family(pair, kernel, smooth=False):
    """A configuration's VanillaMPPI on the card (the controllers' default
    device), its split choice AUTO; the uncertainty model's Gaussian one
    through instantiations.racer_lstm_mppi on the maps. ``smooth``: the
    Smooth-MPPI sampler (B4 with its epilogue on fused_solve)."""
    from mppi_generic_tpu_torch import instantiations

    elev, track = family_maps("cpu")  # the controller moves them to its device
    if pair == "racer_unc_map" and not smooth:
        return instantiations.racer_lstm_mppi(elevation_map=elev, costmap=track,
                                              kernel=kernel)[0]
    dyn, cost = family_parts(pair, "cpu")
    sampler = (SmoothMPPIDistribution.create(std_dev=RACER_STD, control_cost_coeff=[1.0] * C,
                                             num_timesteps=T_FAMILY[pair], dt=DT_SMOOTH)
               if smooth else GaussianDistribution.create(std_dev=RACER_STD))
    return VanillaMPPI(dyn, cost, sampler, dt=DT, lam=LAM, alpha=ALPHA,
                       num_timesteps=T_FAMILY[pair], num_rollouts=K_FAMILY, num_iters=1,
                       kernel=kernel)


def family_loops(dev):
    """FAMILY_LOOP_STEPS steps of each configuration on fused_solve (B3 on
    the path) and fused (B1), FAMILY_SMOOTH_STEPS on fused_solve with the
    Smooth-MPPI sampler (B4 and its epilogue), each held to its launches; then the bicycle with a
    normals map on fused_solve: the wrappers refuse it (KernelIncompatible)
    and the eager path runs, with no launch. Returns {path: (launches,
    entry launches)}."""
    paths, n = {}, FAMILY_LOOP_STEPS
    for pair in FAMILY_PAIRS:
        entry = FAMILY_ENTRY[pair]
        ns = FAMILY_SMOOTH_STEPS
        for path, kernel, smooth, steps, want in (
                (f"{pair}_fused_solve", "fused_solve", False, n, solve_launches(entry, n)),
                (f"{pair}_fused", "fused", False, n, rollout_launches(entry, n)),
                (f"{pair}_smooth_fused_solve", "fused_solve", True, ns,
                 sample_launches(entry, ns, epilogue=True))):
            out = model_loop_phase(path, build_family(pair, kernel, smooth),
                                   family_x0(pair, dev), steps, want, profile=False, pair=pair)
            paths[path] = out[:2]
    elev, track = family_maps("cpu")
    dyn = BicycleSlipParametricElevation.create(elevation_map=elev,
                                                normals_map=family_normals("cpu"))
    ctrl = VanillaMPPI(dyn, ARStandardCost(costmap=track, output_indices=RACER_INDICES),
                       GaussianDistribution.create(std_dev=RACER_STD), dt=DT,
                       lam=LAM, alpha=ALPHA, num_timesteps=T_FAMILY["bicycle_elevation_ar"],
                       num_rollouts=K_FAMILY, num_iters=1, kernel="fused_solve")
    paths["bicycle_normals_fused_solve"] = model_loop_phase(
        "bicycle_normals_fused_solve", ctrl, family_x0("bicycle_elevation_ar", dev), 1, {},
        profile=False, pair="bicycle_elevation_ar")[:2]
    return paths


FAMILY_REPLACES = {"rollout": "pallas_rollout.py:548", "solve": "pallas_solve.py:103",
                   "sample": "pallas_rollout.py:1631"}


def family_entries(errs, times, paths):
    """The kernels line's rows of the family: B1, B3 and B4 of each
    configuration (the uncertainty model's map mode under the racer_unc_ar
    entries), launches counted per C entry on the family's loops."""
    rows = []
    for pair in FAMILY_PAIRS:
        entry, t, e = FAMILY_ENTRY[pair], times[pair], errs[pair]
        for kind, mode, kernel_name, err_kernel, modes in (
                ("rollout", "B1 epilogue+lr", b1_kernel(entry), "rollout_costs_kernel",
                 ("B1 costs", "B1 costs+lr", "B1 tsallis+lr")),
                ("solve", "B3 gaussian", b3_kernel(entry), "fused_solve_kernel",
                 ("B3 nln",)),
                ("sample", "B4 smooth epilogue", split_name(entry, "sample"),
                 "fused_sample_rollout_kernel", ("B4 gaussian", "B4 nln", "B4 smooth"))):
            lib, fn = _build.pair_entry(entry, kind)
            by = {p: ent.get(fn, 0) for p, (_, ent) in paths.items()
                  if p.startswith(pair) and ent.get(fn, 0)}
            rows.append({
                "name": f"{kernel_name}<{FAMILY_TYPES[pair]}>", "route": "cuda",
                "source": f"mppi_generic_tpu_torch/csrc/{lib}.cu",
                "replaces": f"mppi_generic_tpu/ops/{FAMILY_REPLACES[kind]}",
                "launches": sum(by.values()), "launches_by_path": by,
                "max_abs_err": max(e[err_kernel], e["flash_combine_kernel"]),
                "ms": t[mode]["ms"], "plain_ms": t[mode]["plain_ms"],
                "bound_ms": t[mode]["bound_ms"], "bound_by": t[mode]["bound_by"],
                "library_ms": t[mode]["library_ms"], "K": K_FAMILY, "T": T_FAMILY[pair],
                "modes": {m: t[m] for m in modes}})
    return rows


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
    # the earlier forms' builds (VARIANTS, for the A B B A of
    # warp_kernel_phase, ladder_form_phase and staged_form_phase) beside the
    # port's build, all nvcc's together
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        one_thread = pool.submit(build_one_thread)
        built = _build.build_all()
        one_thread_logs = one_thread.result()

    def ptxas(logs):
        keep = ("registers", "Compiling entry", "stack frame")
        return {name: [line.strip() for line in log.splitlines()
                       if any(k in line for k in keep)] for name, log in logs.items()}

    emit("build", seconds=time.perf_counter() - t0,
         ptxas=ptxas({name: b["log"] for name, b in built.items()}),
         one_thread_ptxas=ptxas(one_thread_logs))
    check_forms()
    # the redesigned forms first: B7's warp recursion and B4's staged form
    # against their plain versions and their one-thread builds
    form_checks = {LADDER: ladder_form_phase(dev)[0], B4_STAGED: staged_form_phase(dev)}
    # the tiled merge and the cluster cost pass against their plain versions
    # and their earlier one-block builds, A B B A at the paths' shapes
    forms_checks = merge_cost_forms_phase(dev)
    # the passes after the warp forms against their plain versions and their
    # earlier build, A B B A
    pass_checks = pass_forms_phase(dev)

    errs = dict.fromkeys(fr.launch_counts, 0.0)

    def note(kernel, checks):
        for c in checks:
            errs[kernel] = max(errs[kernel], c["max_abs_err"])

    note("flash_combine_kernel", [c for c in forms_checks if c["check"].startswith("merge")])
    for kernel, prefix in ((CARRY, "carry"), (MIN_PASS, "minima")):
        note(kernel, [c for c in pass_checks if c["check"].startswith(prefix)])

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
    note(BACKWARD, checks_b)
    note("riccati_ladder_kernel", checks_l)
    rmppi_times = None
    for K, seed, T_ in ((K_R, 3, T_R), (K_R_RAGGED, 4, T_R), (K_R_RAGGED, 5, 31)):
        checks, t = rmppi_phase(dev, K, seed, T_)
        note("rmppi_rollout_kernel", checks)
        rmppi_times = rmppi_times or t
    checks, x0_times = x0_phase(dev)
    note("rollout_costs_kernel", checks)
    errs["fused_sample_rollout_kernel"] = philox_phase(dev)
    solve_times = None
    for K, p, stride, seed in ((K_MAIN, 0.0, 0, 7), (K_RAGGED, 0.1, 2, 8)):
        b3_checks, b4_checks, times = fused_kernel_phase(dev, K, p, stride, seed)
        note("fused_solve_kernel", b3_checks)
        note("fused_sample_rollout_kernel", b4_checks)
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
            + [("cartpole", K_ZOO_RAGGED, 0.1, 2)]
            + [(pair, K, p, stride) for pair in RACER_PAIRS
               for K, p, stride in ((K_RC, 0.0, 0), (K_RC_RAGGED, 0.1, 2))]):
        by_kernel, times = zoo_kernel_phase(dev, pair, K, p, stride, 101 + i,
                                            timed_plain=K in (K_ZOO, K_RC))
        errs_p = zoo_errs.setdefault(pair, dict.fromkeys(by_kernel, 0.0))
        note_into(errs_p, by_kernel)
        zoo_times.setdefault(pair, times)
    division_phase(dev)

    reference_phase(dev)
    robust_reference_phase(dev)
    fused_reference_phase(dev)
    ar_reference_phase(dev)
    colored_reference_phase(dev)
    racer_reference_phase(dev)
    by_path = {"vanilla": vanilla_loop_phase("vanilla", build_vanilla("gaussian", "fused"), {
                   b1_kernel("di_circle"): CLOSED_LOOP_STEPS,
                   MERGE: CLOSED_LOOP_STEPS}, settle=True),
               "rmppi": robust_loop_phase("rmppi"),
               "tube": robust_loop_phase("tube")}
    for kind in SAMPLERS:
        by_path["vanilla_fused_solve" if kind == "gaussian" else kind] = (
            fused_loop_phase(kind))
    n, n_ar, n_f = CLOSED_LOOP_STEPS, AR_LOOP_STEPS, AR_FUSED_LOOP_STEPS
    ar_paths = {
        "autorally": ar_loop_phase("autorally", "128", "fused_solve", n_ar,
                                   solve_launches("ar_nn", n_ar)),
        # the same launches as "autorally": no profiler window of their own
        "autorally_1024": ar_loop_phase("autorally_1024", "1024", "fused_solve", n_f,
                                        solve_launches("ar_nn", n_f), profile=False),
        "autorally_fused": ar_loop_phase("autorally_fused", "128", "fused", n_f,
                                         rollout_launches("ar_nn", n_f), profile=False),
    }
    colored_paths = {
        "colored_fused": vanilla_loop_phase(
            "colored_fused", build_colored("exp", "fused"),
            {b1_kernel("di_circle"): n, MERGE: n}, settle=False),
        "colored_tsallis": vanilla_loop_phase(
            "colored_tsallis", build_colored("tsallis", "fused"),
            {b1_kernel("di_circle"): n, TSALLIS: n, MERGE: n}, settle=False),
    }
    nb = BICYCLE_LOOP_STEPS
    bicycle_paths = {
        "bicycle_colored": model_loop_phase(
            "bicycle_colored", build_bicycle("fused"), torch.zeros(S_BI, device=dev), nb,
            {b1_kernel("bicycle_ar"): nb, MERGE: nb}, map="128")[0],
    }
    row_paths = bench_row_loops(dev)
    bicycle_paths["bicycle_1024"] = row_paths["bicycle_1024"]
    by_path["di_K1024"] = row_paths["di_K1024"]
    zoo_paths = zoo_loops(dev)
    racer_paths = racer_loops(dev)
    # the robust family beyond the double integrator
    robust_checks, robust_times = robust_kernel_phase(dev)
    robust_reference_ar_phase(dev)
    robust_paths = robust_family_loops(dev)
    inst_paths, inst_checks = instantiations_phase(dev)
    # the split form: every entry at every shape a path launches it at, the
    # split loops, the tuner
    split_errs, split_times = {}, {}
    for pair, K, p, stride, seed, map_kind, timed_split in (
            ("di_circle", K_MAIN, 0.0, 0, 91, None, True),
            ("di_circle", K_RAGGED, 0.1, 2, 92, None, False),
            ("ar_nn", K_AR, 0.0, 0, 93, "128", True),
            ("ar_nn", K_AR_RAGGED, 0.1, 2, 94, "128", False),
            ("ar_nn", K_AR, 0.0, 0, 95, "partial", False)):
        checks, times = split_kernel_phase(dev, pair, K, p, stride, seed, map_kind,
                                           timed_split)
        split_errs[pair] = max([split_errs.get(pair, 0.0)]
                               + [c["max_abs_err"] for c in checks])
        if timed_split:
            split_times[pair] = times
    # the warp form of the network pairs' split dynamics passes; the ragged
    # case at K + 1 past the ragged K, so that the last block of AutoRally's
    # 4 samples (the racers' 8) is partly empty
    warp_errs, warp_times = {}, {}
    for i, pair in enumerate(WARP_PAIRS):
        K, K_rag, _ = pair_shape(pair)
        for K_, p, stride, timed_warp in ((K, 0.0, 0, True), (K_rag + 1, 0.1, 2, False)):
            checks, times = warp_kernel_phase(dev, pair, K_, p, stride, 301 + 2 * i + timed_warp,
                                              timed_warp)
            warp_errs[pair] = max([warp_errs.get(pair, 0.0)]
                                  + [c["max_abs_err"] for c in checks])
            if timed_warp:
                warp_times[pair] = times
    split_paths = split_loops(dev)
    # every pair on every kernel mode: the new entries, then their loops
    pair_errs, pair_times = pair_kernel_phases(dev)
    # the warp passes' own checks count in their pairs' split entries
    split_errs["ar_nn"] = max(split_errs["ar_nn"], warp_errs["ar_nn"])
    pair_errs[("split_x0", "ar_nn")] = max(pair_errs[("split_x0", "ar_nn")], warp_errs["ar_nn"])
    for pair in RACER_PAIRS:
        pair_errs[("split", pair)] = max(pair_errs[("split", pair)], warp_errs[pair])
    pair_paths = pair_loops(dev)
    autotune_phase(dev)
    # the robust family finished: the new entries, their loops, CCM and BoxQP
    finish_checks, finish_times = finish_kernel_phase(dev)
    finish_paths = finish_loops(dev)
    ccm_boxqp_phase(dev)
    # the rest of the racer family: its entries, then its loops
    racer_family_errs, racer_family_times = family_kernels(dev)
    racer_family_paths = family_loops(dev)
    all_paths = {**zoo_paths, **racer_paths, **robust_paths, **inst_paths, **split_paths,
                 **pair_paths}

    def inst_err(fn):
        return max((c["max_abs_err"] for c in inst_checks.get(fn, ())), default=0.0)

    def form_err(kernel, prefix):
        return max((c["max_abs_err"] for c in form_checks[kernel]
                    if c["check"].startswith(prefix)), default=0.0)

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
    # AutoRally's B1 on kernel="fused": its exp and Tsallis loops
    ar_b1_paths = {**ar_paths,
                   "autorally_tsallis_fused": pair_paths["autorally_tsallis_fused"][0]}
    # the loops that launch the warp form's minima pass
    min_paths = {p: l for p, l in {**ar_b1_paths, **{
        p: l for p, (l, _) in all_paths.items()}}.items() if l[MIN_PASS]}
    kernels = [
        entry(b1_kernel("di_circle"), "pair_di_circle.cu", "pallas_rollout.py:548", epi,
              epi["library_ms"], err=errs["rollout_costs_kernel"], modes=modes,
              **one_thread_fields("rollout", "di_circle")),
        entry(MERGE, "flash_combine.cu", "pallas_rollout.py:1005", comb, None,
              err=errs["flash_combine_kernel"], **earlier_fields("merge")),
        entry(BACKWARD, "riccati.cu", "pallas_riccati.py:137",
              ric_times["riccati_backward"], None, on_main_path=False,
              chain_steps=T_R - 1, **pass_fields("backward", f"({S}, {C})")),
        entry(LADDER, "riccati.cu", "pallas_riccati.py:203",
              ric_times["riccati_ladder"], None, chain_steps=T_R - 1,
              paths={**by_path, "rmppi_di_robust": robust_paths["rmppi_di_robust"][0],
                     "double_integrator_mppi": inst_paths["double_integrator_mppi"][0]},
              err=max([errs["riccati_ladder_kernel"], inst_err("riccati_ladder_di"),
                       form_err(LADDER, "B7 di ")]
                      + [c["max_abs_err"] for c in robust_checks["riccati_ladder_kernel"]
                         if c["check"].startswith(f"B7 di T={T_RDI}")]),
              modes={f"T={T_RDI} (rmppi_di_robust)": {
                  **robust_times[f"B7 di T={T_RDI}"], **ladder_fields(f"di T={T_RDI}")}},
              **ladder_fields(f"di T={T_R}")),
        entry(f"{split_name('di_circle', 'rmppi')}<DoubleIntegrator, "
              "DoubleIntegratorCircleCost>", "rmppi_rollout.cu", "pallas_rollout.py:2127",
              rmppi_times, None, err=errs["rmppi_rollout_kernel"],
              kernel=split_name("di_circle", "rmppi"), K=K_R, T=T_R,
              **one_thread_fields("rmppi", "di_circle")),
        entry(b3_kernel("di_circle"), "pair_di_circle.cu", "pallas_solve.py:103",
              solve_times["solve gaussian"], None,
              paths={**by_path,
                     "double_integrator_mppi": inst_paths["double_integrator_mppi"][0]},
              err=max(errs["fused_solve_kernel"], inst_err("fused_solve_di_circle")),
              modes={"nln": solve_times["solve nln"]},
              randn_reference_ms=solve_times["randn_reference_ms"],
              **one_thread_fields("solve", "di_circle")),
        entry(split_name("di_circle", "sample"), "pair_di_circle.cu", "pallas_rollout.py:1631",
              solve_times["smooth epilogue"], None,
              err=max(errs["fused_sample_rollout_kernel"], form_err(B4_STAGED, "di_circle ")),
              **one_thread_fields("sample", "di_circle"),
              modes={m: solve_times[m] for m in ("gaussian", "nln", "smooth")},
              randn_reference_ms=solve_times["randn_reference_ms"]),
        entry(f"{b3_kernel('ar_nn')}<AutorallyNN, ARCost>", "pair_ar_nn.cu",
              "pallas_solve.py:103", ar["B3 gaussian"], None,
              paths={**ar_paths, "tube_autorally": robust_paths["tube_autorally"][0],
                     "autorally_mppi": inst_paths["autorally_mppi"][0]},
              err=max(ar_errs["fused_solve_kernel"], inst_err("fused_solve_ar_nn")),
              kernel=b3_kernel("ar_nn"), K=K_AR, T=T_AR, device_functions=ar_functions,
              modes={"nln": ar["B3 nln"], "gaussian 1024^2 map": ar1024["B3 gaussian"],
                     "nln 1024^2 map": ar1024["B3 nln"]},
              **one_thread_fields("solve", "ar_nn")),
        entry(f"{b1_kernel('ar_nn')}<AutorallyNN, ARCost>", "pair_ar_nn.cu",
              "pallas_rollout.py:548", ar["B1 epilogue+lr"],
              ar["B1 epilogue+lr"]["library_ms"], paths=ar_b1_paths,
              err=ar_errs["rollout_costs_kernel"], kernel=b1_kernel("ar_nn"),
              K=K_AR, T=T_AR, device_functions=ar_functions,
              modes={**{m: ar[f"B1 {m}"] for m in ("costs", "costs+lr", "epilogue",
                                                   "tsallis+lr")},
                     **{f"{m} 1024^2 map": ar1024[f"B1 {m}"]
                        for m in ("costs", "costs+lr", "epilogue", "epilogue+lr",
                                  "tsallis+lr")}},
              **one_thread_fields("rollout", "ar_nn")),
        # the warp form's minima pass (Tsallis pass 1 of B1's warp form),
        # timed alone at AutoRally's shape
        entry(MIN_PASS, "block_pass.cuh",
              "pallas_rollout.py:894-965 (Tsallis pass 1's block minima, after B1's "
              "warp form)", ar[MIN_PASS], ar[MIN_PASS]["library_ms"],
              paths=min_paths, err=max(ar_errs["rollout_costs_kernel"], errs[MIN_PASS]),
              K=K_AR, **pass_fields("min")),
        entry(f"{MERGE} (AutoRally paths)", "flash_combine.cu",
              "pallas_rollout.py:1005", ar["flash_combine"], None, paths=ar_paths,
              err=ar_errs["flash_combine_kernel"], kernel=MERGE),
        # the colored rows: the rollout kernel's exp epilogue (colored_fused,
        # timed above at the same shapes) and its Tsallis pass 1
        # (colored_tsallis), the Tsallis reduction and the merge
        entry(f"{b1_kernel('di_circle')} (Tsallis pass 1; colored paths)", "pair_di_circle.cu",
              "pallas_rollout.py:894", ts_times["pass1"], None, paths=colored_paths,
              err=ts_errs["rollout_costs_kernel"], kernel=b1_kernel("di_circle"),
              modes={"epilogue+lr (colored_fused)": epi}),
        entry(TSALLIS, "tsallis_reduce.cu", "pallas_rollout.py:1342",
              ts_times["tsallis_reduce"], ts_times["tsallis_reduce"]["library_ms"],
              paths=colored_paths, earlier_form_abba=ts_times["tsallis_reduce"]["earlier"],
              err=max(ts_errs["tsallis_reduce_kernel"], bi_errs["tsallis_reduce_kernel"]),
              library_calls=ts_times["tsallis_reduce"]["library_calls"],
              modes={m: ts_times[m] for m in (
                  "tsallis_reduce entry (rho given, with the merge)",
                  "chain (pass 1, B5, merge)")}),
        entry(f"{MERGE} (colored and bicycle paths)", "flash_combine.cu",
              "pallas_rollout.py:1005", ts_times["merge"], None,
              paths={**colored_paths, **bicycle_paths},
              err=max(ts_errs["flash_combine_kernel"], bi_errs["flash_combine_kernel"]),
              kernel=MERGE),
        entry(f"{b1_kernel('bicycle_ar')}<BicycleSlip, ARCostBicycle>", "pair_bicycle_ar.cu",
              "pallas_rollout.py:548", bi_times["epilogue+lr"],
              bi_times["epilogue+lr"]["library_ms"], paths=bicycle_paths,
              err=bi_errs["rollout_costs_kernel"], kernel=b1_kernel("bicycle_ar"),
              K=K_BI, T=T_BI, **one_thread_fields("rollout", "bicycle_ar"),
              modes={m: bi_times[m] for m in ("costs", "costs+lr", "tsallis+lr")}),
    ]
    # the zoo's entries: launches counted per entry (fr.entry_counts) on the
    # zoo's loops and the factories' solves
    def zoo_entry(name, pair, fn, replaces, t, errs_p, kernel, paths=zoo_paths, **extra):
        by = {p: e.get(fn, 0) for p, (_, e) in {**paths, **inst_paths}.items()
              if e.get(fn, 0)}
        return {"name": name, "route": "cuda",
                "source": f"mppi_generic_tpu_torch/csrc/pair_{pair}.cu",
                "replaces": f"mppi_generic_tpu/ops/{replaces}",
                "launches": sum(by.values()), "launches_by_path": by,
                "max_abs_err": max(errs_p[kernel], inst_err(fn)),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
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
            f"{b1_kernel(pair)}<{types}>", pair, f"rollout_costs_{pair}",
            "pallas_rollout.py:548", t["B1 epilogue+lr"], e, "rollout_costs_kernel",
            K=K_ZOO, T=T_ZOO, modes=modes, **one_thread_fields("rollout", pair)))
        solve_modes = {m: t[m] for m in t if m.startswith("B3") and m != "B3 gaussian"}
        if pair == "dubins_quadratic":
            solve_modes["goal trajectory"] = zoo_times["dubins_trajectory"]["B3 gaussian"]
        kernels.append(zoo_entry(
            f"{b3_kernel(pair)}<{types}>", pair, f"fused_solve_{pair}",
            "pallas_solve.py:103", t["B3 gaussian"], e, "fused_solve_kernel",
            K=K_ZOO, T=T_ZOO, modes=solve_modes, **one_thread_fields("solve", pair)))
    kernels.append(zoo_entry(
        f"{split_name('cartpole', 'sample')}<Cartpole, CartpoleQuadraticCost>", "cartpole",
        "fused_sample_rollout_cartpole", "pallas_rollout.py:1631", cart["B4 smooth epilogue"],
        {**zoo_errs["cartpole"], "fused_sample_rollout_kernel": max(
            zoo_errs["cartpole"]["fused_sample_rollout_kernel"],
            form_err(B4_STAGED, "cartpole "))},
        "fused_sample_rollout_kernel", K=K_ZOO, T=T_ZOO,
        modes={m: cart[f"B4 {m}"] for m in ("gaussian", "nln", "smooth")},
        **one_thread_fields("sample", "cartpole")))
    merge_paths = {p: l for p, (l, _) in zoo_paths.items()}
    zoo_only = [e for pair, e in zoo_errs.items() if pair not in RACER_PAIRS]
    kernels.append(entry(
        f"{MERGE} (zoo paths)", "flash_combine.cu", "pallas_rollout.py:1005",
        ts_times["merge"], None, paths=merge_paths,
        err=max(e["flash_combine_kernel"] for e in zoo_only), kernel=MERGE))
    # the racer rows: the LSTM step (B10) and, for the steering row, the
    # elevation map's settling (B9) inside B1 and B3: device functions, not
    # launches of their own
    racer_functions = {
        "LSTMNet::forward (csrc/lstm.cuh)": "mppi_generic_tpu/nn/lstm.py:197, :174",
        "static_settling via map_query_world (csrc/racer_elevation.cuh, map_texture.cuh)":
            "mppi_generic_tpu/maps/texture.py:456",
    }
    racer_names = {"racer_steering_ar": "RacerLSTMSteering, ARCostRacer",
                   "racer_unc_ar": "RacerLSTMUnc, ARCostRacer"}
    for pair, types in racer_names.items():
        t, e = zoo_times[pair], zoo_errs[pair]
        kernels.append(zoo_entry(
            f"{b1_kernel(pair)}<{types}>", pair, f"rollout_costs_{pair}",
            "pallas_rollout.py:548", t["B1 epilogue+lr"], e, "rollout_costs_kernel",
            paths=racer_paths, K=K_RC, T=T_RACER[pair], device_functions=racer_functions,
            modes={m: t[f"B1 {m}"] for m in ("costs", "costs+lr", "tsallis+lr")},
            **one_thread_fields("rollout", pair)))
        kernels.append(zoo_entry(
            f"{b3_kernel(pair)}<{types}>", pair, f"fused_solve_{pair}",
            "pallas_solve.py:103", t["B3 gaussian"], e, "fused_solve_kernel",
            paths=racer_paths, K=K_RC, T=T_RACER[pair], device_functions=racer_functions,
            modes={"nln": t["B3 nln"]}, **one_thread_fields("solve", pair)))
    # the merge at the uncertainty row's shapes (30 rows of T=150, C=2), timed
    # in the AutoRally phase at the same shapes
    kernels.append(entry(
        f"{MERGE} (racer paths)", "flash_combine.cu", "pallas_rollout.py:1005",
        ar["flash_combine"], None, paths={p: l for p, (l, _) in racer_paths.items()},
        err=max(zoo_errs[pair]["flash_combine_kernel"] for pair in RACER_PAIRS),
        kernel=MERGE))
    # the robust family: launches counted per C entry on its loops and the
    # factories' solves
    family_paths = {**robust_paths, **inst_paths, **finish_paths}

    def family_entry(name, source, fn, replaces, t, checks, **extra):
        by = {p: e.get(fn, 0) for p, (_, e) in family_paths.items() if e.get(fn, 0)}
        return {"name": name, "route": "cuda",
                "source": f"mppi_generic_tpu_torch/csrc/{source}",
                "replaces": f"mppi_generic_tpu/ops/{replaces}",
                "launches": sum(by.values()), "launches_by_path": by,
                "max_abs_err": max([c["max_abs_err"] for c in checks] + [inst_err(fn)]),
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None, **extra}

    def rchecks(kernel, prefix):
        return [c for c in robust_checks[kernel] if c["check"].startswith(prefix)]

    rt = robust_times
    kernels += [
        family_entry(f"{split_name('ar_nn', 'rmppi')}<AutorallyNNRolled, ARCost>",
                     "rmppi_rollout.cu", "rmppi_rollout_ar_nn", "pallas_rollout.py:2127",
                     rt["B8 ar_nn 128"], rchecks("rmppi_rollout_kernel", "B8 ar_nn"), K=K_AR,
                     T=T_AR, device_functions=ar_functions,
                     modes={"partly-crashing map": rt["B8 ar_nn partial"]},
                     **one_thread_fields("rmppi", "ar_nn")),
        family_entry(f"{split_name('di_robust', 'rmppi')}<DoubleIntegrator, "
                     "DoubleIntegratorRobustCost>",
                     "rmppi_rollout.cu", "rmppi_rollout_di_robust", "pallas_rollout.py:2127",
                     rt[f"B8 di_robust K={K_RDI} T={T_RDI}"],
                     rchecks("rmppi_rollout_kernel", "B8 di_robust"), K=K_RDI, T=T_RDI,
                     modes={f"K={K} T={T_}": rt[f"B8 di_robust K={K} T={T_}"]
                            for K, T_ in ((K_R, T_R), (K_R_RAGGED, T_R), (K_RDI - 6, T_RDI),
                                          (K_RDI - 6, 31))},
                     **one_thread_fields("rmppi", "di_robust")),
        family_entry(f"{b1_kernel('ar_nn', x0=True)}<AutorallyNN, ARCost> (per-sample x0)",
                     "rollout_x0.cu", "rollout_costs_x0_ar_nn", "pallas_rollout.py:548",
                     rt["B1-x0 ar_nn 128"], rchecks("rollout_costs_kernel", "B1-x0 ar_nn"),
                     K=N_CAND_AR * S_PER_AR, T=T_AR, device_functions=ar_functions,
                     modes={"partly-crashing map": rt["B1-x0 ar_nn partial"]},
                     **one_thread_fields("rollout_x0", "ar_nn")),
        family_entry(f"{b1_kernel('bicycle_ar', x0=True)}<BicycleSlip, ARCostBicycle> "
                     "(per-sample x0)",
                     "rollout_x0.cu", "rollout_costs_x0_bicycle_ar", "pallas_rollout.py:548",
                     rt["B1-x0 bicycle_ar 128"],
                     rchecks("rollout_costs_kernel", "B1-x0 bicycle_ar"),
                     K=N_CAND_AR * S_PER_AR, T=T_BI),
        family_entry(f"{b1_kernel('di_robust', x0=True)}<DoubleIntegrator, "
                     "DoubleIntegratorRobustCost> (per-sample x0)", "rollout_x0.cu",
                     "rollout_costs_x0_di_robust",
                     "pallas_rollout.py:548",
                     rt[f"B1-x0 di_robust {N_CAND_AR * S_PER_AR} x {T_R}"],
                     rchecks("rollout_costs_kernel", "B1-x0 di_robust"),
                     K=N_CAND_AR * S_PER_AR, T=T_R,
                     modes={f"{N_CAND_AR * S_PER_RDI} x {T_RDI} (rmppi_di_robust)":
                            rt[f"B1-x0 di_robust {N_CAND_AR * S_PER_RDI} x {T_RDI}"]}),
        family_entry(f"{LADDER}<AutorallyNNRolled>", "riccati.cu",
                     "riccati_ladder_ar_nn", "pallas_riccati.py:203", rt["B7 ar_nn"],
                     rchecks("riccati_ladder_kernel", "B7 ar_nn")
                     + [c for c in form_checks[LADDER] if c["check"].startswith("B7 ar_nn")],
                     T=T_AR, n_alpha=N_ALPHA, chain_steps=T_AR - 1,
                     device_functions=ar_functions, **ladder_fields(f"ar_nn T={T_AR}")),
        family_entry(f"{LADDER}<Cartpole>", "riccati.cu",
                     "riccati_ladder_cartpole", "pallas_riccati.py:203", rt["B7 cartpole"],
                     rchecks("riccati_ladder_kernel", "B7 cartpole")
                     + [c for c in form_checks[LADDER] if c["check"].startswith("B7 cartpole")],
                     T=T_ZOO, n_alpha=N_ALPHA, chain_steps=T_ZOO - 1,
                     **ladder_fields(f"cartpole T={T_ZOO}")),
        family_entry(f"{BACKWARD}<4, 1>", "riccati.cu", "riccati_backward_s4c1",
                     "pallas_riccati.py:137", rt["B6 (4, 1)"],
                     rchecks("riccati_backward_kernel", "B6 (4, 1)"),
                     T=T_ZOO, chain_steps=T_ZOO - 1, on_main_path=False,
                     **pass_fields("backward", "(4, 1)")),
        family_entry(f"{BACKWARD}<7, 2>", "riccati.cu", "riccati_backward_s7c2",
                     "pallas_riccati.py:137", rt["B6 (7, 2)"],
                     rchecks("riccati_backward_kernel", "B6 (7, 2)"),
                     T=T_AR, chain_steps=T_AR - 1, on_main_path=False,
                     **pass_fields("backward", "(7, 2)")),
    ]
    # the split form: one entry per kernel and pair; launches counted per C
    # entry on the split loops
    def split_entry(name, pair, fn, replaces, t, warp_key=None, **extra):
        by = {p: e.get(fn, 0) for p, (_, e) in all_paths.items() if e.get(fn, 0)}
        if warp_key is not None and pair in WARP_PAIRS:
            t, more = warp_fields(t, warp_times[pair], warp_key, by)
            extra.update(more)
        return {"name": name, "route": "cuda",
                "source": f"mppi_generic_tpu_torch/csrc/split_{pair}.cu",
                "replaces": f"mppi_generic_tpu/ops/{replaces}",
                "launches": sum(by.values()), "launches_by_path": by,
                "max_abs_err": split_errs[pair], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"), **extra}

    def forms(times, prefix):
        """The whole split form of each mode, A B B A against the combined
        kernel in the same call."""
        keys = ("ms", "combined_ms", "abba_ms", "split_faster", "bound_ms", "library_ms")
        return {m[len(prefix):]: {k: t.get(k) for k in keys}
                for m, t in times.items() if m.startswith(prefix)}

    for pair, dyn_name, cost_name, K, T_ in (
            ("di_circle", "DoubleIntegrator", "DoubleIntegratorCircleCost", K_MAIN, T),
            ("ar_nn", "AutorallyNN", "ARCost", K_AR, T_AR)):
        st = split_times[pair]
        kernels += [
            split_entry(f"{split_name(pair, 'split_dynamics')}<{dyn_name}>",
                        pair, f"split_dynamics_{pair}",
                        "pallas_rollout.py:548 (split mode, run_tile :663-696)",
                        st["B1 split epilogue+lr"]["dynamics_pass"], warp_key="B1 dynamics",
                        K=K, T=T_, split_form=forms(st, "B1 split "),
                        **one_thread_fields("split_dynamics", pair)),
            split_entry(f"{split_name(pair, 'split_solve_dynamics')}"
                        f"<{dyn_name}>", pair, f"split_solve_dynamics_{pair}",
                        "pallas_solve.py:103 (split mode :274-290)",
                        st["B3 split gaussian"]["dynamics_pass"],
                        warp_key="B3 dynamics gaussian", K=K, T=T_,
                        modes={"nln": (warp_times[pair]["B3 dynamics nln"] if pair in WARP_PAIRS
                                       else st["B3 split nln"]["dynamics_pass"])},
                        split_form=forms(st, "B3 split "),
                        **one_thread_fields("split_solve_dynamics", pair)),
            split_entry(f"{cost_kernel(pair, K, T_)}<{cost_name}>", pair, f"split_cost_{pair}",
                        "pallas_rollout.py:698-768 and pallas_solve.py:292-332 "
                        "(the split cost pass)",
                        st["B1 split epilogue+lr"]["cost_pass"], K=K, T=T_,
                        **earlier_fields("cost", pair),
                        modes={**{f"B1 {m}": st[f"B1 split {m}"]["cost_pass"]
                                  for m in ("costs", "costs+lr", "tsallis+lr")},
                               **{f"B3 {k}": st[f"B3 split {k}"]["cost_pass"]
                                  for k in ("gaussian", "nln")}}),
        ]
    kernels.append(entry(
        f"{MERGE} (split paths)", "flash_combine.cu", "pallas_rollout.py:1005",
        comb, None, paths={p: l for p, (l, _) in split_paths.items()},
        err=errs["flash_combine_kernel"], kernel=MERGE))
    for pair in STAGED_PAIRS:  # the staged form's own checks count in B4's entries
        if ("sample", pair) in pair_errs:
            pair_errs[("sample", pair)] = max(pair_errs[("sample", pair)],
                                              form_err(B4_STAGED, f"{pair} "))
    pair_errs[CARRY] = errs[CARRY]  # the carry pass's own checks
    kernels += pair_kernel_entries(pair_errs, pair_times, all_paths, warp_times,
                                   carry_paths=ar_paths)
    kernels += finish_entries(finish_checks, finish_times, finish_paths)
    kernels += family_entries(racer_family_errs, racer_family_times, racer_family_paths)
    for k in kernels:  # the loops that reach the kernel only by forcing a form
        k["forced_by_path"] = {p: FORCED_BY_PATH[p] for p in k.get("launches_by_path", {})
                               if FORCED_BY_PATH.get(p)}
    emit("total", seconds=time.perf_counter() - T_START)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
