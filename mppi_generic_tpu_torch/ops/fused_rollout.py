"""Fused rollout kernels, their wrappers and plain versions.

Counterpart of ``mppi_generic_tpu/ops/pallas_rollout.py``: the hand-written
Hopper kernel ``rollout_costs_kernel`` (``csrc/rollout_kernel.cuh``) replaces
its TPU kernel ``_fused_call`` in three modes, with
``flash_combine_tiled_kernel`` (``csrc/flash_combine.cu``: blocks of columns,
the carry rows staged in shared memory) as the merge of its epilogue;
``tsallis_reduce_tiled_kernel`` (``csrc/tsallis_reduce.cu``: a grid of
sample blocks and column tiles, each block's slab of the samples staged in
shared memory) its TPU kernel ``_tsallis_reduce_call``, the one
in ``csrc/rmppi_kernel.cuh`` its TPU kernel ``_fused_rmppi_call``, and
``fused_sample_rollout_kernel`` (``csrc/sample_kernels.cuh``) its TPU kernel
``_fused_sample_call``. For the network models B4, B3, B1, B8 and the split
dynamics passes run a warp form, one warp per sample
(``csrc/sample_warp.cuh``, ``csrc/rollout_kernel.cuh``,
``csrc/rmppi_warp.cuh``, ``csrc/split_warp.cuh``);
for every other model B4, B3 and B1 run their staged forms, producer warps
making each chunk of steps' state-free inputs for consumer threads
(``csrc/sample_staged.cuh``); each launch is counted under the name its
entry reports (``form_kernel_name``).

* ``fused_rollout_costs``: per sample, a T-step rollout with running cost,
  terminal cost and (with ``lr_params``) the Gaussian likelihood-ratio cost
  accumulated in the loop. Returns (costs (K,), crash (K,)). ``x0`` is one
  state (S,) for all samples or one per sample (K, S) (RMPPI's candidate
  evaluation).
* ``fused_weighted_rollout``: the same, plus the online-softmax normExp
  epilogue. Kernel 1 reduces each block of samples into a carry row
  (m_b, d_b, num_b); kernel 2 (``flash_combine``) merges the rows into the
  new mean, baseline = -lambda * max(-J / lambda) and eta. With
  ``weight_kind="tsallis"`` the weights need the global minimum cost rho
  before any of them exists, so the epilogue takes two passes: kernel 1
  writes the costs and each block's minimum, the Tsallis reduction kernel
  (``tsallis_block_rows``) merges the minima into rho and writes one row
  (0, sum w, sum w U) per block, and the merge sums the rows in order.
* ``tsallis_reduce``: the reduction kernel against a given device rho,
  (sum w U, eta), for a rho merged elsewhere (across devices).
* ``fused_rmppi_rollout``: RMPPI's augmented rollout, the nominal and the
  real system of each sample stepped together, the real one with the DDP
  feedback K[t] (x_real - x_nom) in the loop.
* the split form (``split_cost``): ``fused_rollout_costs``,
  ``rollout_block_carries``, ``rollout_block_minima`` and
  ``fused_weighted_rollout`` take ``split_cost`` (JAX ``pallas_split_cost``):
  True runs the split kernels of ``csrc/split_kernels.cuh`` (a dynamics-only
  pass writing the outputs Y, then a cost pass over chunks of steps, a
  thread-block cluster for each 64-sample block while the blocks are few,
  with a sticky crash by dual evaluation and a prefix OR, and the mode's
  epilogue), False the combined kernel, None (AUTO) what
  ``resolve_split`` picks: the combined kernel unless the cost declares
  ``time_parallel_cost`` or ``time_parallel_crash`` and ``AUTO_SPLIT``,
  measured on the H100, takes the split for the pair. True for an
  ineligible cost raises ``KernelIncompatible``, as JAX raises
  ``PallasIncompatible`` (``QuadrotorMapCost``, a ``QuadraticCost`` goal
  trajectory). Every pair of ``_PAIRS`` whose cost is eligible has split
  entries, from one x0 and from one x0 per sample (RMPPI's candidates). The
  plain version is ``split_rollout_plain``.
* ``fused_sample_rollout_costs``: the samples drawn inside the kernel
  (Philox, ``ops/philox.py``) for the Gaussian, NLN and Smooth-MPPI
  samplers, with their carve-outs, the clamp, the per-step LR cost and the
  rollout; optionally (Smooth-MPPI) the flash epilogue over the derivative
  samples W. The helpers of the in-kernel draw (``noise_kind``, the tables,
  ``sample_plain``) are shared with ``ops/fused_solve.py``.

The rollout and sampling kernels are templates over the (dynamics, cost)
pair; each pair with an entry has its own source ``csrc/pair_<name>.cu`` and
library (``_PAIRS`` names them, ``_build.PAIR_KERNELS`` lists each pair's
kernels): the double integrator with its circle cost or ``QuadraticCost``;
AutoRally's network dynamics with the standard or robust AutoRally cost (the
FNN and the track costmap inside the kernel); the bicycle-slip model with
the AutoRally costs on its output layout; the cartpole with its quadratic
cost; the quadrotor with ``QuadrotorQuadraticCost`` or ``QuadrotorMapCost``;
the Dubins car with ``QuadraticCost``; the racer LSTM-steering model on its
elevation map and the racer LSTM-uncertainty model on flat ground or an
elevation map, each with ``ARStandardCost`` on the racer output layout (the
LSTM step, B10, inside the kernel, its (h, c) carried through the horizon
loop). Each of them has B1, B3 and B4, and the per-sample-x0 rollout; every
pair but the two racer LSTMs, which the JAX kernel refuses there, has the
RMPPI kernel. The rest of the racer family has B1, B3 and B4: RACER Dubins,
its elevation model without an LSTM, ``RacerSuspensionDynamics``, the
bicycle on its elevation map (``BicycleSlipParametricElevation``; with a
normals map ``refuse_model`` raises ``KernelIncompatible``) and the
suspension model with its steering LSTM, each with ``ARStandardCost`` on the
layout of the JAX package's kernel test of it. Each pair reads its parameters
through ``Dynamics.kernel_params``, ``Dynamics.kernel_map`` (the racer
elevation map) and ``Cost.kernel_map`` besides the cost's ``params`` table.

A recurrent model's (h, c) start from its ``init_recurrent_state`` (the
warm state, the same for every sample) and ride the loop beside the state.

Each wrapper runs the kernel for CUDA tensors and the plain PyTorch version
(``*_plain``, in this module, with the same arithmetic) for CPU tensors.
The plain versions step with ``Dynamics.kernel_step_recurrent``, the
model's step in the kernels' order of operations.
There is no fallback inside the wrappers: a CUDA tensor the kernel does not
take raises. Every launch adds one to ``launch_counts`` under the kernel's
name. Where the JAX package's kernels raise ``PallasIncompatible`` for what
they compute (a recurrent model in B8, ``split_cost=True`` with an
ineligible cost, a weight kind or a sampler the kernels do not take,
Smooth-MPPI without its state) the wrappers raise ``KernelIncompatible``,
checked before any launch and on every device, and the controllers run
their eager path there, as the JAX controllers run XLA. A pair the JAX
package runs in its kernel and the port has no entry for raises a plain
``NotImplementedError`` on the card, which no controller catches.

``lr_params`` is ``(mean (T, C), sigma (T, C), coeff (C,), lam, alpha,
pure_threshold)`` as in the JAX package: tensors on the samples' device and
host floats.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mppi_generic_tpu_torch.costs.autorally import ARRobustCost, ARStandardCost
from mppi_generic_tpu_torch.costs.cartpole import CartpoleQuadraticCost
from mppi_generic_tpu_torch.costs.double_integrator import (
    DoubleIntegratorCircleCost,
    DoubleIntegratorRobustCost,
)
from mppi_generic_tpu_torch.costs.quadratic import QuadraticCost
from mppi_generic_tpu_torch.costs.quadrotor import QuadrotorMapCost, QuadrotorQuadraticCost
from mppi_generic_tpu_torch.models.autorally import AutorallyNNDynamics
from mppi_generic_tpu_torch.models.base import broadcast_rec
from mppi_generic_tpu_torch.models.bicycle_slip import (
    BicycleSlipDynamics,
    BicycleSlipParametricElevation,
)
from mppi_generic_tpu_torch.models.cartpole import CartpoleDynamics
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.models.dubins import DubinsDynamics
from mppi_generic_tpu_torch.models.quadrotor import QuadrotorDynamics
from mppi_generic_tpu_torch.models.racer_dubins import RacerDubinsDynamics
from mppi_generic_tpu_torch.models.racer_dubins_elevation import (
    RacerDubinsElevationDynamics,
    RacerDubinsElevationLSTMSteering,
)
from mppi_generic_tpu_torch.models.racer_dubins_unc import (
    RacerDubinsElevationLSTMUncertainty,
    RacerDubinsElevationSuspension,
)
from mppi_generic_tpu_torch.models.racer_suspension import RacerSuspensionDynamics
from mppi_generic_tpu_torch.ops import _build, philox
from mppi_generic_tpu_torch.ops._build import entry_counts, launch_counts, reset_launch_counts
from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution
from mppi_generic_tpu_torch.sampling.nln import NLNDistribution
from mppi_generic_tpu_torch.sampling.smooth import SmoothMPPIDistribution
from mppi_generic_tpu_torch.utils.math_utils import true_div

__all__ = [
    "AUTO_SPLIT",
    "KernelIncompatible",
    "flash_combine",
    "fused_rmppi_rollout",
    "fused_rollout_costs",
    "fused_sample_rollout_costs",
    "fused_weighted_rollout",
    "launch_counts",
    "reset_launch_counts",
    "resolve_split",
    "rollout_block_carries",
    "rollout_block_minima",
    "split_rollout_plain",
    "tsallis_block_rows",
    "tsallis_reduce",
]

class KernelIncompatible(NotImplementedError, ValueError):
    """What a kernel does not compute, found before any launch and on every
    device: the counterpart of the JAX package's ``PallasIncompatible``,
    raised only under its semantic conditions (a recurrent model in B8,
    ``split_cost=True`` with an ineligible cost, a weight kind the epilogue
    does not take, a sampler the in-kernel draw does not take, Smooth-MPPI
    without its state). The controllers catch it and run their eager path,
    as the JAX controllers run XLA. A ``NotImplementedError``, so the kernel
    tuner skips such a candidate; a ``ValueError``, as the wrappers raised
    for these inputs before. A missing pair entry or a failed build is not
    one of these, and nothing catches it."""


# samples per block of the rollout and sampling kernels (kBlockSamples in
# csrc/mppi_common.cuh): one epilogue row per block
BLOCK = 64
_MASKED = -1e30
# a sample past K in the Tsallis pass-1 minimum (the TPU kernel's 1e30)
_MIN_PAD = 1e30
# the rollout kernel's epilogue modes (epilogue in csrc/rollout_kernel.cuh)
EPI_NONE, EPI_EXP, EPI_MIN = 0, 1, 2

# (dynamics, cost) -> the pair's name: its kernels are in the library of
# csrc/pair_<name>.cu (_build.PAIR_KERNELS lists which)
_PAIRS = {
    (DoubleIntegratorDynamics, DoubleIntegratorCircleCost): "di_circle",
    (DoubleIntegratorDynamics, DoubleIntegratorRobustCost): "di_robust",
    (AutorallyNNDynamics, ARStandardCost): "ar_nn",
    (AutorallyNNDynamics, ARRobustCost): "ar_nn",
    (BicycleSlipDynamics, ARStandardCost): "bicycle_ar",
    (BicycleSlipDynamics, ARRobustCost): "bicycle_ar",
    (CartpoleDynamics, CartpoleQuadraticCost): "cartpole",
    (QuadrotorDynamics, QuadrotorQuadraticCost): "quadrotor_quadratic",
    (QuadrotorDynamics, QuadrotorMapCost): "quadrotor_map",
    (DubinsDynamics, QuadraticCost): "dubins_quadratic",
    (DoubleIntegratorDynamics, QuadraticCost): "di_quadratic",
    (RacerDubinsElevationLSTMSteering, ARStandardCost): "racer_steering_ar",
    (RacerDubinsElevationLSTMUncertainty, ARStandardCost): "racer_unc_ar",
    (RacerDubinsDynamics, ARStandardCost): "racer_dubins_ar",
    (RacerDubinsElevationDynamics, ARStandardCost): "racer_elevation_ar",
    (RacerSuspensionDynamics, ARStandardCost): "racer_suspension_ar",
    (BicycleSlipParametricElevation, ARStandardCost): "bicycle_elevation_ar",
    (RacerDubinsElevationSuspension, ARStandardCost): "racer_elev_susp_ar",
}
# what a pair's entries are compiled for, beyond the classes: the AutoRally
# cost's output_indices (the ARCostT template arguments) and QuadraticCost's
# output dimension (QuadraticCostT<O>)
_COST_LAYOUT = {
    "ar_nn": ("output_indices", (0, 1, 2, 3, 4, 5)),
    "bicycle_ar": ("output_indices", (0, 1, 2, 8, 5, 6)),
    "dubins_quadratic": ("OUTPUT_DIM", 3),
    "di_quadratic": ("OUTPUT_DIM", 4),
    "racer_steering_ar": ("output_indices", (2, 3, 5, 6, 0, 1)),
    "racer_unc_ar": ("output_indices", (2, 3, 5, 6, 0, 1)),
    # the layouts of the JAX package's own kernel tests of these models
    # (tests/test_windowed_maps.py:327, test_pallas_rollout.py:497,
    # test_suspension_models.py:159, :181)
    "racer_dubins_ar": ("output_indices", (2, 3, 5, 6, 0, 1)),
    "racer_elevation_ar": ("output_indices", (2, 3, 5, 6, 0, 1)),
    "racer_elev_susp_ar": ("output_indices", (2, 3, 5, 6, 0, 1)),
    "bicycle_elevation_ar": ("output_indices", (2, 3, 5, 6, 0, 1)),
    "racer_suspension_ar": ("output_indices", (0, 1, 5, 6, 3, 4)),
}
_KERNEL_NAMES = {"rollout": "rollout", "rollout_x0": "per-sample x0 rollout",
                 "solve": "solve", "sample": "sampling", "rmppi": "RMPPI rollout",
                 "split_dynamics": "split dynamics pass",
                 "split_solve_dynamics": "split solve dynamics pass",
                 "split_cost": "split cost pass",
                 "split_dynamics_x0": "split dynamics pass from one x0 per sample"}

# The split form under split_cost=None (AUTO), per (pair, kernel): "rollout"
# is B1 with one x0 for all samples (decided on its epilogue + LR mode, the
# main path's), "rollout_x0" B1 with one x0 per sample (RMPPI's candidates),
# "solve" B3 (Gaussian). True where both split times were below both
# combined times of an A B B A turn in one call on an H100 80GB HBM3 at
# 700 W (chip_smoke.py's split_kernels, pair_kernels and split_x0 phases,
# at the paths' shapes; the times are in PERF.md), in ms, split against
# combined. The pairs without a network step, their split dynamics passes
# on the staged ring (csrc/split_staged.cuh; the bicycle's B1 pass its
# lane-group form), against their staged combined kernels
# (scripts/torch_split_staged_abba.py): DI B1 0.0237 / 0.0234, B3 0.0506 /
# 0.0396; cartpole B1 0.0381 / 0.0289, B3 0.0582 / 0.0424; quadrotor
# quadratic B1 0.0932 / 0.0829, B3 0.1122 / 0.1010; DI quadratic B1 0.0226 /
# 0.0158, B3 0.0603 / 0.0373; Dubins quadratic B1 0.0374 / 0.0313, B3 0.0629
# / 0.0477; bicycle B1 0.0874 / 0.1457, B3 0.1076 / 0.1601 [0.1600, 0.1602];
# DI robust B1-x0 0.0122 / 0.0130 [0.0130, 0.0130] (9 x 64 x 48). The
# network pairs, whose
# split dynamics passes run one warp per sample (csrc/split_warp.cuh),
# against the combined kernel's warp form, one warp a sample with its
# epilogue pass (B1: csrc/rollout_kernel.cuh,
# scripts/torch_network_rollout_abba.py, epilogue + LR, B1-x0 costs; B3:
# csrc/sample_warp.cuh, scripts/torch_network_solve_abba.py, Gaussian; the
# combined A B B A turns in brackets): AutoRally B1 0.2600 / 0.3392
# [0.3392, 0.3392], B1-x0 0.3111 / 0.4147 [0.4146, 0.4149] (9 x 256 x 150);
# racer steering B1 0.4759 / 0.5658 [0.5659, 0.5658]; racer uncertainty B1
# 1.3989 / 1.0529 [1.0490, 1.0569]; B3: AutoRally 0.3867 / 0.3784 [0.3782,
# 0.3787], racer steering 0.5504 / 0.5761 [0.5761, 0.5760], racer
# uncertainty 1.5249 / 1.0652 [1.0652, 1.0652]. So the bicycle's B1 and B3,
# the DI robust cost's B1-x0, AutoRally's B1 and B1-x0 and racer steering's
# B1 and B3 split. The entries of the finished robust family
# (chip_smoke.py's finish_kernels, the whole split form against the combined
# kernel at the loops' shapes; B1-x0 costs mode over 9 x 256 candidates'
# samples, the DI robust cost's B1 epilogue + LR and B3 Gaussian at 8192 x
# 100), split / combined [the combined A B B A turns]: DI circle B1-x0 (T=50)
# 0.01214 / 0.01277 [0.01277, 0.01277]; cartpole B1-x0 0.03679 / 0.02578;
# quadrotor quadratic B1-x0 0.07030 / 0.07573 [0.07571, 0.07574]; Dubins
# B1-x0 0.03594 / 0.02816; DI quadratic B1-x0 0.02027 / 0.01154; bicycle
# B1-x0 0.09310 / 0.14187 [0.14186, 0.14189]; racer steering B1-x0 0.65921 /
# 0.78005 [0.78005, 0.78005]; racer uncertainty B1-x0 (T=150) 2.30674 /
# 1.77622; DI robust B1 0.02347 / 0.02509 [0.02509, 0.02509], B3 0.05006 /
# 0.04024. So the DI circle, quadrotor quadratic, bicycle and racer
# steering B1-x0 and the DI robust cost's B1 split too. Any other pair or
# kernel keeps the combined kernel.
AUTO_SPLIT = {
    ("di_circle", "rollout"): False,
    ("di_circle", "solve"): False,
    ("ar_nn", "rollout"): True,
    ("ar_nn", "solve"): False,
    ("ar_nn", "rollout_x0"): True,
    ("cartpole", "rollout"): False,
    ("cartpole", "solve"): False,
    ("quadrotor_quadratic", "rollout"): False,
    ("quadrotor_quadratic", "solve"): False,
    ("di_quadratic", "rollout"): False,
    ("di_quadratic", "solve"): False,
    ("dubins_quadratic", "rollout"): False,
    ("dubins_quadratic", "solve"): False,
    ("bicycle_ar", "rollout"): True,
    ("bicycle_ar", "solve"): True,
    ("racer_steering_ar", "rollout"): True,
    ("racer_steering_ar", "solve"): True,
    ("racer_unc_ar", "rollout"): False,
    ("racer_unc_ar", "solve"): False,
    ("di_robust", "rollout_x0"): True,
    ("di_robust", "rollout"): True,
    ("di_robust", "solve"): False,
    ("di_circle", "rollout_x0"): True,
    ("cartpole", "rollout_x0"): False,
    ("quadrotor_quadratic", "rollout_x0"): True,
    ("dubins_quadratic", "rollout_x0"): False,
    ("di_quadratic", "rollout_x0"): False,
    ("bicycle_ar", "rollout_x0"): True,
    ("racer_steering_ar", "rollout_x0"): True,
    ("racer_unc_ar", "rollout_x0"): False,
}


def refuse_model(dynamics):
    """Raise ``KernelIncompatible`` for a model no kernel computes, before
    any launch and on every device: a ``BicycleSlipParametricElevation``
    with a normals map (its gravity terms read a 3-channel map, which the
    JAX package's kernel cannot query either; its eager path runs it)."""
    if getattr(dynamics, "normals_map", None) is not None:
        raise KernelIncompatible(
            f"{type(dynamics).__name__} with a normals_map has no kernel (its normals "
            "query reads a 3-channel map): the eager path runs it")


def _entry(dynamics, cost, kind):
    """(library, C function) of kernel ``kind`` (a kind of
    ``_build.PAIR_KERNELS``) for this (dynamics, cost) pair; raises
    NotImplementedError for a pair without one."""
    pair = _PAIRS.get((type(dynamics), type(cost)))
    entry = None if pair is None else _build.pair_entry(pair, kind)
    if entry is None:
        raise NotImplementedError(
            f"no CUDA {_KERNEL_NAMES[kind]} kernel for {type(dynamics).__name__} "
            f"with {type(cost).__name__}")
    return entry


# the samplers whose noise the fused sampling kernels draw (noise_kind in
# csrc/sample_kernels.cuh)
GAUSSIAN, NLN, SMOOTH = 0, 1, 2
_NOISE_KIND = {GaussianDistribution: GAUSSIAN, NLNDistribution: NLN,
               SmoothMPPIDistribution: SMOOTH}


def _f32(v) -> float:
    return float(np.float32(v))




def _tsallis_pw(r) -> float:
    """1 / (r - 1) in float32, as the TPU kernel's wrapper forms it
    (pallas_rollout.py:1589): the kernels multiply by it."""
    return _f32(np.float32(1.0) / (np.float32(r) - np.float32(1.0)))


def _lr_gain(lam, alpha) -> float:
    """0.5 * lambda * (1 - alpha) in float32, as the TPU kernel forms it."""
    return _f32(np.float32(0.5) * np.float32(lam)
                * (np.float32(1.0) - np.float32(alpha)))


def split_eligible(cost) -> bool:
    """Whether the split form may run ``cost``: it declares
    ``time_parallel_cost`` or ``time_parallel_crash``."""
    return bool(cost.time_parallel_cost()) or bool(cost.time_parallel_crash())


def resolve_split(dynamics, cost, split_cost, kernel="rollout") -> bool:
    """The split choice of one launch (JAX ``_arbitrate_split``): True
    raises ValueError for an ineligible cost, False never splits, None
    (AUTO) splits an eligible cost where ``AUTO_SPLIT`` says so for the pair
    and ``kernel`` ("rollout", "rollout_x0" or "solve"); the refusal is a
    ``KernelIncompatible``, as JAX's is a ``PallasIncompatible``
    (pallas_rollout.py:273). The same on every
    device, so the plain versions run what the kernels run. A choice forced
    against AUTO counts in ``_build.forced_routes``."""
    eligible = split_eligible(cost)
    if split_cost is True and not eligible:
        raise KernelIncompatible(
            f"{type(cost).__name__} declares neither time_parallel_cost() nor "
            "time_parallel_crash(): the split cost pass needs a time-"
            "broadcastable cost whose crash is unused or sticky-prefix")
    if split_cost is not None and split_cost is not False and split_cost is not True:
        raise ValueError(f"split_cost must be None, True or False, got {split_cost!r}")
    auto = bool(eligible) and AUTO_SPLIT.get(
        (_PAIRS.get((type(dynamics), type(cost))), kernel), False)
    if split_cost is None or split_cost == auto:
        return auto
    route = "split" if split_cost else "combined"
    _build.forced_routes[route] = _build.forced_routes.get(route, 0) + 1
    return split_cost


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def rollout_costs_plain(dynamics, cost, x0, U, dt, lr_params=None):
    """Plain version of kernel 1's rollout: (costs (K,), crash (K,) int32),
    the same operations in the same order as the kernel's thread loop.
    ``x0`` is (S,) or (K, S)."""
    K, T, C = U.shape
    Uc = U.permute(2, 1, 0)  # (C, T, K)
    x = x0.T if x0.dim() == 2 else x0[:, None].expand(-1, K)
    rec = broadcast_rec(dynamics.init_recurrent_state(), K)
    crash = torch.zeros((K,), dtype=torch.int32, device=U.device)
    acc = torch.zeros((K,), dtype=torch.float32, device=U.device)
    if lr_params is not None:
        mean, sigma, coeff, lam, alpha, pure_thresh = lr_params
        gain = _lr_gain(lam, alpha)
        pure = torch.arange(K, dtype=torch.float32, device=U.device) >= _f32(pure_thresh)
    y = None
    for t in range(T):
        u = Uc[:, t]
        x, y, rec = dynamics.kernel_step_recurrent(x, rec, u, float(t), dt)
        c, crash = cost.running_cost(y, u, t, crash)
        if lr_params is not None:
            lr_t = torch.zeros_like(acc)
            for ch in range(C):
                mu = torch.where(pure, 0.0, mean[t, ch])
                sg = sigma[t, ch]
                lr_t = lr_t + coeff[ch] * mu * (mu - 2.0 * u[ch]) / (sg * sg)
            c = c + gain * lr_t
        acc = acc + c
    return true_div(acc + cost.terminal_cost(y), T), crash


# the split cost pass cuts the horizon into this many chunks of steps, one
# thread per (sample, chunk) (kCostChunks in csrc/split_kernels.cuh); its
# cluster form runs COST_CLUSTER CTAs a 64-sample block (kCostCluster)
COST_CHUNKS = 8
COST_CLUSTER = 8


def split_outputs_plain(dynamics, x0, U, dt):
    """Plain version of the split dynamics pass: the outputs Y (K, T, O),
    stepped with ``Dynamics.kernel_step_recurrent`` as the kernels step (the
    kernels hold them as (T, O, K)). ``x0`` is (S,) or (K, S)."""
    K, T, _ = U.shape
    Uc = U.permute(2, 1, 0)  # (C, T, K)
    x = x0.T if x0.dim() == 2 else x0[:, None].expand(-1, K)
    rec = broadcast_rec(dynamics.init_recurrent_state(), K)
    ys = []
    for t in range(T):
        x, y, rec = dynamics.kernel_step_recurrent(x, rec, Uc[:, t], float(t), dt)
        ys.append(y)
    return torch.stack(ys, dim=-1).permute(1, 2, 0)


def sticky_crash(cost) -> bool:
    """The split cost pass evaluates ``cost`` at crash 0 and 1 (a
    sticky-prefix crash) rather than once."""
    return bool(cost.time_parallel_crash()) and not bool(cost.time_parallel_cost())


def split_step_values_plain(cost, Y, U, lr_params=None):
    """Plain version of the split cost pass's step values on the outputs Y
    (K, T, O): (v0, v1, trigger). v0 (K, T) is each sample-step's running
    cost at crash 0, v1 at crash 1 (None unless the crash is sticky), each
    plus lr_gain times the step's LR term with ``lr_params``, in the
    kernel's order of operations; the trigger (K, T) is the crash-0 call's
    crash output (None unless sticky)."""
    K, T, _ = Y.shape
    dev = Y.device
    Yc, Uc = Y.permute(2, 0, 1), U.permute(2, 0, 1)  # (O, K, T), (C, K, T)
    ts = torch.arange(T, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    v0, trig = cost.running_cost(Yc, Uc, ts, zero)
    v0, v1 = v0.expand(K, T), None
    if sticky_crash(cost):
        v1 = cost.running_cost(Yc, Uc, ts, torch.ones_like(zero))[0].expand(K, T)
        trig = trig.expand(K, T) > 0
    else:
        trig = None
    if lr_params is not None:
        mean, sigma, coeff, lam, alpha, pure_thresh = lr_params
        pure = (torch.arange(K, dtype=torch.float32, device=dev)
                >= _f32(pure_thresh))[:, None]
        lr_t = torch.zeros((K, T), dtype=torch.float32, device=dev)
        for ch in range(Uc.shape[0]):
            mu = torch.where(pure, 0.0, mean[:, ch])
            sg = sigma[:, ch]
            lr_t = lr_t + coeff[ch] * mu * (mu - 2.0 * Uc[ch]) / (sg * sg)
        lr_term = _lr_gain(lam, alpha) * lr_t
        v0 = v0 + lr_term
        v1 = None if v1 is None else v1 + lr_term
    return v0, v1, trig


def split_sums_plain(v0, v1=None, trig=None):
    """Each sample's sum of its step values as the split cost pass takes it,
    and its crash flag: (sum (K,), crash (K,) int32). Each of COST_CHUNKS
    chunks of ceil(T / COST_CHUNKS) steps is summed in order, once with the
    crash-1 values v1 from the chunk's first trigger on and once with v1
    throughout; the chunks are then added in order, a chunk after one that
    fired taking its second sum. Without ``trig`` (a cost that never
    crashes) the sum of v0 and no crash."""
    K, T = v0.shape
    Tc = -(-T // COST_CHUNKS)
    f32 = dict(dtype=torch.float32, device=v0.device)
    acc = torch.zeros((K,), **f32)
    crashed = torch.zeros((K,), dtype=torch.bool, device=v0.device)
    for ch in range(COST_CHUNKS):
        sel, all1 = torch.zeros((K,), **f32), torch.zeros((K,), **f32)
        fired = torch.zeros((K,), dtype=torch.bool, device=v0.device)
        for t in range(min(T, ch * Tc), min(T, (ch + 1) * Tc)):
            if trig is None:
                sel = sel + v0[:, t]
                continue
            fired = fired | trig[:, t]
            sel = sel + torch.where(fired, v1[:, t], v0[:, t])
            all1 = all1 + v1[:, t]
        acc = acc + torch.where(crashed, all1, sel)
        crashed = crashed | fired
    return acc, crashed.to(torch.int32)


def split_rollout_plain(dynamics, cost, x0, U, dt, lr_params=None):
    """Plain version of B1's split form (the dynamics pass, then the cost
    pass): (costs (K,), crash (K,) int32), J = (sum + terminal) / T with
    the sum taken in the cost pass's order. ``x0`` is (S,) or (K, S)."""
    T = U.shape[1]
    Y = split_outputs_plain(dynamics, x0, U, dt)
    acc, crash = split_sums_plain(*split_step_values_plain(cost, Y, U, lr_params))
    return true_div(acc + cost.terminal_cost(Y[:, -1].T), T), crash


def block_carries_plain(costs, U, lam, block=BLOCK):
    """Plain version of kernel 1's epilogue: one carry row (m_b, d_b,
    num_b[T*C]) per block of ``block`` samples, (nb, 2 + T*C)."""
    K, T, C = U.shape
    nb = -(-K // block)
    pad = nb * block - K
    s = torch.nn.functional.pad(true_div(-costs, lam), (0, pad), value=_MASKED)
    s = s.reshape(nb, block)
    m = torch.amax(s, dim=1)
    w = torch.exp(s - m[:, None])
    Up = torch.nn.functional.pad(U.reshape(K, T * C), (0, 0, 0, pad))
    num = torch.einsum("bk,bkj->bj", w, Up.reshape(nb, block, T * C))
    return torch.cat([m[:, None], w.sum(dim=1)[:, None], num], dim=1)


def block_carries_ordered(costs, X, lam, block=BLOCK):
    """``block_carries_plain`` in the order of the kernels'
    ``write_block_carry`` (csrc/mppi_common.cuh): each block's maximum and
    weight sum by its tree of halving strides, num_b summed over the
    block's valid samples left to right. Equal bit for bit to the carry
    rows of B4's epilogue (the warp forms' carry pass, ``_block_carries``,
    and the one-thread kernel's) on the same costs and X."""
    K, T, C = X.shape
    nb = -(-K // block)
    pad = nb * block - K
    s = torch.nn.functional.pad(true_div(-costs, lam), (0, pad), value=_MASKED)
    s = s.reshape(nb, block)
    m, off = s, block // 2
    while off:
        m = torch.fmax(m[:, :off], m[:, off:2 * off])
        off //= 2
    w = torch.exp(s - m)
    d, off = w, block // 2
    while off:
        d = d[:, :off] + d[:, off:2 * off]
        off //= 2
    valid = (torch.arange(nb * block, device=X.device) < K).reshape(nb, block)
    Xb = torch.nn.functional.pad(X.reshape(K, T * C), (0, 0, 0, pad)).reshape(
        nb, block, T * C)
    num = torch.zeros((nb, T * C), dtype=torch.float32, device=X.device)
    for i in range(block):
        num = torch.where(valid[:, i, None], num + w[:, i, None] * Xb[:, i], num)
    return torch.cat([m, d, num], dim=1)


def block_minima_plain(costs, block=BLOCK):
    """Plain version of kernel 1's Tsallis pass 1: each block's minimum
    cost (nb,), 1e30 for the samples past K. A NaN cost gives a NaN
    minimum, as jnp.min does (the kernel does not use fminf, which drops
    NaN)."""
    K = costs.shape[0]
    nb = -(-K // block)
    s = torch.nn.functional.pad(costs, (0, nb * block - K), value=_MIN_PAD)
    return torch.amin(s.reshape(nb, block), dim=1)


def tsallis_rows_plain(U, costs, rho, gamma, pw, K_valid=None, block=BLOCK):
    """Plain version of the Tsallis reduction kernel against the minimum
    cost ``rho`` (0-d): per block of ``block`` samples one row (0, sum w,
    sum w U[TC]), (nb, 2 + T*C), summed left to right over the block's
    samples. w = (1 - dJ / gamma)^pw for dJ = J - rho < gamma, else 0, with
    pw = 1 / (r - 1) (the kernel multiplies by it), and 0 for samples at or
    past ``K_valid``, which the sums skip."""
    K, T, C = U.shape
    K_valid = K if K_valid is None else K_valid
    nb = -(-K // block)
    pad = nb * block - K
    dj = costs - rho
    base = torch.clamp(1.0 - true_div(dj, gamma), min=1e-30)
    w = torch.where(dj < gamma, torch.exp(torch.log(base) * pw), 0.0)
    valid = torch.arange(K, device=U.device) < K_valid
    w = torch.nn.functional.pad(torch.where(valid, w, 0.0), (0, pad)).reshape(nb, block)
    valid = torch.nn.functional.pad(valid, (0, pad)).reshape(nb, block)
    Up = torch.nn.functional.pad(U.reshape(K, T * C), (0, 0, 0, pad))
    Up = Up.reshape(nb, block, T * C)
    d = torch.zeros((nb,), dtype=torch.float32, device=U.device)
    num = torch.zeros((nb, T * C), dtype=torch.float32, device=U.device)
    for i in range(block):
        v = valid[:, i]
        d = torch.where(v, d + w[:, i], d)
        num = torch.where(v[:, None], num + w[:, i, None] * Up[:, i], num)
    return torch.cat([torch.zeros_like(d)[:, None], d[:, None], num], dim=1)


def rmppi_rollout_plain(dynamics, cost, x0_nom, x0_real, U, gains, sigma,
                        coeff, dt, lam, alpha):
    """Plain version of the RMPPI rollout kernel, the same operations in
    the same order as its thread loop: (s_nom, j_real, s_fb (K,),
    crash_real (K,) int32, U_real (K, T, C))."""
    K, T, C = U.shape
    S = x0_nom.shape[0]
    Uc = U.permute(2, 1, 0)  # (C, T, K)
    x_nom = x0_nom[:, None].expand(-1, K)
    x_real = x0_real[:, None].expand(-1, K)
    zeros = torch.zeros((K,), dtype=torch.float32, device=U.device)
    crash_n = torch.zeros((K,), dtype=torch.int32, device=U.device)
    crash_r = crash_n
    s_nom = j_real = s_fb = zeros
    gain = _lr_gain(lam, alpha)
    u_real_t = []
    for t in range(T):
        u_raw = Uc[:, t]
        u_nom = dynamics.enforce_constraints(x_nom, u_raw)
        dx = [x_real[s] - x_nom[s] for s in range(S)]
        u_fb = []
        fb_cost = zeros
        for ch in range(C):
            acc = gains[t, ch, 0] * dx[0]
            for s in range(1, S):
                acc = acc + gains[t, ch, s] * dx[s]
            u_fb.append(acc)
            sg = sigma[t, ch]
            fb_cost = fb_cost + coeff[ch] * acc * acc / (sg * sg)
        fb_cost = gain * fb_cost
        u_real = dynamics.enforce_constraints(x_real, u_raw + torch.stack(u_fb))
        u_real_t.append(u_real)
        x_nom, y_nom = dynamics.kernel_step(x_nom, u_nom, float(t), dt)
        x_real, y_real = dynamics.kernel_step(x_real, u_real, float(t), dt)
        c_nom, crash_n = cost.running_cost(y_nom, u_nom, t, crash_n)
        c_real, crash_r = cost.running_cost(y_real, u_real, t, crash_r)
        s_nom = s_nom + c_nom
        j_real = j_real + c_real
        s_fb = s_fb + c_real + fb_cost
    term_n, term_r = cost.terminal_cost(y_nom), cost.terminal_cost(y_real)
    U_real = torch.stack(u_real_t).permute(2, 0, 1).contiguous()
    return (true_div(s_nom + term_n, T), true_div(j_real + term_r, T),
            true_div(s_fb + term_r, T), crash_r, U_real)


def flash_combine_plain(carry, T, C, lam, with_num=False):
    """Plain version of kernel 2: merge carry rows into (new_mean (T, C),
    baseline (), eta ()) with the flash rescaling of
    pallas_solve.flash_combine; ``with_num`` adds the merged sum num (T, C)
    that new_mean = num / eta divides."""
    m, d, num = carry[:, 0], carry[:, 1], carry[:, 2:]
    m_g = torch.amax(m)
    sc = torch.exp(m - m_g)
    d_g = torch.sum(d * sc)
    num_g = torch.sum(num * sc[:, None], dim=0)
    out = ((num_g / d_g).reshape(T, C), -lam * m_g, d_g)
    return out + (num_g.reshape(T, C),) if with_num else out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _on_cpu(t) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {t.device} are not supported")
    return t.device.type == "cpu"


def _check_tensors(tensors, device):
    """Each tensor on ``device``, float32 and contiguous, as the kernels take
    them; an entry given as (tensor, shape) must also have that shape."""
    for name, t in tensors.items():
        t, shape = t if isinstance(t, tuple) else (t, None)
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _model_args(dynamics, cost, device):
    """The (dynamics params, cost params, cost map, dynamics map) pointers
    of a launch, each checked as the kernels take it; the dynamics and the
    cost refuse
    what the compiled kernels do not take (another network), and so does a
    cost whose output layout differs from the one its pair's entries are
    compiled for (``_COST_LAYOUT``)."""
    pair = _PAIRS.get((type(dynamics), type(cost)))
    attr, want = _COST_LAYOUT.get(pair, (None, None))
    if attr is not None and getattr(cost, attr) != want:
        raise NotImplementedError(
            f"the CUDA entries of {pair} read the output layout {attr}={want}, not "
            f"{attr}={getattr(cost, attr)}")
    dyn_p, cmap, dmap = dynamics.kernel_params(), cost.kernel_map(), dynamics.kernel_map()
    tensors = {"cost params": cost.params}
    for name, t in (("dynamics params", dyn_p), ("cost map", cmap), ("dynamics map", dmap)):
        if t is not None:
            tensors[name] = t
    _check_tensors(tensors, device)
    return _ptr(dyn_p), cost.params.data_ptr(), _ptr(cmap), _ptr(dmap)


def _check_rollout_inputs(dynamics, cost, x0, U, lr_params, kind=None):
    """(library, C function) of the kernel ``kind`` (by default the rollout
    kernel of x0's layout) for this (dynamics, cost) pair, after checking
    device, dtype, shape and contiguity of every input."""
    if kind is None:
        kind = "rollout_x0" if x0.dim() == 2 else "rollout"
    entry = _entry(dynamics, cost, kind)
    K, T, C = U.shape
    S = dynamics.STATE_DIM
    tensors = {"U": U, "x0": x0}
    if lr_params is not None:
        tensors.update(mean=lr_params[0], sigma=lr_params[1], coeff=lr_params[2])
    _check_tensors(tensors, U.device)
    if C != dynamics.CONTROL_DIM or tuple(x0.shape) not in ((S,), (K, S)):
        raise ValueError(
            f"expected U (K, T, {dynamics.CONTROL_DIM}) and x0 ({S},) or "
            f"(K, {S}), got {tuple(U.shape)} and {tuple(x0.shape)}")
    if lr_params is not None and (
            tuple(lr_params[0].shape) != (T, C)
            or tuple(lr_params[1].shape) != (T, C)
            or tuple(lr_params[2].shape) != (C,)):
        raise ValueError("lr_params tables must be (T, C), (T, C), (C,)")
    if K < 1 or T < 1 or K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, T={T}, C={C}")
    return entry


@functools.lru_cache(maxsize=None)
def _lib(name="flash_combine"):
    """The built kernel library ``name`` (the merge's by default), after
    checking that csrc/ agrees with this module on the samples per block of
    the rollout and sampling kernels."""
    merge = _build.load("flash_combine")
    if merge.kernel_block_size() != BLOCK:
        raise RuntimeError("csrc/mppi_common.cuh kBlockSamples and BLOCK disagree")
    return merge if name == "flash_combine" else _build.load(name)


def _check_status(status, what):
    if status != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {status}")


def _rollout_outputs(K, T, C, epilogue, dev):
    """(costs, crash, out) of a rollout launch: out the carry rows (EPI_EXP),
    the block minima (EPI_MIN) or None."""
    nb = -(-K // BLOCK)
    costs = torch.empty((K,), dtype=torch.float32, device=dev)
    crash = torch.empty((K,), dtype=torch.int32, device=dev)
    out = None
    if epilogue != EPI_NONE:
        out = torch.empty((nb, 2 + T * C) if epilogue == EPI_EXP else (nb,),
                          dtype=torch.float32, device=dev)
    return costs, crash, out


def _lr_args(lr_params):
    """The kernels' LR arguments (mean, sigma, coeff pointers, gain, pure
    threshold)."""
    if lr_params is None:
        return (None, None, None, 0.0, 0.0)
    mean, sigma, coeff, lam, alpha, pure_thresh = lr_params
    return (mean.data_ptr(), sigma.data_ptr(), coeff.data_ptr(),
            _lr_gain(lam, alpha), _f32(pure_thresh))


# the epilogue pass after B1's warp form, by epilogue mode: the family of
# csrc/block_pass.cuh (pass_kernel_name)
_WARP_EPILOGUE_PASS = {EPI_EXP: "block_carry", EPI_MIN: "block_min"}


def _rollout_cuda(dynamics, cost, x0, U, dt, lr_params, epilogue=EPI_NONE,
                  lam_w=1.0):
    """Launch kernel 1 in the ``epilogue`` mode, in the form its entry
    reports (``form_kernel_name``; the warp form's epilogue is a second
    launch, the carry or minima pass, ``pass_kernel_name``): (costs, crash,
    out), out the carry rows (EPI_EXP), the block minima (EPI_MIN) or
    None."""
    lib_name, entry = _check_rollout_inputs(dynamics, cost, x0, U, lr_params)
    lib = _lib(lib_name)
    K, T, C = U.shape
    dev = U.device
    costs, crash, out = _rollout_outputs(K, T, C, epilogue, dev)
    lr = _lr_args(lr_params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = getattr(lib, entry)(
        dev.index, x0.data_ptr(), U.data_ptr(), K, T, _f32(dt),
        *_model_args(dynamics, cost, dev), *lr, int(lr_params is not None),
        epilogue, int(x0.dim() == 2), _f32(lam_w), costs.data_ptr(),
        crash.data_ptr(), _ptr(out), stream)
    name = form_kernel_name("rollout_costs", (lib_name, entry))
    _check_status(status, name)
    _build.count_launch(name, entry)
    if name == "rollout_costs_warp_kernel" and epilogue in _WARP_EPILOGUE_PASS:
        _build.count_launch(pass_kernel_name(_WARP_EPILOGUE_PASS[epilogue], lib_name))
    return costs, crash, out


@functools.cache
def _form(lib, fn):
    """The form the entry ``fn`` of the loaded library ``lib`` launches (its
    ``<fn>_form()``, a constant of the build): 0 the one-thread kernel (the
    merge's one-block kernel), 1 the warp form, 2 the staged form (B4, B3,
    B1, B8, the split dynamics passes), 3 the split cost pass's cluster form
    (beside its one-block form), 4 the tiled form of the merge and of the
    Tsallis reduction, 5 the lane-group form (B1's split dynamics pass)."""
    return int(getattr(lib, fn + "_form")())


_FORM_SUFFIX = {0: "_kernel", 1: "_warp_kernel", 2: "_staged_kernel", 3: "_cluster_kernel",
                4: "_tiled_kernel", 5: "_lanes_kernel"}


def form_kernel_name(base, entry):
    """The kernel of the family ``base`` (``split_dynamics``,
    ``split_solve_dynamics``, ``split_cost``, ``fused_sample_rollout``,
    ``rmppi_rollout``, ``fused_solve``, ``rollout_costs``, ``flash_combine``,
    ``tsallis_reduce``) that the entry ``entry`` ((library, C function), as
    ``_build.pair_entry`` gives it; the merge's is ("flash_combine",
    "flash_combine"), the Tsallis reduction's ("tsallis_reduce",
    "tsallis_reduce")) launches, as its library reports it:
    ``<base>_warp_kernel`` where the model's step is a network (split
    dynamics passes, B4, B3, B1, B8),
    ``<base>_staged_kernel`` for B4, B3, B1, B8 and the split dynamics
    passes of every other model,
    ``split_dynamics_lanes_kernel`` for B1's split dynamics pass of a
    model with the lane-group step (the bicycle), which it takes before the
    staged form,
    ``flash_combine_tiled_kernel`` for the merge,
    ``tsallis_reduce_tiled_kernel`` for the Tsallis reduction,
    ``split_cost_cluster_kernel`` for a split cost pass whose build
    has the cluster form beside the one-block form, else the one-thread
    (one-block) ``<base>_kernel``. Which of its two forms a split cost pass
    launches depends on its shape: ``split_cost_kernel_name``."""
    lib_name, fn = entry
    return base + _FORM_SUFFIX[_form(_lib(lib_name), fn)]


@functools.cache
def _cost_form(lib, fn, device_index, K, T, dual):
    """The form of the split cost pass that the entry ``fn`` of the loaded
    library ``lib`` is to launch for K samples over T steps on CUDA device
    ``device_index``; ``dual`` for a cost evaluated twice a step (a sticky
    crash: the AutoRally costs, with their map reads). 3 the cluster form
    where its COST_CLUSTER CTAs a 64-sample block number at most three a
    multiprocessor and each thread's chain in the one-block form is long:
    a dual cost, or chunks of at least 8 steps (T >= 57); else 0 the
    one-block form, and always in a build of the earlier form
    (``<fn>_form()`` 0). Set by A B B A on the H100
    (``scripts/torch_cost_form_sweep.py``, PERF.md section 6): AutoRally's
    and the bicycle's cluster form won at 48 blocks and lost at 66; at T =
    48 the DI robust and quadrotor costs lost with it and AutoRally's won;
    at T = 100 the quadratic costs won with it."""
    form = _form(lib, fn)
    if form == 0:
        return 0
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    fits = COST_CLUSTER * -(-K // BLOCK) <= 3 * sms
    long_chain = dual or -(-T // COST_CHUNKS) >= 8
    return form if fits and long_chain else 0


def split_cost_form(entry, device_index, K, T, dual):
    """The form of the split cost pass that the entry ``entry`` ((library,
    C function)) launches for K samples over T steps on CUDA device
    ``device_index``, ``dual`` for a sticky-crash cost (``_cost_form``)."""
    lib_name, fn = entry
    return _cost_form(_lib(lib_name), fn, device_index, K, T, bool(dual))


def split_cost_kernel_name(entry, device_index, K, T, dual):
    """The counted name of the split cost pass that ``entry`` launches for K
    samples over T steps on CUDA device ``device_index`` (``dual``: a
    sticky-crash cost): ``split_cost_cluster_kernel`` or the one-block
    ``split_cost_kernel``."""
    return "split_cost" + _FORM_SUFFIX[split_cost_form(entry, device_index, K, T, dual)]


def merge_kernel_name():
    """The counted name of the merge kernel the port's build launches."""
    return form_kernel_name("flash_combine", ("flash_combine", "flash_combine"))


# the kernels of the passes after the warp forms (csrc/block_pass.cuh) by
# the library's block_pass_form()
_PASS_NAMES = {"block_carry": {4: "block_carry_tiled_kernel", 0: "block_carry_kernel"},
               "block_min": {4: "block_min_warp_kernel", 0: "block_min_kernel"}}


def pass_kernel_name(base, lib_name="flash_combine"):
    """The kernel of the pass ``base`` ("block_carry": the carry rows after
    B4's, B3's and B1's warp forms; "block_min": Tsallis pass 1's minima
    after B1's) that the library ``lib_name`` launches, as it reports it
    (``block_pass_form()``): ``block_carry_tiled_kernel`` and
    ``block_min_warp_kernel``, or ``block_carry_kernel`` and
    ``block_min_kernel`` in a build with -DMPPI_PASS_UNSTAGED."""
    return _PASS_NAMES[base][_form(_lib(lib_name), "block_pass")]


def _block_carries(costs, X, lam):
    """The carry pass alone: one carry row (m_b, d_b, num_b[T*C]) per
    block of BLOCK samples of the costs (K,) over X (K, T, C), (nb, 2 +
    T*C), as the warp forms' pass writes them (``block_carries_ordered``'s
    floats; that is its plain version). On the card it launches the pass of
    the merge's library."""
    K, T, C = X.shape
    _check_tensors({"costs": (costs, (K,)), "X": X}, X.device)
    if K < 1 or K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, T={T}, C={C}")
    if _on_cpu(X):
        return block_carries_ordered(costs, X, _f32(lam))
    carry = torch.empty((-(-K // BLOCK), 2 + T * C), dtype=torch.float32, device=X.device)
    status = _lib().block_carry_pass(
        X.device.index, costs.data_ptr(), X.data_ptr(), K, T * C, _f32(lam), carry.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream)
    name = pass_kernel_name("block_carry")
    _check_status(status, name)
    _build.count_launch(name)
    return carry


def _block_minima(costs):
    """The minima pass alone: each block of BLOCK samples' minimum cost
    (nb,), 1e30 past K, NaN where a cost is NaN, as B1's warp form writes
    them for Tsallis pass 1 (``block_minima_plain`` is its plain version)."""
    _check_tensors({"costs": costs}, costs.device)
    if costs.dim() != 1 or costs.shape[0] < 1:
        raise ValueError(f"costs must be (K,), got {tuple(costs.shape)}")
    K = costs.shape[0]
    if _on_cpu(costs):
        return block_minima_plain(costs)
    out = torch.empty((-(-K // BLOCK),), dtype=torch.float32, device=costs.device)
    status = _lib().block_min_pass(costs.device.index, costs.data_ptr(), K, out.data_ptr(),
                                   torch.cuda.current_stream(costs.device).cuda_stream)
    name = pass_kernel_name("block_min")
    _check_status(status, name)
    _build.count_launch(name)
    return out


def split_dynamics_cuda(dynamics, cost, x0, U, dt):
    """Launch B1's split dynamics pass from one x0 (S,) or one per sample
    (K, S): the outputs Y (T, O, K)."""
    kind = "split_dynamics_x0" if x0.dim() == 2 else "split_dynamics"
    lib_name, fn = _check_rollout_inputs(dynamics, cost, x0, U, None, kind)
    K, T, _ = U.shape
    dev = U.device
    Y = torch.empty((T, dynamics.OUTPUT_DIM, K), dtype=torch.float32, device=dev)
    status = getattr(_lib(lib_name), fn)(
        dev.index, x0.data_ptr(), U.data_ptr(), K, T, _f32(dt),
        *_model_args(dynamics, cost, dev), Y.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    name = form_kernel_name("split_dynamics", (lib_name, fn))
    _check_status(status, name)
    _build.count_launch(name, fn)
    return Y


def split_cost_cuda(dynamics, cost, Y, U, lr_params=None, epilogue=EPI_NONE, lam_w=1.0,
                    lr_sum=None, lr_sum_gain=0.0, form=None):
    """Launch the split cost pass over the outputs Y (T, O, K) of either
    dynamics pass: (costs, crash, out) as ``_rollout_cuda``. ``lr_params``
    adds B1's per-step LR term, ``lr_sum`` (K,) B3's per-sample LR sums
    times ``lr_sum_gain``. ``form`` (3 the cluster form, 0 the one-block
    form) overrides ``split_cost_form``'s pick; a form the build lacks
    raises."""
    lib_name, fn = _entry(dynamics, cost, "split_cost")
    K, T, C = U.shape
    dev = U.device
    tensors = {"Y": (Y, (T, dynamics.OUTPUT_DIM, K)), "U": U}
    if lr_sum is not None:
        tensors["lr_sum"] = (lr_sum, (K,))
    _check_tensors(tensors, dev)
    costs, crash, out = _rollout_outputs(K, T, C, epilogue, dev)
    model = _model_args(dynamics, cost, dev)
    if form is None:
        form = split_cost_form((lib_name, fn), dev.index, K, T, cost.time_parallel_crash())
    status = getattr(_lib(lib_name), fn)(
        dev.index, Y.data_ptr(), U.data_ptr(), K, T, model[1], model[2],
        *_lr_args(lr_params), int(lr_params is not None), _ptr(lr_sum),
        _f32(lr_sum_gain), epilogue, _f32(lam_w), costs.data_ptr(), crash.data_ptr(),
        _ptr(out), form, torch.cuda.current_stream(dev).cuda_stream)
    name = "split_cost" + _FORM_SUFFIX[form]
    _check_status(status, name)
    _build.count_launch(name, fn)
    return costs, crash, out


def split_rollout_cuda(dynamics, cost, x0, U, dt, lr_params, epilogue=EPI_NONE,
                       lam_w=1.0):
    """Launch B1's split form in the ``epilogue`` mode: the dynamics pass,
    then the cost pass. Returns (costs, crash, out) as ``_rollout_cuda``."""
    if lr_params is not None:
        _check_rollout_inputs(dynamics, cost, x0, U, lr_params, "split_cost")
    Y = split_dynamics_cuda(dynamics, cost, x0, U, dt)
    return split_cost_cuda(dynamics, cost, Y, U, lr_params, epilogue, lam_w)


def _rollout_any(dynamics, cost, x0, U, dt, lr_params, epilogue, lam_w, split_cost):
    """Kernel 1 (or its split form, by ``resolve_split``) in the
    ``epilogue`` mode on CUDA tensors, its plain version on CPU tensors:
    (costs, crash, out)."""
    refuse_model(dynamics)
    split = resolve_split(dynamics, cost, split_cost,
                          "rollout_x0" if x0.dim() == 2 else "rollout")
    if _on_cpu(U):
        plain = split_rollout_plain if split else rollout_costs_plain
        costs, crash = plain(dynamics, cost, x0, U, dt, lr_params)
        out = None
        if epilogue == EPI_EXP:
            out = block_carries_plain(costs, U, _f32(lam_w))
        elif epilogue == EPI_MIN:
            out = block_minima_plain(costs)
        return costs, crash, out
    launch = split_rollout_cuda if split else _rollout_cuda
    return launch(dynamics, cost, x0, U, dt, lr_params, epilogue, lam_w)


def fused_rollout_costs(dynamics, cost, x0, U, dt, lr_params=None, split_cost=None):
    """Kernel 1, plain-costs mode: (costs (K,), crash (K,) int32).
    ``costs`` = (sum_t running [+ LR] + terminal) / T. ``x0`` is (S,), or
    (K, S) for one initial state per sample. ``split_cost``: the split form
    (``resolve_split``)."""
    costs, crash, _ = _rollout_any(dynamics, cost, x0, U, dt, lr_params, EPI_NONE,
                                   1.0, split_cost)
    return costs, crash


def rollout_block_carries(dynamics, cost, x0, U, dt, lam, lr_params=None,
                          split_cost=None):
    """Kernel 1, exp-epilogue mode: (costs, crash, carry (nb, 2 + T*C))."""
    return _rollout_any(dynamics, cost, x0, U, dt, lr_params, EPI_EXP, lam,
                        split_cost)


def rollout_block_minima(dynamics, cost, x0, U, dt, lr_params=None, split_cost=None):
    """Kernel 1, Tsallis pass 1: (costs, crash, block minima (nb,)), each
    block's minimum over its valid costs (NaN if one is NaN)."""
    return _rollout_any(dynamics, cost, x0, U, dt, lr_params, EPI_MIN, 1.0,
                        split_cost)


def _tsallis_lib():
    """The library of csrc/tsallis_reduce.cu, checked to agree with this
    module on the samples per block."""
    lib = _lib("tsallis_reduce")
    if lib.tsallis_reduce_block_size() != BLOCK:
        raise RuntimeError("csrc/tsallis_reduce.cu and BLOCK disagree")
    return lib


def tsallis_kernel_name():
    """The counted name of the Tsallis reduction kernel the build launches:
    ``tsallis_reduce_tiled_kernel`` (a grid of sample blocks and column
    tiles), or ``tsallis_reduce_kernel`` (one block per 64 samples) in a
    build with -DMPPI_TSALLIS_ONE_BLOCK."""
    return form_kernel_name("tsallis_reduce", ("tsallis_reduce", "tsallis_reduce"))


def tsallis_block_rows(U, costs, rho_src, gamma, r, K_valid=None):
    """The Tsallis reduction kernel (pass 2): rho = the minimum of
    ``rho_src`` (the rollout's block minima, or one given rho; NaN if one is
    NaN), then per block of BLOCK samples the row (0, sum w, sum w U[TC]).
    Returns (rows (nb, 2 + T*C), rho ()). Samples at or past ``K_valid``
    (default K) weigh 0. ``rho_src`` is a 1-d float32 tensor on the samples'
    device, so no host waits for it; the inputs are checked on every
    device."""
    K, T, C = U.shape
    K_valid = K if K_valid is None else int(K_valid)
    _check_tensors({"U": U, "costs": (costs, (K,)), "rho": rho_src}, U.device)
    if rho_src.dim() != 1 or rho_src.numel() < 1:
        raise ValueError(f"rho must be a non-empty 1-d tensor, got {tuple(rho_src.shape)}")
    if not 0 <= K_valid <= K or K < 1 or K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, K_valid={K_valid}, T={T}, C={C}")
    gamma, pw = _f32(gamma), _tsallis_pw(r)
    if _on_cpu(U):
        rho = torch.amin(rho_src)
        return tsallis_rows_plain(U, costs, rho, gamma, pw, K_valid), rho
    dev = U.device
    rows = torch.empty((-(-K // BLOCK), 2 + T * C), dtype=torch.float32, device=dev)
    rho = torch.empty((), dtype=torch.float32, device=dev)
    status = _tsallis_lib().tsallis_reduce(
        dev.index, U.data_ptr(), costs.data_ptr(), rho_src.data_ptr(), rho_src.numel(),
        K_valid, K, T * C, gamma, pw, rows.data_ptr(), rho.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    name = tsallis_kernel_name()
    _check_status(status, name)
    _build.count_launch(name)
    return rows, rho


def flash_combine(carry, T, C, lam, with_num=False):
    """Kernel 2: (new_mean (T, C), baseline (), eta ()) from carry rows;
    ``with_num`` adds the merged sum num (T, C) = new_mean * eta before the
    division."""
    if _on_cpu(carry):
        return flash_combine_plain(carry, T, C, _f32(lam), with_num)
    if carry.dtype != torch.float32 or not carry.is_contiguous():
        raise ValueError("carry must be contiguous float32")
    if carry.dim() != 2 or carry.shape[1] != 2 + T * C or carry.shape[0] < 1:
        raise ValueError(f"carry must be (nb, {2 + T * C}), got {tuple(carry.shape)}")
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=carry.device)
    new_mean = torch.empty((T, C), **f32)
    scal = torch.empty((2,), **f32)
    num = torch.empty((T, C), **f32) if with_num else None
    status = lib.flash_combine(
        carry.device.index, carry.data_ptr(), carry.shape[0], T * C, _f32(lam),
        new_mean.data_ptr(), scal.data_ptr(), _ptr(num),
        torch.cuda.current_stream(carry.device).cuda_stream)
    name = merge_kernel_name()
    _check_status(status, name)
    _build.count_launch(name)
    out = (new_mean, scal[0], scal[1])
    return out + (num,) if with_num else out


def fused_weighted_rollout(dynamics, cost, x0, U, dt, lam, lr_params=None,
                           weight_kind="exp", weight_params=None, split_cost=None):
    """Fused rollout + in-kernel weights + weighted mean for precomputed
    samples ``U`` (K, T, C). Returns (costs (K,), crash (K,), new_mean
    (T, C), baseline (), eta ()).

    ``weight_kind="exp"``: the normExp flash epilogue; baseline = -lambda *
    max_k(-J_k / lambda) and new_mean is the softmax(-J / lambda)-weighted
    mean. ``"tsallis"`` with ``weight_params = (gamma, r)``
    (TsallisTransform, mppi_common.cu:958-985): the two-pass epilogue;
    baseline = rho = min_k J_k, eta = sum_k w_k and new_mean = sum_k w_k U_k
    / eta with w = (1 - (J - rho) / gamma)_+^(1 / (r - 1)). Three launches,
    in stream order: kernel 1 with the block minima, the reduction kernel,
    the merge; nothing waits on the host. ``split_cost``: kernel 1's split
    form (``resolve_split``), one launch more."""
    K, T, C = U.shape
    if weight_kind == "tsallis":
        gamma, r = weight_params
        costs, crash, minima = rollout_block_minima(dynamics, cost, x0, U, dt,
                                                    lr_params, split_cost)
        rows, rho = tsallis_block_rows(U, costs, minima, gamma, r)
        new_mean, _, eta = flash_combine(rows, T, C, 1.0)
        return costs, crash, new_mean, rho, eta
    if weight_kind != "exp":
        raise KernelIncompatible(
            f"the fused epilogue takes weight_kind 'exp' or 'tsallis', got {weight_kind!r}")
    costs, crash, carry = rollout_block_carries(dynamics, cost, x0, U, dt, lam,
                                                lr_params, split_cost)
    new_mean, baseline, eta = flash_combine(carry, T, C, lam)
    return costs, crash, new_mean, baseline, eta


def tsallis_reduce(U, costs, rho, gamma, r, K=None):
    """Tsallis weights against a given minimum cost ``rho`` (a device
    tensor, 0-d or (1,), e.g. all-reduced across devices), their weighted
    sum of ``U`` (K_rows, T, C) and their sum: (num (T, C), eta ()), the
    JAX ``_tsallis_reduce_call``. Samples at or past ``K`` (default all)
    weigh 0. Two launches: the reduction kernel and the merge."""
    _, T, C = U.shape
    rows, _ = tsallis_block_rows(U, costs, rho.reshape(1), gamma, r, K)
    _, _, eta, num = flash_combine(rows, T, C, 1.0, with_num=True)
    return num, eta


def fused_rmppi_rollout(dynamics, cost, x0_nom, x0_real, U, gains, sigma, coeff,
                        dt, lam, alpha):
    """Fused RMPPI augmented rollout (rolloutRMPPIDynamicsKernel +
    rolloutRMPPICostKernel, core/rmppi_kernels.cu:359-665): per sample the
    nominal and the real system step together; the nominal one with
    u_nom = clamp(u_raw), the real one with u_real = clamp(u_raw + u_fb),
    u_fb = K[t] (x_real - x_nom); the feedback cost
    0.5 lambda (1 - alpha) sum_c coeff_c u_fb_c^2 / sigma_tc^2 accumulates
    beside the running costs. "clamp" is the dynamics' enforce_constraints.

    U (K, T, C) holds the raw samples (not clamped: the kernel clamps both
    controls). gains (T, C, S); sigma (T, C); coeff (C,). Returns
    (s_nom, j_real, s_fb (K,), crash_real (K,) int32, U_real (K, T, C)):
    s_nom = (sum running_nom + terminal) / T, j_real the same for the real
    system, s_fb = (sum (running_real + fb cost) + terminal_real) / T.
    The inputs are checked as the kernel takes them on every device; a
    recurrent model raises ``KernelIncompatible``, as the JAX kernel refuses
    it (pallas_rollout.py:302), and RMPPI runs its eager augmented rollout."""
    K, T, C = U.shape
    S = dynamics.STATE_DIM
    refuse_model(dynamics)
    if dynamics.init_recurrent_state() is not None:
        raise KernelIncompatible(
            f"the RMPPI rollout kernel does not carry the recurrent state of "
            f"{type(dynamics).__name__}")
    constraints = constraint_table(dynamics)
    _check_tensors({"U": U, "x0_nom": (x0_nom, (S,)), "x0_real": (x0_real, (S,)),
                    "gains": (gains, (T, C, S)), "sigma": (sigma, (T, C)),
                    "coeff": (coeff, (C,)), "cost params": cost.params,
                    "constraints": constraints}, U.device)
    if C != dynamics.CONTROL_DIM or K < 1 or T < 1 or K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, T={T}, C={C}")
    if _on_cpu(U):
        return rmppi_rollout_plain(dynamics, cost, x0_nom, x0_real, U, gains,
                                   sigma, coeff, dt, lam, alpha)
    lib_name, entry = _entry(dynamics, cost, "rmppi")
    dev = U.device
    f32 = dict(dtype=torch.float32, device=dev)
    s_nom, j_real, s_fb = (torch.empty((K,), **f32) for _ in range(3))
    crash = torch.empty((K,), dtype=torch.int32, device=dev)
    U_real = torch.empty((K, T, C), **f32)
    status = getattr(_lib(lib_name), entry)(
        dev.index, x0_nom.data_ptr(), x0_real.data_ptr(), U.data_ptr(), K, T,
        _f32(dt), *_model_args(dynamics, cost, dev), constraints.data_ptr(),
        gains.data_ptr(), sigma.data_ptr(), coeff.data_ptr(),
        _lr_gain(lam, alpha), s_nom.data_ptr(), j_real.data_ptr(),
        s_fb.data_ptr(), crash.data_ptr(), U_real.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    name = form_kernel_name("rmppi_rollout", (lib_name, entry))
    _check_status(status, name)
    _build.count_launch(name, entry)
    return s_nom, j_real, s_fb, crash, U_real


# ---------------------------------------------------------------------------
# the in-kernel draw (shared with ops/fused_solve.py)
# ---------------------------------------------------------------------------
def noise_kind(sampler) -> int:
    """GAUSSIAN, NLN or SMOOTH: which noise the fused sampling kernels draw
    for ``sampler``. Any other sampler raises, as the JAX kernels refuse it
    (pallas_rollout.py:2520-2535), with ``KernelIncompatible``."""
    kind = _NOISE_KIND.get(type(sampler))
    if kind is None:
        raise KernelIncompatible(
            "the fused sampling kernels draw the noise of the Gaussian, NLN and "
            f"Smooth-MPPI samplers, not of {type(sampler).__name__}")
    return kind


def constraint_table(dynamics):
    """(4, C) [lo; hi; deadband; zero control]: the dynamics'
    enforceConstraints as the kernels read it."""
    return torch.stack([dynamics.control_ranges[:, 0], dynamics.control_ranges[:, 1],
                        dynamics.control_deadband, dynamics.zero_control]).contiguous()


def sample_tables(sampler, kind, mean, iteration, sampler_state=None):
    """(sigma (T, C), aux (T, C) or None) of one iteration: the decayed
    sigma, and NLN's lognormal scale (the RAW std-dev, not the decayed one,
    pallas_rollout.py:2570-2581) or Smooth-MPPI's derivative mean."""
    T, C = mean.shape
    sigma = sampler._sigma(T, iteration).contiguous()
    if kind == NLN:
        return sigma, sampler.std_dev.expand(T, C).contiguous()
    if kind == SMOOTH:
        if sampler_state is None:  # pallas_rollout.py:2524, before any launch
            raise KernelIncompatible(
                "Smooth-MPPI needs sampler_state (the derivative mean)")
        return sigma, sampler_state
    return sigma, None


def standard_normals(kind, seed, K, T, C, injected_noise=None):
    """(n_z, K, T, C) standard normals of one iteration (n_z = 2 for NLN's
    z and z2): ``injected_noise`` when given, (K, T, C) or (n_z, K, T, C),
    else the kernels' Philox draw from ``seed``."""
    n_z = 2 if kind == NLN else 1
    if injected_noise is None:
        return philox.normals(seed, K, T, C, streams=n_z)
    z = injected_noise[None] if injected_noise.dim() == 3 else injected_noise
    if tuple(z.shape) != (n_z, K, T, C):
        raise ValueError(f"injected_noise must be ({n_z}, {K}, {T}, {C}), got "
                         f"{tuple(injected_noise.shape)}")
    return z


def sample_plain(dynamics, sampler, kind, mean, seed, K, iteration, stride,
                 sampler_state=None, injected_noise=None):
    """The kernels' draw, carve-outs and clamp, with the same float
    operations: the eager sampler applied to the kernels' normals, then the
    dynamics' clamp. Returns (U (K, T, C), W (K, T, C) or None)."""
    T, C = mean.shape
    z = standard_normals(kind, seed, K, T, C, injected_noise)
    U, W = sampler.sample(None, mean, K, iteration=iteration,
                          optimization_stride=stride, state=sampler_state,
                          injected_noise=z if kind == NLN else z[0])
    return dynamics.enforce_constraints(None, U.movedim(-1, 0)).movedim(0, -1), W


def _rollout_sums(dynamics, cost, x0, U, dt, step_extra=None):
    """The sampling kernels' rollout loop from one x0 (S,): (acc, terminal,
    crash), acc = sum_t (running_t [+ step_extra(t, u_t)]) summed as
    (acc + running) + extra."""
    K, T, C = U.shape
    Uc = U.permute(2, 1, 0)  # (C, T, K)
    x = x0[:, None].expand(-1, K)
    rec = broadcast_rec(dynamics.init_recurrent_state(), K)
    crash = torch.zeros((K,), dtype=torch.int32, device=U.device)
    acc = torch.zeros((K,), dtype=torch.float32, device=U.device)
    y = None
    for t in range(T):
        u = Uc[:, t]
        x, y, rec = dynamics.kernel_step_recurrent(x, rec, u, float(t), dt)
        c, crash = cost.running_cost(y, u, t, crash)
        acc = acc + c
        if step_extra is not None:
            acc = acc + step_extra(t, u)
    return acc, cost.terminal_cost(y), crash


def _seed_tensor(seed, device):
    """The iteration's seed as the kernels read it: a 0-d int32 tensor on
    ``device`` (the controllers draw it there, so no solve waits on it)."""
    if not isinstance(seed, torch.Tensor):
        return torch.tensor(int(seed), dtype=torch.int32, device=device)
    if seed.device != device or seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError(f"seed must be one int32 on {device}, got {seed.dtype} "
                         f"{tuple(seed.shape)} on {seed.device}")
    return seed.reshape(())


def _ptr(t):
    return None if t is None else t.data_ptr()


def sample_rollout_plain(dynamics, cost, sampler, x0, mean, seed, dt, lam, alpha,
                         num_rollouts, iteration=0, optimization_stride=0,
                         sampler_state=None, injected_noise=None):
    """Plain version of ``fused_sample_rollout_kernel``: (costs (K,), crash
    (K,) int32, U (K, T, C), W (K, T, C) or None), the kernel's operations
    in its order. The LR term of each step is scaled and added to the
    running sum (pallas_rollout.py:1811-1828), J = (acc + terminal) / T."""
    kind = noise_kind(sampler)
    K = num_rollouts
    T, C = mean.shape
    sigma, _ = sample_tables(sampler, kind, mean, iteration, sampler_state)
    U, W = sample_plain(dynamics, sampler, kind, mean, seed, K, iteration,
                        optimization_stride, sampler_state, injected_noise)
    coeff = sampler.control_cost_coeff
    gain = _lr_gain(lam, alpha)
    pure_k = sampler._pure_noise_mask(K)

    def lr_step(t, u):
        lr_t = torch.zeros_like(u[0])
        for ch in range(C):
            mu = torch.where(pure_k, 0.0, mean[t, ch])
            sg = sigma[t, ch]
            lr_t = lr_t + coeff[ch] * mu * (mu - 2.0 * u[ch]) / (sg * sg)
        return gain * lr_t

    acc, term, crash = _rollout_sums(dynamics, cost, x0, U, dt, lr_step)
    return true_div(acc + term, T), crash, U, W


def _sample_rollout_cuda(dynamics, cost, sampler, kind, x0, mean, seed, dt, lam,
                         alpha, K, iteration, stride, sampler_state, epilogue,
                         emit_samples, injected_noise):
    """Launch B4 in the form its entry reports (``form_kernel_name``; the
    warp form's epilogue is a second launch, the carry pass,
    ``pass_kernel_name``):
    (costs, crash, U or None, W or None, carry or None)."""
    lib_name, entry = _entry(dynamics, cost, "sample")
    T, C = mean.shape
    S = dynamics.STATE_DIM
    dev = mean.device
    sigma, aux = sample_tables(sampler, kind, mean, iteration, sampler_state)
    cons = constraint_table(dynamics)
    z = (None if injected_noise is None
         else standard_normals(kind, seed, K, T, C, injected_noise))
    tensors = {"x0": (x0, (S,)), "mean": (mean, (T, C)), "sigma": sigma,
               "coeff": (sampler.control_cost_coeff, (C,)), "constraints": cons}
    if aux is not None:
        tensors["aux"] = (aux, (T, C))
    if z is not None:
        tensors["injected_noise"] = z
    _check_tensors(tensors, dev)
    if C != dynamics.CONTROL_DIM or K < 1 or T < 1 or 2 * K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, T={T}, C={C}")
    model = _model_args(dynamics, cost, dev)
    seed = _seed_tensor(seed, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    costs = torch.empty((K,), **f32)
    crash = torch.empty((K,), dtype=torch.int32, device=dev)
    U = torch.empty((K, T, C), **f32) if emit_samples or not epilogue else None
    W = torch.empty((K, T, C), **f32) if kind == SMOOTH else None
    carry = torch.empty((-(-K // BLOCK), 2 + T * C), **f32) if epilogue else None
    status = getattr(_lib(lib_name), entry)(
        dev.index, kind, int(epilogue), x0.data_ptr(), mean.data_ptr(),
        sigma.data_ptr(), _ptr(aux), sampler.control_cost_coeff.data_ptr(),
        cons.data_ptr(), seed.data_ptr(), _ptr(z), K, T, int(stride),
        _f32(sampler.pure_threshold(K)),
        _f32(getattr(sampler, "dt_smooth", 0.0)), _f32(dt), _lr_gain(lam, alpha),
        _f32(lam), *model, costs.data_ptr(), crash.data_ptr(),
        _ptr(U), _ptr(W), _ptr(carry), torch.cuda.current_stream(dev).cuda_stream)
    name = form_kernel_name("fused_sample_rollout", (lib_name, entry))
    _check_status(status, name)
    _build.count_launch(name, entry)
    if epilogue and name == "fused_sample_rollout_warp_kernel":
        # the warp form's carry pass
        _build.count_launch(pass_kernel_name("block_carry", lib_name))
    return costs, crash, U, W, carry


def fused_sample_rollout_costs(dynamics, cost, sampler, x0, mean, seed, dt, lam,
                               alpha, num_rollouts, iteration=0,
                               optimization_stride=0, sampler_state=None,
                               epilogue=False, emit_samples=True,
                               injected_noise=None):
    """Fused sample + rollout (the JAX ``fused_sample_rollout_costs``,
    pallas_rollout.py:2457-2515): the samples are drawn in the kernel from
    ``seed`` (a 0-d int32 tensor on the samples' device), carved out,
    clamped and rolled out with the per-step LR cost. Returns
    (costs (K,), crash (K,), U (K, T, C), aux), where aux is Smooth-MPPI's
    derivative samples W (K, T, C), else None.

    ``epilogue=True`` (Smooth-MPPI only): the flash normExp epilogue over W,
    which Smooth-MPPI's mean update weights (smooth-MPPI.cu:203-236).
    Returns (costs, crash, U or None, new_deriv_mean (T, C), baseline, eta);
    U only with ``emit_samples``.

    ``injected_noise`` replaces the draw with given standard normals:
    (K, T, C), or (2, K, T, C) for NLN (z, z2). ``optimization_stride`` is a
    host integer. Samplers other than Gaussian, NLN and Smooth-MPPI raise;
    CPU tensors run the plain version, CUDA tensors the kernel."""
    refuse_model(dynamics)
    kind = noise_kind(sampler)
    if epilogue and kind != SMOOTH:
        raise KernelIncompatible(
            "the sampling kernel's flash epilogue is Smooth-MPPI's, over W; the "
            "Gaussian and NLN samplers take fused_solve_iteration")
    T, C = mean.shape
    K = num_rollouts
    if _on_cpu(mean):
        costs, crash, U, W = sample_rollout_plain(
            dynamics, cost, sampler, x0, mean, seed, dt, lam, alpha, K, iteration,
            optimization_stride, sampler_state, injected_noise)
        if not epilogue:
            return costs, crash, U, W
        carry = block_carries_plain(costs, W, _f32(lam))
    else:
        costs, crash, U, W, carry = _sample_rollout_cuda(
            dynamics, cost, sampler, kind, x0, mean, seed, dt, lam, alpha, K,
            iteration, optimization_stride, sampler_state, epilogue, emit_samples,
            injected_noise)
        if not epilogue:
            return costs, crash, U, W
    new_dm, baseline, eta = flash_combine(carry, T, C, lam)
    return costs, crash, U if emit_samples else None, new_dm, baseline, eta
