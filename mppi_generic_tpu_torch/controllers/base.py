"""Controller base, in PyTorch.

Counterpart of ``mppi_generic_tpu/controllers/base.py``. The JAX controller
is one jitted pure function; here ``solve`` runs eagerly on the device the
controller was built for, and the warm-start state is a small dataclass of
tensors plus the ``torch.Generator`` that draws the samples.

Device rule: a controller runs on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``. Without CUDA and without ``device="cpu"``
it raises; it never moves to the CPU on its own.

Control-sequence services reproduced from the reference: slide-forward
(controller.cuh:588-600), 5-tap Savitzky-Golay smoothing with a 2-step
control history (controller.cuh:557-586), the re-rollout of the mean
(controller.cuh:643-663; eager, a recurrent model's LSTM state carried from
its warm state, ``models.base.rollout_single``) and the free-energy
statistics (controller.cuh:22-38).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from mppi_generic_tpu_torch.models.base import rollout_single
from mppi_generic_tpu_torch.ops import weights as weight_ops
from mppi_generic_tpu_torch.ops.weights import FreeEnergyStats
from mppi_generic_tpu_torch.utils import math_utils


@dataclasses.dataclass
class SolveResult:
    """Everything a solve publishes."""

    control_mean: torch.Tensor  # (T, C) smoothed + clamped sequence
    state_trajectory: torch.Tensor  # (T+1, S) re-rollout of the mean
    output_trajectory: torch.Tensor  # (T, O)
    costs: torch.Tensor  # (K,) final-iteration trajectory costs
    weights: torch.Tensor  # (K,) final-iteration normExp weights
    baseline: torch.Tensor
    normalizer: torch.Tensor
    free_energy: FreeEnergyStats
    crash: torch.Tensor  # (K,) int32
    sampled_controls: Optional[torch.Tensor] = None  # (K, T, C) if requested


@dataclasses.dataclass
class ControllerState:
    """Warm-start state carried between solves: the mean, the 2-step
    executed-control history, the previous baseline, the generator the
    samples (or the fused kernels' seeds) are drawn from (stateful: solves
    advance it in place) and the sampler's own sequence state (Smooth-MPPI's
    derivative mean; None for stateless samplers)."""

    control_mean: torch.Tensor  # (T, C)
    control_history: torch.Tensor  # (2, C)
    generator: torch.Generator
    previous_baseline: torch.Tensor  # ()
    sampler_state: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "ControllerState":
        return dataclasses.replace(self, **changes)


def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (or defaulted to) and not available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the controller runs on the GPU unless "
            "it is built with device='cpu'")
    return device


class ControllerBase(nn.Module):
    def __init__(self, dynamics, cost, sampler, *, dt=0.02, lam=1.0,
                 alpha=0.0, num_timesteps=100, num_rollouts=1024,
                 num_iters=1, return_samples=False, slide_scale=None,
                 split_cost=None, sequential_crash=True, device=None):
        super().__init__()
        if split_cost not in (None, True, False):
            raise ValueError(f"split_cost must be None, True or False, got {split_cost!r}")
        self.device = resolve_device(device)
        self.dynamics = dynamics.to(self.device)
        self.cost = cost.to(self.device)
        self.sampler = sampler.to(self.device)
        self.dt = float(dt)
        self.lam = float(lam)
        self.alpha = float(alpha)
        self.num_timesteps = int(num_timesteps)
        self.num_rollouts = int(num_rollouts)
        self.num_iters = int(num_iters)
        # keep the final iteration's (K, T, C) samples in SolveResult
        self.return_samples = bool(return_samples)
        # (C,) per-step decay toward zero of the slid-in tail (JAX
        # ControllerBase.slide_scale); None: the tail is zero control
        self.slide_scale = (None if slide_scale is None else torch.tensor(
            np.array(slide_scale, np.float32), device=self.device).reshape(
                self.dynamics.CONTROL_DIM))
        # the kernels' split form (JAX pallas_split_cost): None = AUTO
        # (ops/fused_rollout.resolve_split), True / False forced
        self.split_cost = split_cost
        # kernel="split": the cost pass carries the crash status over t
        # (True, the default: sticky-crash costs keep their semantics) or
        # evaluates every step at once without it (JAX sequential_crash)
        self.sequential_crash = bool(sequential_crash)
        if num_iters < 1:
            raise ValueError("num_iters must be >= 1")

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0, initial_mean=None) -> ControllerState:
        """The mean ``initial_mean`` (T, C) (zeros when None, JAX
        ControllerBase.init_state), a zero history; the generator seeded
        with ``seed``; the sampler's initial state."""
        T, C = self.num_timesteps, self.dynamics.CONTROL_DIM
        f32 = dict(dtype=torch.float32, device=self.device)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        if initial_mean is None:
            mean = torch.zeros((T, C), **f32)
        else:
            mean = torch.as_tensor(initial_mean, **f32).clone().reshape(T, C)
        return ControllerState(
            control_mean=mean,
            control_history=torch.zeros((2, C), **f32),
            generator=generator,
            previous_baseline=torch.tensor(1e8, **f32),
            sampler_state=self.sampler.init_state(),
        )

    # --- shared helpers ----------------------------------------------
    def _clamp_controls(self, U):
        """enforceConstraints over a (..., C) control tensor."""
        dyn = self.dynamics
        db = dyn.control_deadband
        shrunk = U - db * math_utils.sign(U)
        U = torch.where(torch.abs(U) < db, dyn.zero_control, shrunk)
        return torch.clamp(U, dyn.control_ranges[:, 0], dyn.control_ranges[:, 1])

    def _smooth(self, mean, history):
        return math_utils.savitzky_golay_smooth(mean, history)

    def _mean_trajectory(self, state, mean):
        return rollout_single(self.dynamics, state, mean, self.dt)

    def _free_energy_stats(self, weights, baseline, eta, previous_baseline):
        """FreeEnergyStats of one system's final iteration."""
        fe_mean, fe_var, fe_mod = weight_ops.compute_free_energy(
            weights, baseline, self.lam)
        return FreeEnergyStats(
            free_energy_mean=fe_mean,
            free_energy_variance=fe_var,
            free_energy_modified_variance=fe_mod,
            baseline=baseline,
            normalizer_percent=math_utils.true_div(eta, self.num_rollouts),
            previous_baseline=previous_baseline,
            increase=baseline - previous_baseline,
        )

    def slide_control_sequence(self, ctrl_state: ControllerState,
                               stride: int) -> ControllerState:
        """Shift the warm-start sequence (and the sampler's state) by
        ``stride`` and update the history (controller.cuh:347-360). Vacated
        tail steps decay toward zero by the controller's ``slide_scale``
        (zero control when it is None)."""
        mean = ctrl_state.control_mean
        new_mean, new_sampler_state = self.sampler.shift(
            mean, stride, self.slide_scale, ctrl_state.sampler_state)
        return ctrl_state.replace(
            control_mean=new_mean,
            control_history=math_utils.update_control_history(
                ctrl_state.control_history, mean, stride),
            sampler_state=new_sampler_state,
        )

    def get_current_control(self, result: SolveResult, rel_time: float):
        """Interpolate the feed-forward control at a wall-clock offset into
        the trajectory (interpolateControls, controller.cuh:363-378)."""
        T = self.num_timesteps
        idx_f = min(max(float(rel_time) / self.dt, 0.0), T - 1.0)
        lo = min(max(int(idx_f // 1), 0), T - 1)
        hi = min(lo + 1, T - 1)
        a = idx_f - lo
        u = (1 - a) * result.control_mean[lo] + a * result.control_mean[hi]
        return self._clamp_controls(u)
