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
(controller.cuh:643-663) and the free-energy statistics
(controller.cuh:22-38).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mppi_generic_tpu_torch.models.base import rollout_single
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


@dataclasses.dataclass
class ControllerState:
    """Warm-start state carried between solves: the mean, the 2-step
    executed-control history, the previous baseline and the generator the
    samples are drawn from (stateful: solves advance it in place)."""

    control_mean: torch.Tensor  # (T, C)
    control_history: torch.Tensor  # (2, C)
    generator: torch.Generator
    previous_baseline: torch.Tensor  # ()

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
                 num_iters=1, device=None):
        super().__init__()
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
        if num_iters < 1:
            raise ValueError("num_iters must be >= 1")

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> ControllerState:
        """Zero mean and history; the generator seeded with ``seed``."""
        T, C = self.num_timesteps, self.dynamics.CONTROL_DIM
        f32 = dict(dtype=torch.float32, device=self.device)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return ControllerState(
            control_mean=torch.zeros((T, C), **f32),
            control_history=torch.zeros((2, C), **f32),
            generator=generator,
            previous_baseline=torch.tensor(1e8, **f32),
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

    def slide_control_sequence(self, ctrl_state: ControllerState,
                               stride: int) -> ControllerState:
        """Shift the warm-start sequence by ``stride`` and update the
        history (controller.cuh:347-360). Vacated tail steps become zero
        control (the JAX default, no ``slide_scale``)."""
        mean = ctrl_state.control_mean
        return ctrl_state.replace(
            control_mean=self.sampler.shift(mean, stride),
            control_history=math_utils.update_control_history(
                ctrl_state.control_history, mean, stride),
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
