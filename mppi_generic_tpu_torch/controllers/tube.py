"""Tube-MPPI controller, in PyTorch.

Counterpart of ``mppi_generic_tpu/controllers/tube.py`` (reference
``controllers/Tube-MPPI/tube_mppi_controller.{cuh,cu}``). The reference runs
the whole solve twice along ``blockDim.z = 2`` (real system and nominal
system) with two distributions that share one noise tensor. Here each
iteration draws the standard normals once and hands the same tensor to two
``VanillaMPPI._iteration`` calls, one per system; the JAX package gets the
same sharing by reusing one PRNG key, which a stateful ``torch.Generator``
cannot do.

Per solve (computeControl, tube_mppi_controller.cu:158-300):

* both systems are solved: the real one from the measured state around the
  real mean, the nominal one from the propagated nominal state around the
  nominal mean;
* if baseline_real < baseline_nominal + nominal_threshold, the nominal
  system adopts the real solution, state and control sequence (:268-280);
* the NOMINAL sequence is smoothed (:286, :328-331);
* the DDP feedback is recomputed to track the nominal trajectory.

``slide_control_sequence`` propagates the nominal state one step with the
first nominal control, saves the history from the nominal sequence and
slides both sequences (:315-325). Nothing waits on the device: the
acceptance is a ``torch.where``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mppi_generic_tpu_torch.controllers.base import SolveResult
from mppi_generic_tpu_torch.controllers.vanilla import VanillaMPPI
from mppi_generic_tpu_torch.utils import math_utils


@dataclasses.dataclass
class TubeControllerState:
    control_mean: torch.Tensor  # (T, C) real-system mean
    nominal_mean: torch.Tensor  # (T, C)
    nominal_state: torch.Tensor  # (S,)
    control_history: torch.Tensor  # (2, C)
    generator: torch.Generator
    nominal_initialized: bool = False  # host flag, set by the controller
    previous_baseline_real: Optional[torch.Tensor] = None
    previous_baseline_nominal: Optional[torch.Tensor] = None
    feedback_state: object = None

    def replace(self, **changes) -> "TubeControllerState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class TubeSolveResult:
    real: SolveResult
    nominal: SolveResult
    nominal_state_used: torch.Tensor  # () 0 if the real solution was adopted


class TubeMPPI(VanillaMPPI):
    def __init__(self, dynamics, cost, sampler, *, feedback=None,
                 nominal_threshold=100.0, **kwargs):
        if kwargs.get("kernel") == "fused_solve":
            raise NotImplementedError(
                "Tube-MPPI on the fused solve kernel (JAX robust.py:96's "
                "pallas_fused alias) is not ported yet; use 'fused' or 'combined'")
        super().__init__(dynamics, cost, sampler, **kwargs)
        if self.sampler.init_state() is not None:
            raise NotImplementedError(
                f"Tube-MPPI with a stateful sampler ({type(sampler).__name__}) "
                "is not ported")
        self.feedback = None if feedback is None else feedback.to(self.device)
        self.nominal_threshold = float(np.float32(nominal_threshold))

    def init_state(self, seed: int = 0) -> TubeControllerState:
        T, C, S = self.num_timesteps, self.dynamics.CONTROL_DIM, self.dynamics.STATE_DIM
        f32 = dict(dtype=torch.float32, device=self.device)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return TubeControllerState(
            control_mean=torch.zeros((T, C), **f32),
            nominal_mean=torch.zeros((T, C), **f32),
            nominal_state=torch.zeros((S,), **f32),
            control_history=torch.zeros((2, C), **f32),
            generator=generator,
            previous_baseline_real=torch.tensor(1e8, **f32),
            previous_baseline_nominal=torch.tensor(1e8, **f32),
            feedback_state=(None if self.feedback is None
                            else self.feedback.init_feedback_state(T)),
        )

    def solve(self, state, ctrl_state: TubeControllerState,
              optimization_stride: int = 0, injected_noise=None):
        """One Tube-MPPI solve from the real state ``state`` (S,). Returns
        (TubeSolveResult, new state). ``injected_noise`` (K, T, C) replaces
        the standard normals of every iteration (a test hook)."""
        nominal_state = (ctrl_state.nominal_state if ctrl_state.nominal_initialized
                         else state)
        mean_real = ctrl_state.control_mean
        mean_nom = ctrl_state.nominal_mean
        K, T, C = self.num_rollouts, self.num_timesteps, self.dynamics.CONTROL_DIM
        for it in range(self.num_iters):
            eps = injected_noise
            if eps is None:  # one draw, shared by both systems
                eps = torch.randn((K, T, C), generator=ctrl_state.generator,
                                  dtype=torch.float32, device=self.device)
            mean_real, _, diag_r = self._iteration(
                state, mean_real, None, ctrl_state.generator, it,
                optimization_stride, eps)
            mean_nom, _, diag_n = self._iteration(
                nominal_state, mean_nom, None, ctrl_state.generator, it,
                optimization_stride, eps)
        _, costs_r, w_r, bl_r, eta_r, crash_r = diag_r
        _, costs_n, w_n, bl_n, eta_n, crash_n = diag_n

        # acceptance (tube_mppi_controller.cu:268-280)
        accept_real = bl_r < bl_n + self.nominal_threshold
        mean_nom = torch.where(accept_real, mean_real, mean_nom)
        nominal_state = torch.where(accept_real, state, nominal_state)

        # smoothing applies to the nominal sequence (:286, :328-331)
        mean_nom = self._smooth(mean_nom, ctrl_state.control_history)
        states_nom, outputs_nom = self._mean_trajectory(nominal_state, mean_nom)
        states_real, outputs_real = self._mean_trajectory(state, mean_real)
        mean_nom = self._clamp_controls(mean_nom)
        mean_real = self._clamp_controls(mean_real)

        fb_state = ctrl_state.feedback_state
        if self.feedback is not None:
            # the ancillary controller tracks the nominal trajectory
            fb_state = self.feedback.compute_feedback(state, states_nom[:-1],
                                                      mean_nom)

        real = SolveResult(
            control_mean=mean_real, state_trajectory=states_real,
            output_trajectory=outputs_real, costs=costs_r, weights=w_r,
            baseline=bl_r, normalizer=eta_r,
            free_energy=self._free_energy_stats(w_r, bl_r, eta_r,
                                                ctrl_state.previous_baseline_real),
            crash=crash_r)
        nominal = SolveResult(
            control_mean=mean_nom, state_trajectory=states_nom,
            output_trajectory=outputs_nom, costs=costs_n, weights=w_n,
            baseline=bl_n, normalizer=eta_n,
            free_energy=self._free_energy_stats(w_n, bl_n, eta_n,
                                                ctrl_state.previous_baseline_nominal),
            crash=crash_n)
        result = TubeSolveResult(
            real=real, nominal=nominal,
            nominal_state_used=torch.where(accept_real, 0, 1))
        return result, ctrl_state.replace(
            control_mean=mean_real,
            nominal_mean=mean_nom,
            nominal_state=nominal_state,
            nominal_initialized=True,
            previous_baseline_real=bl_r,
            previous_baseline_nominal=bl_n,
            feedback_state=fb_state,
        )

    def slide_control_sequence(self, ctrl_state: TubeControllerState, stride: int):
        """tube_mppi_controller.cu:315-325: propagate the nominal state one
        dt with the first nominal control, save the history from the
        nominal sequence, slide both sequences."""
        x_nom = ctrl_state.nominal_state
        u0 = self.dynamics.enforce_constraints(x_nom, ctrl_state.nominal_mean[0])
        nominal_state, _ = self.dynamics.step(x_nom, u0, 0.0, self.dt)
        mean_n = ctrl_state.nominal_mean
        return ctrl_state.replace(
            control_mean=self.sampler.shift(ctrl_state.control_mean, stride,
                                            self.slide_scale)[0],
            nominal_mean=self.sampler.shift(mean_n, stride, self.slide_scale)[0],
            nominal_state=nominal_state,
            control_history=math_utils.update_control_history(
                ctrl_state.control_history, mean_n, stride),
        )

    def get_feedback_control(self, x, result: TubeSolveResult, fb_state, t: int):
        """u = u_nom[t] + K[t](x - x_nom[t]), clamped: what the plant
        applies."""
        u = result.nominal.control_mean[t]
        if self.feedback is not None:
            u = u + self.feedback.k(x, result.nominal.state_trajectory[t], t,
                                    fb_state)
        return self._clamp_controls(u)
