"""Robust MPPI (RMPPI) controller, in PyTorch.

Counterpart of ``mppi_generic_tpu/controllers/robust.py`` (reference
``controllers/R-MPPI/robust_mppi_controller.{cuh,cu}`` and
``core/rmppi_kernels.cu``). Two stages per control cycle:

1. ``update_importance_sampling`` (updateImportanceSamplingControl,
   robust_mppi_controller.cu:548-632): build ``num_candidates`` candidate
   nominal states on the segments {nominal_0, nominal_1, real}
   (``line_search_weights``), evaluate each one's free energy with the same
   ``samples_per_condition`` samples, read with the candidate's stride
   (control t is min(t + stride, T - 1)), and take the LAST candidate whose
   free energy is below ``value_function_threshold``, else keep the
   previous choice. The nominal sequence slides by the chosen stride, and
   the DDP gains are recomputed against the new nominal trajectory.
2. ``solve`` (computeControl, :635-755): each sample rolls the nominal
   system open loop and the real system with the feedback
   u = clamp(U_k[t] + K[t](x_real - x_nom)); the nominal distribution is
   weighted with J_nom = 0.5 S_nom + 0.5 max(min(S_fb, threshold), S_nom)
   + LR_nom / T, the real one with J_real = S_real + LR_real / T. Both
   start from the nominal mean and share the samples.

``kernel`` selects the rollout paths; the names map to the JAX package's:

* ``"fused"`` (default) is JAX ``kernel="pallas"``: one launch of the
  rollout kernel with one initial state per sample for all
  (candidate, sample) pairs of stage 1, and one launch of the RMPPI rollout
  kernel for stage 2 (``ops/fused_rollout.py``). ``"fused_solve"`` (JAX
  ``pallas_fused``) is the same path: the augmented rollout has its own
  kernel, and the JAX package maps the one name to the other
  (``_equivalent_kernels``, robust.py:96); the controller keeps "fused".
  Every pair of ``ops/fused_rollout._PAIRS`` has both entries, but the racer
  LSTM models, whose B8 the JAX kernel refuses (a recurrent model): their
  stage 2 runs the eager augmented rollout, as JAX's runs its XLA scan.
* ``"combined"`` is JAX ``kernel="combined"``, the eager oracle: one
  ``rollout_combined`` per candidate and the augmented rollout as a loop.
  ``"split"`` is accepted and runs the same eager paths, as the JAX
  package's RMPPI runs them for it (robust.py:175, :369).

``split_cost`` reaches stage 1's rollout kernel (its per-sample-x0 mode),
as JAX passes ``pallas_split_cost`` there (robust.py:207): True runs B1's
split form from one x0 per sample (every pair whose cost is eligible), None
(AUTO) what ``fused_rollout.AUTO_SPLIT`` measured for the pair's
"rollout_x0", False the combined kernel.

Where a kernel wrapper raises ``ops.KernelIncompatible`` (JAX's
``PallasIncompatible``: a recurrent model in B8, ``split_cost=True`` with an
ineligible cost) the stage runs its eager path, as the JAX controller runs
XLA there (robust.py:209, :385). A stateful sampler (Smooth-MPPI's
derivative mean) carries its ``sampler_state`` as the JAX controller does:
stage 1 samples the candidates from it and shifts it with the nominal
sequence; stage 2 samples from it, and the nominal update carries it on.

The chosen stride, the best index and the baselines stay tensors on the
device: nothing in either stage waits on it. ``nominal_initialized`` is a
host bool that the controller sets itself, so the first
``update_importance_sampling`` skips the candidate evaluation that the JAX
package computes and then discards with ``jnp.where`` (:243-247): on that
call the nominal state is the real one, with stride 0 and best index 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mppi_generic_tpu_torch.controllers.base import ControllerBase, SolveResult
from mppi_generic_tpu_torch.feedback.ilqr import DDPFeedbackState
from mppi_generic_tpu_torch.models.base import rollout_single
from mppi_generic_tpu_torch.ops import fused_rollout
from mppi_generic_tpu_torch.ops import rollout as rollout_ops
from mppi_generic_tpu_torch.ops import weights as weight_ops
from mppi_generic_tpu_torch.ops.fused_rollout import KernelIncompatible
from mppi_generic_tpu_torch.utils import math_utils
from mppi_generic_tpu_torch.utils.math_utils import true_div

KERNELS = ("fused", "combined", "fused_solve", "split")
# kernel names that run the same program (JAX RobustMPPI._equivalent_kernels)
EQUIVALENT_KERNELS = {"fused_solve": "fused"}


def line_search_weights(num_candidates: int) -> np.ndarray:
    """(3, num_candidates) float32 interpolation weights over
    {nominal_0, nominal_1, real} (computeLineSearchWeights,
    robust_mppi_controller.cu:480-498). num_candidates must be odd >= 3."""
    if num_candidates < 3 or num_candidates % 2 == 0:
        raise ValueError(f"num_candidates must be odd and >= 3, got {num_candidates}")
    m = num_candidates // 2
    w = [[1 - i / m, i / m, 0.0] for i in range(m + 1)]
    w += [[0.0, 1 - i / m, i / m] for i in range(1, m + 1)]
    return np.asarray(w, np.float32).T


@dataclasses.dataclass
class RobustControllerState:
    """Warm-start state of both systems, carried between control cycles."""

    control_mean: torch.Tensor  # (T, C) real-system sequence
    nominal_mean: torch.Tensor  # (T, C)
    nominal_state: torch.Tensor  # (S,)
    nominal_traj: torch.Tensor  # (T, S) nominal state trajectory
    control_history: torch.Tensor  # (2, C) real history
    nominal_control_history: torch.Tensor  # (2, C)
    generator: torch.Generator
    feedback_state: DDPFeedbackState
    nominal_initialized: bool = False  # host flag, set by the controller
    previous_baseline_real: Optional[torch.Tensor] = None
    previous_baseline_nominal: Optional[torch.Tensor] = None
    best_index: Optional[torch.Tensor] = None  # () int64, on the device
    nominal_stride: Optional[torch.Tensor] = None  # () int64, on the device
    sampler_state: object = None  # the sampler's sequence state (Smooth-MPPI)

    def replace(self, **changes) -> "RobustControllerState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class RobustSolveResult:
    real: SolveResult
    nominal: SolveResult
    best_index: torch.Tensor
    # the JAX result's field; stage 1 returns the free energies, and solve
    # leaves it None, as the JAX package does
    candidate_free_energy: Optional[torch.Tensor] = None


class RobustMPPI(ControllerBase):
    KERNELS = KERNELS
    # the kernel tuner times each of these programs once (ops/autotune.py)
    equivalent_kernels = EQUIVALENT_KERNELS

    def __init__(self, dynamics, cost, sampler, *, feedback,
                 value_function_threshold=1e8, num_candidates=9,
                 samples_per_condition=256, kernel="fused", **kwargs):
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
        super().__init__(dynamics, cost, sampler, **kwargs)
        self.kernel = EQUIVALENT_KERNELS.get(kernel, kernel)
        self.feedback = feedback.to(self.device)
        self.value_function_threshold = float(np.float32(value_function_threshold))
        self.num_candidates = int(num_candidates)
        self.samples_per_condition = int(samples_per_condition)
        self._weights = line_search_weights(self.num_candidates)
        self.register_buffer("line_search_w", torch.as_tensor(
            self._weights, device=self.device))
        self._cand_strides = {}

    def init_state(self, seed: int = 0) -> RobustControllerState:
        """Zero means, histories and nominal state; the generator seeded
        with ``seed``."""
        T, C, S = self.num_timesteps, self.dynamics.CONTROL_DIM, self.dynamics.STATE_DIM
        f32 = dict(dtype=torch.float32, device=self.device)
        i64 = dict(dtype=torch.int64, device=self.device)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return RobustControllerState(
            control_mean=torch.zeros((T, C), **f32),
            nominal_mean=torch.zeros((T, C), **f32),
            nominal_state=torch.zeros((S,), **f32),
            nominal_traj=torch.zeros((T, S), **f32),
            control_history=torch.zeros((2, C), **f32),
            nominal_control_history=torch.zeros((2, C), **f32),
            generator=generator,
            feedback_state=self.feedback.init_feedback_state(T),
            previous_baseline_real=torch.tensor(1e8, **f32),
            previous_baseline_nominal=torch.tensor(1e8, **f32),
            best_index=torch.zeros((), **i64),
            nominal_stride=torch.zeros((), **i64),
            sampler_state=self.sampler.init_state(),
        )

    # --- stage 1: importance-sampling update ------------------------------
    def _candidate_strides(self, stride: int) -> torch.Tensor:
        """(n,) int64 stride of each candidate, round([0, s, s] @ W) in
        float32 as the JAX package forms it; made once per host stride."""
        if stride not in self._cand_strides:
            sv = np.asarray([0.0, stride, stride], np.float32)
            strides = np.round(sv @ self._weights).astype(np.int64)
            self._cand_strides[stride] = torch.as_tensor(strides, device=self.device)
        return self._cand_strides[stride]

    def _candidate_costs(self, candidates, cand_strides, U, mean):
        """(n, S_per) cost of every candidate's rollouts: running + terminal
        plus the likelihood-ratio term of its shifted samples, over T."""
        T = self.num_timesteps
        n, S_per = self.num_candidates, self.samples_per_condition
        t_idx = (torch.arange(T, device=self.device)[None, :]
                 + cand_strides[:, None]).clamp(0, T - 1)  # (n, T)
        U_all = U[:, t_idx].transpose(0, 1)  # (n, S_per, T, C)
        lr = self.sampler.likelihood_ratio_cost(U_all, mean, self.lam, self.alpha)
        if self.kernel == "fused":
            x0_all = candidates.repeat_interleave(S_per, dim=0)  # (n*S_per, S)
            try:
                costs, _ = fused_rollout.fused_rollout_costs(
                    self.dynamics, self.cost, x0_all,
                    U_all.reshape(n * S_per, T, -1), self.dt, split_cost=self.split_cost)
                return costs.reshape(n, S_per) + true_div(lr, T)
            except KernelIncompatible:  # the eager rollout (JAX robust.py:209)
                pass
        return torch.stack([
            rollout_ops.rollout_combined(self.dynamics, self.cost, candidates[i],
                                         U_all[i], self.dt)[0] + true_div(lr[i], T)
            for i in range(n)])

    def update_importance_sampling(self, state, ctrl_state: RobustControllerState,
                                   stride: int = 1, injected_noise=None):
        """Stage 1 (robust_mppi_controller.cu:548-571). ``stride`` is a host
        integer; ``injected_noise`` (samples_per_condition, T, C) replaces
        the standard normals of the candidate samples (a test hook).
        Returns (new state, candidate free energies (n,))."""
        n = self.num_candidates
        if not ctrl_state.nominal_initialized:
            nominal_state = state
            nominal_stride = torch.zeros((), dtype=torch.int64, device=self.device)
            best = torch.zeros((), dtype=torch.int64, device=self.device)
            cand_fe = torch.zeros((n,), dtype=torch.float32, device=self.device)
        else:
            points = torch.stack([ctrl_state.nominal_traj[0],
                                  ctrl_state.nominal_traj[1], state], dim=1)
            candidates = (points @ self.line_search_w).T.contiguous()  # (n, S)
            cand_strides = self._candidate_strides(int(stride))
            # one sample set shared by all candidates
            # (rmppi_kernels.cu:70, readControlSample(candidate_sample_idx))
            U, _ = self.sampler.sample(
                ctrl_state.generator, ctrl_state.nominal_mean,
                self.samples_per_condition, iteration=0,
                optimization_stride=stride, state=ctrl_state.sampler_state,
                injected_noise=injected_noise)
            U = self._clamp_controls(U)
            cand_costs = self._candidate_costs(candidates, cand_strides, U,
                                               ctrl_state.nominal_mean)
            # baseline over all evaluation rollouts (computeCandidateBaseline)
            baseline = torch.amin(cand_costs)
            fe = torch.mean(torch.exp(true_div(-(cand_costs - baseline), self.lam)), dim=1)
            cand_fe = -self.lam * torch.log(fe) + baseline
            # the LAST candidate below the threshold (computeBestIndex
            # :527-545), else the previous choice
            below = cand_fe < self.value_function_threshold
            idx = torch.arange(n, device=self.device)
            best = torch.where(torch.any(below),
                               torch.amax(torch.where(below, idx, -1)),
                               ctrl_state.best_index)
            nominal_state = candidates.index_select(0, best.reshape(1))[0]
            nominal_stride = cand_strides.index_select(0, best.reshape(1))[0]

        # histories, then slide the nominal sequence by its stride
        mean_n = ctrl_state.nominal_mean
        nom_hist = math_utils.update_control_history(
            ctrl_state.nominal_control_history, mean_n, nominal_stride)
        real_hist = math_utils.update_control_history(
            ctrl_state.control_history, ctrl_state.control_mean, int(stride))
        new_nominal_mean, samp_state = self.sampler.shift(
            mean_n, nominal_stride, self.slide_scale, ctrl_state.sampler_state)
        # the nominal trajectory and the feedback gains that track it
        states_nom, _ = rollout_single(self.dynamics, nominal_state,
                                       new_nominal_mean, self.dt)
        fb_state = self.feedback.compute_feedback(state, states_nom[:-1],
                                                  new_nominal_mean)
        return ctrl_state.replace(
            nominal_mean=new_nominal_mean,
            nominal_state=nominal_state,
            nominal_traj=states_nom[:-1],
            nominal_control_history=nom_hist,
            control_history=real_hist,
            nominal_initialized=True,
            feedback_state=fb_state,
            best_index=best,
            nominal_stride=nominal_stride,
            sampler_state=samp_state,
        ), cand_fe

    # --- stage 2: augmented solve ------------------------------------------
    def _augmented_rollout(self, x0_nom, x0_real, U, fb_state):
        """Eager oracle of the RMPPI rollout kernel (the JAX package's
        augmented scan): (s_nom, j_real, s_fb, crash_real, U_real)."""
        K, T, C = U.shape
        Uc = U.permute(2, 1, 0)  # (C, T, K)
        x_nom = x0_nom[:, None].expand(-1, K)
        x_real = x0_real[:, None].expand(-1, K)
        zeros = torch.zeros((K,), dtype=torch.float32, device=U.device)
        crash_n = crash_r = torch.zeros((K,), dtype=torch.int32, device=U.device)
        s_nom = j_real = s_fb = zeros
        u_real_t = []
        for t in range(T):
            u_raw = Uc[:, t]
            u_nom = self.dynamics.enforce_constraints(x_nom, u_raw)
            u_fb = self.feedback.k(x_real, x_nom, t, fb_state)
            u_real = self.dynamics.enforce_constraints(x_real, u_raw + u_fb)
            x_nom, y_nom = self.dynamics.step(x_nom, u_nom, float(t), self.dt)
            x_real, y_real = self.dynamics.step(x_real, u_real, float(t), self.dt)
            c_nom, crash_n = self.cost.running_cost(y_nom, u_nom, t, crash_n)
            c_real, crash_r = self.cost.running_cost(y_real, u_real, t, crash_r)
            fb_cost = self.sampler.feedback_cost_step(u_fb, t, self.lam, self.alpha)
            s_nom = s_nom + c_nom
            j_real = j_real + c_real
            s_fb = s_fb + c_real + fb_cost
            u_real_t.append(u_real)
        term_n = self.cost.terminal_cost(y_nom)
        term_r = self.cost.terminal_cost(y_real)
        return (true_div(s_nom + term_n, T), true_div(j_real + term_r, T),
                true_div(s_fb + term_r, T),
                crash_r, torch.stack(u_real_t).permute(2, 0, 1))

    def solve(self, state, ctrl_state: RobustControllerState,
              optimization_stride: int = 0, injected_noise=None):
        """Stage 2 from the real state ``state`` (S,). Returns
        (RobustSolveResult, new state). ``injected_noise`` (K, T, C)
        replaces the standard normals of every iteration (a test hook)."""
        T = self.num_timesteps
        mean_nom = ctrl_state.nominal_mean
        mean_real = mean_nom  # both distributions start from the nominal mean
        nominal_state = (ctrl_state.nominal_state if ctrl_state.nominal_initialized
                         else state)
        samp_state = ctrl_state.sampler_state
        for it in range(self.num_iters):
            U, aux = self.sampler.sample(
                ctrl_state.generator, mean_nom, self.num_rollouts, iteration=it,
                optimization_stride=optimization_stride, state=samp_state,
                injected_noise=injected_noise)
            # the rollouts clamp inside their loop; the once-clamped copy
            # feeds the nominal likelihood term and the mean updates
            U_c = self._clamp_controls(U)
            fused = self.kernel == "fused"
            if fused:
                try:
                    s_nom, j_real_state, s_fb, crash, U_real = (
                        fused_rollout.fused_rmppi_rollout(
                            self.dynamics, self.cost, nominal_state, state, U,
                            ctrl_state.feedback_state.gains, self.sampler._sigma(T, 0),
                            self.sampler.control_cost_coeff, self.dt, self.lam,
                            self.alpha))
                except KernelIncompatible:  # the eager scan (JAX robust.py:385)
                    fused = False
            if not fused:
                s_nom, j_real_state, s_fb, crash, U_real = self._augmented_rollout(
                    nominal_state, state, U, ctrl_state.feedback_state)
            # likelihood ratios: the nominal one of the clamped sample, the
            # real one of the feedback-included control (rmppi_kernels.cu:595-615)
            lr_nom = self.sampler.likelihood_ratio_cost(
                U_c, mean_nom, self.lam, self.alpha, iteration=it)
            lr_real = self.sampler.likelihood_ratio_cost(
                U_real, mean_nom, self.lam, self.alpha, iteration=it)
            j_real = j_real_state + true_div(lr_real, T)
            j_nom = (0.5 * s_nom
                     + 0.5 * torch.maximum(
                         torch.clamp_max(s_fb, self.value_function_threshold), s_nom)
                     + true_div(lr_nom, T))
            bl_n = weight_ops.baseline_cost(j_nom)
            bl_r = weight_ops.baseline_cost(j_real)
            w_n = weight_ops.norm_exp_weights(j_nom, self.lam, bl_n)
            w_r = weight_ops.norm_exp_weights(j_real, self.lam, bl_r)
            eta_n = weight_ops.normalizer(w_n)
            eta_r = weight_ops.normalizer(w_r)
            mean_nom, samp_state = self.sampler.update_mean(U_c, aux, w_n, eta_n,
                                                            mean_nom, samp_state)
            mean_real, _ = self.sampler.update_mean(U_c, aux, w_r, eta_r, mean_real,
                                                    ctrl_state.sampler_state)

        # each sequence smooths with its own history (:736-738)
        mean_real = self._smooth(mean_real, ctrl_state.control_history)
        mean_nom = self._smooth(mean_nom, ctrl_state.nominal_control_history)
        states_nom, outputs_nom = self._mean_trajectory(nominal_state, mean_nom)
        states_real, outputs_real = self._mean_trajectory(state, mean_real)
        mean_real = self._clamp_controls(mean_real)
        mean_nom = self._clamp_controls(mean_nom)

        real = SolveResult(
            control_mean=mean_real, state_trajectory=states_real,
            output_trajectory=outputs_real, costs=j_real, weights=w_r,
            baseline=bl_r, normalizer=eta_r,
            free_energy=self._free_energy_stats(w_r, bl_r, eta_r,
                                                ctrl_state.previous_baseline_real),
            crash=crash)
        nominal = SolveResult(
            control_mean=mean_nom, state_trajectory=states_nom,
            output_trajectory=outputs_nom, costs=j_nom, weights=w_n,
            baseline=bl_n, normalizer=eta_n,
            free_energy=self._free_energy_stats(w_n, bl_n, eta_n,
                                                ctrl_state.previous_baseline_nominal),
            crash=crash)
        new_state = ctrl_state.replace(
            control_mean=mean_real,
            nominal_mean=mean_nom,
            nominal_state=nominal_state,
            nominal_traj=states_nom[:-1],
            nominal_initialized=True,
            previous_baseline_real=bl_r,
            previous_baseline_nominal=bl_n,
            sampler_state=samp_state,
        )
        return (RobustSolveResult(real=real, nominal=nominal,
                                  best_index=ctrl_state.best_index), new_state)

    def slide_control_sequence(self, ctrl_state, stride):
        """No-op: RMPPI slides inside update_importance_sampling
        (robust_mppi_controller.cuh:190)."""
        return ctrl_state

    def compute_df(self, result: RobustSolveResult):
        """Tube-divergence metric (computeDF, robust_mppi_controller.cu:758-762):
        the distance between the real and the nominal initial state."""
        return torch.linalg.norm(result.real.state_trajectory[0]
                                 - result.nominal.state_trajectory[0])
