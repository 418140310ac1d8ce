"""Vanilla MPPI controller, in PyTorch.

Counterpart of ``mppi_generic_tpu/controllers/vanilla.py`` with normExp
weights (mppi_controller.cu:152-241). Per optimization iteration: sample
around the mean (Gaussian carve-outs), clamp, roll out with running and
likelihood-ratio costs, weight exp(-(J - baseline) / lambda), and take the
weighted mean. Afterwards: Savitzky-Golay smoothing, the re-rollout of the
mean, and a final clamp (mppi_controller.cu:225-231).

``kernel`` selects the rollout path; the names map to the JAX package's:

* ``"fused"`` (default) is JAX ``kernel="pallas"`` on its precomputed-noise
  branch (vanilla.py:265-309): one launch of the fused rollout kernel with
  the in-loop LR cost and the per-block flash epilogue, then one launch of
  the carry merge (ops/fused_rollout.py). The weights are recomputed from
  the kernel's baseline, as the JAX solve does.
* ``"combined"`` is JAX ``kernel="combined"`` (vanilla.py:310-317): the
  eager rollout oracle (ops/rollout.py), the LR cost from the sampler,
  baseline = min J and the sampler's mean update.

On a CPU device the fused path runs the kernels' plain versions. ``solve``
never waits for the device: the baseline, eta and free energy stay tensors.
"""

from __future__ import annotations

from mppi_generic_tpu_torch.controllers.base import (
    ControllerBase,
    ControllerState,
    SolveResult,
)
from mppi_generic_tpu_torch.ops import fused_rollout
from mppi_generic_tpu_torch.ops import rollout as rollout_ops
from mppi_generic_tpu_torch.ops import weights as weight_ops

KERNELS = ("fused", "combined")


class VanillaMPPI(ControllerBase):
    def __init__(self, dynamics, cost, sampler, *, kernel="fused", **kwargs):
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
        super().__init__(dynamics, cost, sampler, **kwargs)
        self.kernel = kernel

    def _iteration(self, x0, mean, generator, iteration, optimization_stride,
                   injected_noise):
        K = self.num_rollouts
        U = self.sampler.sample(
            generator, mean, K, iteration=iteration,
            optimization_stride=optimization_stride,
            injected_noise=injected_noise,
        )
        U = self._clamp_controls(U)
        if self.kernel == "fused":
            lr_params = (
                mean,
                self.sampler._sigma(self.num_timesteps, iteration),
                self.sampler.control_cost_coeff,
                self.lam,
                self.alpha,
                self.sampler.pure_threshold(K),
            )
            costs, crash, new_mean, baseline, eta = (
                fused_rollout.fused_weighted_rollout(
                    self.dynamics, self.cost, x0, U, self.dt, self.lam,
                    lr_params=lr_params,
                )
            )
            w = weight_ops.norm_exp_weights(costs, self.lam, baseline)
            return new_mean, (costs, w, baseline, eta, crash)
        lr = self.sampler.likelihood_ratio_cost(
            U, mean, self.lam, self.alpha, iteration=iteration)
        costs, _, crash = rollout_ops.rollout_combined(
            self.dynamics, self.cost, x0, U, self.dt)
        costs = costs + lr / self.num_timesteps
        baseline = weight_ops.baseline_cost(costs)
        w = weight_ops.norm_exp_weights(costs, self.lam, baseline)
        eta = weight_ops.normalizer(w)
        new_mean = self.sampler.update_mean(U, w, eta)
        return new_mean, (costs, w, baseline, eta, crash)

    def solve(self, state, ctrl_state: ControllerState,
              optimization_stride: int = 0, injected_noise=None):
        """One full MPPI solve from ``state`` (S,). Returns (SolveResult,
        new ControllerState). ``injected_noise`` (K, T, C) replaces the
        standard normals of every iteration (a test hook)."""
        mean = ctrl_state.control_mean
        for it in range(self.num_iters):
            mean, diag = self._iteration(
                state, mean, ctrl_state.generator, it, optimization_stride,
                injected_noise)
        costs, w, baseline, eta, crash = diag

        free_energy = self._free_energy_stats(w, baseline, eta,
                                              ctrl_state.previous_baseline)

        mean = self._smooth(mean, ctrl_state.control_history)
        states, outputs = self._mean_trajectory(state, mean)
        mean = self._clamp_controls(mean)

        result = SolveResult(
            control_mean=mean,
            state_trajectory=states,
            output_trajectory=outputs,
            costs=costs,
            weights=w,
            baseline=baseline,
            normalizer=eta,
            free_energy=free_energy,
            crash=crash,
        )
        return result, ctrl_state.replace(control_mean=mean,
                                          previous_baseline=baseline)
