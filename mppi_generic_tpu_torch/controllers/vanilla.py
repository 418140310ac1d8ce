"""Vanilla MPPI controller, in PyTorch.

Counterpart of ``mppi_generic_tpu/controllers/vanilla.py``
(mppi_controller.cu:152-241). Per optimization iteration: sample around the
mean (Gaussian carve-outs), clamp, roll out with running and
likelihood-ratio costs, weight the costs, and update the mean through the
sampler. Afterwards: Savitzky-Golay smoothing, the re-rollout of the mean,
and a final clamp (mppi_controller.cu:225-231).

``weight_transform`` is ``"exp"`` (normExp, exp(-(J - baseline) / lambda)),
``"tsallis"`` or ``"cem"``; a ``shaping_function`` (``shaping/``) given to
the controller replaces it, as in the JAX package. The samplers are the
Gaussian, NLN (log-MPPI), Smooth-MPPI and colored-noise distributions.
``kernel`` selects the path; the names map to the JAX package's:

* ``"fused_solve"`` is JAX ``kernel="pallas_fused"`` (vanilla.py:157-253):
  the samples are drawn inside the kernels from a per-iteration seed.
  ``exp`` with the Gaussian or NLN sampler runs one launch of the fused
  solve kernel (``ops/fused_solve.py``) and one of the carry merge; ``exp``
  with Smooth-MPPI runs the sampling kernel with its flash epilogue over
  the derivative samples (``ops/fused_rollout.fused_sample_rollout_costs``)
  and the merge; ``tsallis`` and ``cem`` run the sampling kernel, then the
  weights and the sampler's mean update eagerly. The weights of
  SolveResult are recomputed from the kernels' costs and baseline. The
  colored sampler draws eagerly and refuses this path (JAX falls back to
  its XLA draw there).
* ``"fused"`` (default) is JAX ``kernel="pallas"``: the sampler draws
  eagerly, then ``exp`` runs one launch of the fused rollout kernel with
  the in-loop LR cost and the flash epilogue and one of the carry merge
  (``ops/fused_rollout.py``); ``tsallis`` runs the rollout kernel in its
  Tsallis mode (costs and per-block minima), the Tsallis reduction kernel
  against the global minimum and the merge (baseline = the minimum cost,
  eta = the sum of the weights). Smooth-MPPI (whose mean update weights W,
  not U), ``cem`` and a shaping function run the rollout kernel's
  plain-costs mode with the LR cost, then the weights and the mean update
  eagerly (JAX vanilla.py:94-118, :265-317).
* ``"combined"`` is JAX ``kernel="combined"`` (vanilla.py:255-317): the
  eager rollout oracle (``ops/rollout.py``), the LR cost from the sampler,
  baseline = min J, the weights and the sampler's mean update.

On a CPU device the kernel paths run the kernels' plain versions. ``solve``
never waits for the device: the seeds, baseline, eta and free energy stay
tensors on it.
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.controllers.base import (
    ControllerBase,
    ControllerState,
    SolveResult,
)
from mppi_generic_tpu_torch.ops import fused_rollout, fused_solve
from mppi_generic_tpu_torch.ops import rollout as rollout_ops
from mppi_generic_tpu_torch.ops import weights as weight_ops
from mppi_generic_tpu_torch.sampling.colored import ColoredNoiseDistribution
from mppi_generic_tpu_torch.sampling.smooth import SmoothMPPIDistribution
from mppi_generic_tpu_torch.utils.math_utils import true_div

KERNELS = ("fused", "combined", "fused_solve")
WEIGHT_TRANSFORMS = ("exp", "tsallis", "cem")


class VanillaMPPI(ControllerBase):
    def __init__(self, dynamics, cost, sampler, *, kernel="fused",
                 weight_transform="exp", tsallis_gamma=10.0, tsallis_r=2.0,
                 cem_elite_fraction=0.1, shaping_function=None, **kwargs):
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
        if weight_transform not in WEIGHT_TRANSFORMS:
            raise ValueError(f"weight_transform must be one of {WEIGHT_TRANSFORMS}, "
                             f"got {weight_transform!r}")
        if kernel == "fused_solve" and isinstance(sampler, ColoredNoiseDistribution):
            raise NotImplementedError(
                "the colored sampler draws its noise eagerly, not inside the "
                "kernels: use kernel='fused' (or 'combined')")
        super().__init__(dynamics, cost, sampler, **kwargs)
        self.kernel = kernel
        self.weight_transform = weight_transform
        # host floats in float32, as the JAX controller holds them
        self.tsallis_gamma = float(np.float32(tsallis_gamma))
        self.tsallis_r = float(np.float32(tsallis_r))
        self.cem_elite_fraction = float(np.float32(cem_elite_fraction))
        # a shaping function (shaping/) overrides weight_transform
        self.shaping_function = shaping_function

    def _transform_weights(self, costs, baseline):
        if self.shaping_function is not None:
            return self.shaping_function.compute_weights(costs, baseline)
        if self.weight_transform == "exp":
            return weight_ops.norm_exp_weights(costs, self.lam, baseline)
        if self.weight_transform == "tsallis":
            return weight_ops.tsallis_weights(costs, self.tsallis_gamma,
                                              self.tsallis_r, baseline)
        return weight_ops.cem_weights(costs, self.cem_elite_fraction)

    def _eager_update(self, U, aux, costs, mean, samp_state):
        """Weights, eta and the sampler's mean update from the costs."""
        baseline = weight_ops.baseline_cost(costs)
        w = self._transform_weights(costs, baseline)
        eta = weight_ops.normalizer(w)
        new_mean, samp_state = self.sampler.update_mean(U, aux, w, eta, mean,
                                                        samp_state)
        return new_mean, samp_state, w, baseline, eta

    def _seed(self, generator):
        """The kernels' seed of one iteration, drawn on the device."""
        return torch.randint(0, 2**31 - 1, (), generator=generator,
                             dtype=torch.int32, device=self.device)

    def _iteration_fused_solve(self, x0, mean, samp_state, generator, iteration,
                               optimization_stride, injected_noise):
        args = (self.dynamics, self.cost, self.sampler, x0, mean,
                self._seed(generator), self.dt, self.lam, self.alpha,
                self.num_rollouts)
        kw = dict(iteration=iteration, optimization_stride=optimization_stride,
                  injected_noise=injected_noise)
        smooth = type(self.sampler) is SmoothMPPIDistribution
        exp = self.weight_transform == "exp" and self.shaping_function is None
        if exp and not smooth:
            costs, crash, new_mean, baseline, eta, U = (
                fused_solve.fused_solve_iteration(
                    *args, return_samples=self.return_samples, **kw))
            w = weight_ops.norm_exp_weights(costs, self.lam, baseline)
            return new_mean, samp_state, (U, costs, w, baseline, eta, crash)
        if exp:
            # the flash epilogue over W, which Smooth-MPPI's mean update
            # weights (smooth-MPPI.cu:203-236)
            costs, crash, U, deriv_mean, baseline, eta = (
                fused_rollout.fused_sample_rollout_costs(
                    *args, sampler_state=samp_state, epilogue=True,
                    emit_samples=self.return_samples, **kw))
            new_mean = mean + deriv_mean * self.sampler.dt_smooth
            w = weight_ops.norm_exp_weights(costs, self.lam, baseline)
            return new_mean, deriv_mean, (U, costs, w, baseline, eta, crash)
        costs, crash, U, aux = fused_rollout.fused_sample_rollout_costs(
            *args, sampler_state=samp_state, **kw)
        new_mean, samp_state, w, baseline, eta = self._eager_update(
            U, aux, costs, mean, samp_state)
        return new_mean, samp_state, (U, costs, w, baseline, eta, crash)

    def _iteration(self, x0, mean, samp_state, generator, iteration,
                   optimization_stride, injected_noise):
        """One optimization iteration: (new mean, new sampler state,
        (U, costs, weights, baseline, eta, crash))."""
        if self.kernel == "fused_solve":
            return self._iteration_fused_solve(
                x0, mean, samp_state, generator, iteration, optimization_stride,
                injected_noise)
        K, T = self.num_rollouts, self.num_timesteps
        U, aux = self.sampler.sample(
            generator, mean, K, iteration=iteration,
            optimization_stride=optimization_stride, state=samp_state,
            injected_noise=injected_noise,
        )
        U = self._clamp_controls(U)
        if self.kernel == "fused":
            lr_params = (
                mean,
                self.sampler._sigma(T, iteration),
                self.sampler.control_cost_coeff,
                self.lam,
                self.alpha,
                self.sampler.pure_threshold(K),
            )
            if (self.weight_transform in ("exp", "tsallis")
                    and self.shaping_function is None and aux is None):
                # the whole epilogue in the kernels; Tsallis: baseline = the
                # minimum cost, eta = the sum of the Tsallis weights
                costs, crash, new_mean, baseline, eta = (
                    fused_rollout.fused_weighted_rollout(
                        self.dynamics, self.cost, x0, U, self.dt, self.lam,
                        lr_params=lr_params, weight_kind=self.weight_transform,
                        weight_params=(self.tsallis_gamma, self.tsallis_r),
                    )
                )
                w = self._transform_weights(costs, baseline)
                return new_mean, samp_state, (U, costs, w, baseline, eta, crash)
            costs, crash = fused_rollout.fused_rollout_costs(
                self.dynamics, self.cost, x0, U, self.dt, lr_params=lr_params)
        else:
            lr = self.sampler.likelihood_ratio_cost(
                U, mean, self.lam, self.alpha, iteration=iteration)
            costs, _, crash = rollout_ops.rollout_combined(
                self.dynamics, self.cost, x0, U, self.dt)
            costs = costs + true_div(lr, T)
        new_mean, samp_state, w, baseline, eta = self._eager_update(
            U, aux, costs, mean, samp_state)
        return new_mean, samp_state, (U, costs, w, baseline, eta, crash)

    def solve(self, state, ctrl_state: ControllerState,
              optimization_stride: int = 0, injected_noise=None):
        """One full MPPI solve from ``state`` (S,). Returns (SolveResult,
        new ControllerState). ``injected_noise`` replaces the standard
        normals of every iteration (a test hook): (K, T, C), or
        (2, K, T, C) for the NLN sampler's two normals."""
        mean = ctrl_state.control_mean
        samp_state = ctrl_state.sampler_state
        for it in range(self.num_iters):
            mean, samp_state, diag = self._iteration(
                state, mean, samp_state, ctrl_state.generator, it,
                optimization_stride, injected_noise)
        U, costs, w, baseline, eta, crash = diag

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
            sampled_controls=U if self.return_samples else None,
        )
        return result, ctrl_state.replace(control_mean=mean,
                                          previous_baseline=baseline,
                                          sampler_state=samp_state)
