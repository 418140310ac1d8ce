"""Colored-noise MPPI controller, in PyTorch.

Counterpart of ``mppi_generic_tpu/controllers/colored.py`` (reference
``controllers/ColoredMPPI/colored_mppi_controller.{cuh,cu}``): the vanilla
loop over a ``ColoredNoiseDistribution`` sampler, with two extras:

* Tsallis-divergence weighting with (gamma, r) (colored_mppi_controller.cu:206,
  params :16-39), through ``VanillaMPPI``'s ``weight_transform="tsallis"``;
  on ``kernel="fused"`` it runs the rollout kernel's Tsallis mode, the
  Tsallis reduction kernel and the merge;
* an optional state leash (:151-154): before the solve, the measured state
  is clamped to within ``state_leash_dist`` of the previous solve's
  predicted state at the slide offset (``Dynamics.enforce_leash``).

The colored noise is drawn eagerly (``sampling/colored.py``), so the path
that draws its samples inside the kernels (``kernel="fused_solve"``) is not
available with this sampler.
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.controllers.vanilla import VanillaMPPI


class ColoredMPPI(VanillaMPPI):
    def __init__(self, dynamics, cost, sampler, *, state_leash_dist=None, **kwargs):
        super().__init__(dynamics, cost, sampler, **kwargs)
        # (S,) per-dimension leash distance; None disables the leash
        self.state_leash_dist = (None if state_leash_dist is None else torch.tensor(
            np.asarray(state_leash_dist, np.float32), device=self.device))

    def apply_leash(self, state, prev_state_trajectory, leash_jump):
        """The solve's input: the measured ``state`` clamped to within the
        leash of the previous solve's predicted state at index
        ``leash_jump`` (the slide stride, colored_mppi_controller.cu:151-154,
        :264), clipped to the trajectory. ``leash_jump`` is a host integer
        or an integer tensor (read on the device, no host sync)."""
        if self.state_leash_dist is None:
            return state
        last = prev_state_trajectory.shape[0] - 1
        if isinstance(leash_jump, torch.Tensor):
            idx = torch.clamp(leash_jump.reshape(1).long(), 0, last)
            predicted = torch.index_select(prev_state_trajectory, 0, idx)[0]
        else:
            predicted = prev_state_trajectory[min(max(int(leash_jump), 0), last)]
        return self.dynamics.enforce_leash(state, predicted, self.state_leash_dist)
