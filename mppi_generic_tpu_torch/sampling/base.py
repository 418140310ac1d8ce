"""Sampling-distribution base, in PyTorch.

Counterpart of ``mppi_generic_tpu/sampling/base.py``. The distribution
draws the (K, T, C) control-sample tensor around the mean, owns the MPPI
mean update (gaussian.cu:433-457) and slides the mean between solves.

Distributions that keep an extra sequence (Smooth-MPPI's derivative mean,
smooth-MPPI.cuh:12-73) thread it through an explicit ``state``:
``init_state() -> state``, and ``sample`` / ``update_mean`` / ``shift`` take
and return it; stateless distributions use ``state = None``. ``sample``
also returns an ``aux`` tensor with what the mean update needs (Smooth-
MPPI's derivative samples W), None for the others.
"""

from __future__ import annotations

import torch
from torch import nn

from mppi_generic_tpu_torch.utils.math_utils import slide_control_sequence


class SamplingDistribution(nn.Module):
    CONTROL_DIM = 0

    def init_state(self):
        """The sequence state carried across solves (None: stateless)."""
        return None

    def sample(self, generator, mean, num_rollouts, *, iteration=0,
               optimization_stride=0, state=None, injected_noise=None):
        """Draw the (K, T, C) control samples around ``mean`` (T, C).
        Returns (U, aux); aux goes back into ``update_mean``."""
        raise NotImplementedError

    def likelihood_ratio_cost(self, U, mean, lam, alpha, iteration=0):
        """Per-sample likelihood-ratio control cost (K,), summed over time
        and channel (mppi_common.cu:126-133)."""
        raise NotImplementedError

    def update_mean(self, U, aux, weights, normalizer, mean, state=None):
        """New mean: the weighted average of the samples
        (weightedReductionKernel, mppi_common.cu:710-765). Returns
        (new_mean, new_state)."""
        del aux, mean
        w = (weights / normalizer)[:, None, None]
        return torch.sum(w * U, dim=0), state

    def shift(self, mean, stride, slide_scale=None, state=None):
        """Slide the mean (and any sequence state) forward by ``stride``
        steps; vacated steps decay toward zero by ``slide_scale`` (C,) per
        step past the horizon (None: zero control). Returns (new_mean,
        new_state)."""
        return slide_control_sequence(mean, stride, slide_scale), state
