"""Sampling-distribution base, in PyTorch.

Counterpart of ``mppi_generic_tpu/sampling/base.py``. The distribution
draws the (K, T, C) control-sample tensor around the mean, owns the MPPI
mean update (gaussian.cu:433-457) and slides the mean between solves. The
ported distributions are stateless, so the JAX ``state``/``aux`` plumbing
is left out.
"""

from __future__ import annotations

import torch
from torch import nn

from mppi_generic_tpu_torch.utils.math_utils import slide_control_sequence


class SamplingDistribution(nn.Module):
    CONTROL_DIM = 0

    def sample(self, generator, mean, num_rollouts, *, iteration=0,
               optimization_stride=0, injected_noise=None):
        """Draw the (K, T, C) control samples around ``mean`` (T, C)."""
        raise NotImplementedError

    def likelihood_ratio_cost(self, U, mean, lam, alpha, iteration=0):
        """Per-sample likelihood-ratio control cost (K,), summed over time
        and channel (mppi_common.cu:126-133)."""
        raise NotImplementedError

    def update_mean(self, U, weights, normalizer):
        """New mean: the weighted average of the samples
        (weightedReductionKernel, mppi_common.cu:710-765)."""
        w = (weights / normalizer)[:, None, None]
        return torch.sum(w * U, dim=0)

    def shift(self, mean, stride):
        """Slide the mean forward by ``stride`` steps."""
        return slide_control_sequence(mean, stride)
