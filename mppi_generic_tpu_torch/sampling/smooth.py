"""Smooth-MPPI sampling distribution (derivative-space exploration), in
PyTorch.

Counterpart of ``mppi_generic_tpu/sampling/smooth.py`` (reference
``sampling_distributions/smooth-MPPI/smooth-MPPI.{cuh,cu}``):

* the distribution keeps an action-derivative mean sequence w (T, C), its
  ``state``, beside the control mean;
* W_k = w + sigma * eps with the Gaussian carve-outs (sigma in derivative
  units), and u_k[t] = u_mean[t] + W_k[t] * dt_smooth (integrateNoise,
  smooth-MPPI.cu:16-32);
* the mean update weights the derivative samples, w <- sum_k (omega_k /
  eta) W_k, then u_mean <- u_mean + w * dt_smooth
  (smooth-MPPI.cu:203-236);
* sliding the sequence slides the derivative mean too.
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution
from mppi_generic_tpu_torch.utils.math_utils import slide_control_sequence


class SmoothMPPIDistribution(GaussianDistribution):
    def __init__(self, std_dev, num_timesteps, dt=0.015, control_cost_coeff=None,
                 pure_noise_percentage: float = 0.0, std_dev_decay: float = 1.0,
                 device="cpu"):
        super().__init__(std_dev, control_cost_coeff, pure_noise_percentage,
                         std_dev_decay, device=device)
        # host scalars: the derivative-integration step (SmoothMPPIParams::dt)
        # and the horizon of the derivative mean
        self.dt_smooth = float(np.float32(dt))
        self.num_timesteps = int(num_timesteps)

    @classmethod
    def create(cls, std_dev, num_timesteps, dt=0.015, **kw):
        return cls(std_dev, num_timesteps, dt, **kw)

    def init_state(self):
        """The derivative mean, zero."""
        return torch.zeros((self.num_timesteps, self.CONTROL_DIM),
                           dtype=torch.float32, device=self.std_dev.device)

    def sample(self, generator, mean, num_rollouts, *, iteration=0,
               optimization_stride=0, state=None, injected_noise=None):
        """(U, W): the control samples and the derivative samples W around
        the derivative mean ``state``."""
        if state is None:
            raise ValueError("Smooth-MPPI samples around its derivative mean: "
                             "pass state (init_state() to start)")
        eps = self._draw_noise(generator, state, num_rollouts, injected_noise)
        W = self._apply_carveouts(eps, state, num_rollouts, iteration,
                                  optimization_stride)
        return mean[None] + W * self.dt_smooth, W

    def update_mean(self, U, aux, weights, normalizer, mean, state=None):
        W = aux
        w_norm = (weights / normalizer)[:, None, None]
        new_deriv_mean = torch.sum(w_norm * W, dim=0)
        return mean + new_deriv_mean * self.dt_smooth, new_deriv_mean

    def shift(self, mean, stride, slide_scale=None, state=None):
        return (slide_control_sequence(mean, stride, slide_scale),
                slide_control_sequence(state, stride, slide_scale))
