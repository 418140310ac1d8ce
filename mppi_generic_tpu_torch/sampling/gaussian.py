"""Gaussian sampling distribution, in PyTorch.

Counterpart of ``mppi_generic_tpu/sampling/gaussian.py``, with the same
semantics (gaussian.cu setGaussianControls:17-130):

* sample k=0, and every sample at t < optimization_stride, is the pure mean;
* the last ``pure_noise_percentage`` fraction of samples is zero-mean
  sigma * eps;
* everything else is mean + sigma * eps;
* sigma is scaled by ``std_dev_decay ** iteration``;
* likelihood-ratio cost 0.5 * lambda * (1 - alpha) *
  sum_i c_i mu_i (mu_i - 2 u_i) / sigma_i^2, with mu = 0 for pure-noise
  samples (gaussian.cu:481-568).

Noise comes from an explicit ``torch.Generator``; its stream differs from
``jax.random`` by design, so tests hand both packages the same noise
through ``injected_noise``.
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.sampling.base import SamplingDistribution


class GaussianDistribution(SamplingDistribution):
    def __init__(self, std_dev, control_cost_coeff=None,
                 pure_noise_percentage: float = 0.0, std_dev_decay: float = 1.0,
                 device="cpu"):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        std_dev = torch.tensor(np.asarray(std_dev, np.float32), **f32)
        self.time_specific_std_dev = std_dev.dim() == 2
        self.CONTROL_DIM = C = std_dev.shape[-1]
        if control_cost_coeff is None:
            control_cost_coeff = np.ones((C,), np.float32)
        self.register_buffer("std_dev", std_dev)
        self.register_buffer(
            "control_cost_coeff",
            torch.tensor(np.asarray(control_cost_coeff, np.float32), **f32))
        # host scalars: they size the pure-noise carve-out and the decay,
        # and reading them must not wait on the device
        self.pure_noise_percentage = float(np.float32(pure_noise_percentage))
        self.std_dev_decay = float(np.float32(std_dev_decay))

    @classmethod
    def create(cls, std_dev, control_cost_coeff=None,
               pure_noise_percentage: float = 0.0, std_dev_decay: float = 1.0,
               device="cpu"):
        return cls(std_dev, control_cost_coeff, pure_noise_percentage,
                   std_dev_decay, device=device)

    # ------------------------------------------------------------------
    def _sigma(self, T, iteration):
        """(T, C) sigma of optimization iteration ``iteration``."""
        sigma = self.std_dev
        if not self.time_specific_std_dev:
            sigma = sigma[None, :].expand(T, sigma.shape[-1])
        decay = float(np.power(np.float32(self.std_dev_decay),
                               np.float32(iteration)))
        return sigma * decay

    def pure_threshold(self, num_rollouts) -> float:
        """(1 - p) * K in float32, as the JAX package computes it: samples
        whose index reaches it form the pure-noise tail."""
        return float((np.float32(1.0) - np.float32(self.pure_noise_percentage))
                     * np.float32(num_rollouts))

    def _pure_noise_mask(self, num_rollouts):
        """(K,) bool: True for the trailing pure-noise carve-out samples."""
        k = torch.arange(num_rollouts, dtype=torch.float32,
                         device=self.std_dev.device)
        return k >= self.pure_threshold(num_rollouts)

    def sample(self, generator, mean, num_rollouts, *, iteration=0,
               optimization_stride=0, injected_noise=None):
        """(K, T, C) samples. ``injected_noise`` replaces the standard
        normals drawn from ``generator`` (the test hook the JAX kernels
        also have)."""
        T, C = mean.shape
        if injected_noise is None:
            eps = torch.randn((num_rollouts, T, C), generator=generator,
                              dtype=mean.dtype, device=mean.device)
        else:
            eps = injected_noise
        return self._apply_carveouts(eps, mean, num_rollouts, iteration,
                                     optimization_stride)

    def _apply_carveouts(self, eps, mean, num_rollouts, iteration,
                         optimization_stride):
        """setGaussianControls semantics (gaussian.cu:101-121)."""
        K = num_rollouts
        T, C = mean.shape
        noise = self._sigma(T, iteration)[None] * eps
        pure = self._pure_noise_mask(K)[:, None, None]
        U = torch.where(pure, noise, mean[None] + noise)
        k_idx = torch.arange(K, device=mean.device)[:, None, None]
        t_idx = torch.arange(T, device=mean.device)[None, :, None]
        mean_mask = (k_idx == 0) | (t_idx < optimization_stride)
        return torch.where(mean_mask, mean[None], U)

    def likelihood_ratio_cost(self, U, mean, lam, alpha, iteration=0):
        K, T, C = U.shape
        sigma = self._sigma(T, iteration)[None]
        mu = mean[None].expand(U.shape)
        mu = torch.where(self._pure_noise_mask(K)[:, None, None], 0.0, mu)
        coeff = self.control_cost_coeff[None, None, :]
        per_elem = coeff * mu * (mu - 2.0 * U) / (sigma * sigma)
        return 0.5 * lam * (1.0 - alpha) * torch.sum(per_elem, dim=(1, 2))
