"""NLN (normal x log-normal) sampling distribution, log-MPPI, in PyTorch.

Counterpart of ``mppi_generic_tpu/sampling/nln.py`` (reference
``sampling_distributions/nln/nln.{cuh,cu}``): per sample, step and channel
eps = z * exp(std_dev_c * z2) with z, z2 standard normals (createNLNNoise,
nln.cu:12-24), then the Gaussian carve-outs with mean + sigma * eps. The
lognormal scale is the RAW std-dev; only sigma decays with the iteration.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution


class NLNDistribution(GaussianDistribution):
    def _draw_noise(self, generator, mean, num_rollouts, normals=None,
                    optimization_stride=0):
        """eps = z * exp(std_dev * z2) from the given standard ``normals``
        (2, K, T, C) = (z, z2), or from two draws of ``generator``."""
        if normals is None:
            T, C = mean.shape
            normals = torch.randn((2, num_rollouts, T, C), generator=generator,
                                  dtype=mean.dtype, device=mean.device)
        return normals[0] * torch.exp(self.std_dev * normals[1])
