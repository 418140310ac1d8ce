"""normExp weights and free-energy statistics, in PyTorch.

Counterpart of ``mppi_generic_tpu/ops/weights.py`` (core/mppi_common.cu
normExp and computeFreeEnergy). Every result stays a tensor on the device:
nothing here waits for the device.
"""

from __future__ import annotations

import dataclasses

import torch


def baseline_cost(costs):
    """min over samples (computeBaselineCost, mppi_common.cu:858-862)."""
    return torch.amin(costs, dim=-1)


def norm_exp_weights(costs, lam, baseline):
    """w_i = exp(-(J_i - baseline) / lambda) (mppi_common.cu:958-967)."""
    return torch.exp(-(costs - baseline) / lam)


def normalizer(weights):
    """eta = sum_i w_i."""
    return torch.sum(weights, dim=-1)


@dataclasses.dataclass
class FreeEnergyStats:
    """MPPIFreeEnergyStatistics (controller.cuh:22-38) for one system."""

    free_energy_mean: torch.Tensor
    free_energy_variance: torch.Tensor
    free_energy_modified_variance: torch.Tensor
    baseline: torch.Tensor
    normalizer_percent: torch.Tensor
    previous_baseline: torch.Tensor
    increase: torch.Tensor


def compute_free_energy(weights, baseline, lam):
    """computeFreeEnergy (mppi_common.cu:1065-1081) over the transformed
    weights: F = -lambda * log(mean(w)) + baseline, plus variance terms."""
    K = weights.shape[-1]
    norm = torch.mean(weights, dim=-1)
    var = torch.mean(weights * weights, dim=-1)
    fe_mean = -lam * torch.log(norm) + baseline
    fe_var = lam * (var - norm * norm)
    weird = fe_var / (norm * (1.0 * K) ** 0.5)
    fe_mod = lam * (weird + 0.5 * weird * weird)
    return fe_mean, fe_var, fe_mod
