"""Weight transforms and free-energy statistics, in PyTorch.

Counterpart of ``mppi_generic_tpu/ops/weights.py`` (core/mppi_common.cu
normExp, Tsallis and computeFreeEnergy; the CEM shaping function). Every
result stays a tensor on the device: nothing here waits for the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mppi_generic_tpu_torch.utils.math_utils import true_div


def baseline_cost(costs):
    """min over samples (computeBaselineCost, mppi_common.cu:858-862)."""
    return torch.amin(costs, dim=-1)


def norm_exp_weights(costs, lam, baseline):
    """w_i = exp(-(J_i - baseline) / lambda) (mppi_common.cu:958-967);
    ``lam`` a host number, divided by as a device scalar (``true_div``)."""
    return torch.exp(true_div(-(costs - baseline), lam))


def tsallis_weights(costs, gamma, r, baseline):
    """Tsallis-divergence weights (TsallisTransform, mppi_common.cu:969-985):
    w_i = (1 - dJ / gamma)^(1 / (r - 1)) for dJ = J_i - baseline < gamma,
    else 0. ``gamma`` and ``r`` are host floats. Both divisions divide by
    a device scalar: on CUDA, PyTorch divides by a host scalar as a
    multiply by its reciprocal, which can differ in the last bit from the
    kernels' division."""
    dj = costs - baseline
    inside = dj < gamma
    base = torch.clamp(1.0 - true_div(dj, gamma), min=1e-30)
    r_minus_1 = float(np.float32(r) - np.float32(1.0))
    w = torch.exp(true_div(torch.log(base), r_minus_1))
    return torch.where(inside, w, 0.0)


def cem_weights(costs, elite_fraction):
    """Cross-entropy-method elite weights (cem_shaping_function.cuh:8-41):
    1 for the max(floor(fraction * K), 1) lowest costs, ties at the
    threshold included, else 0. ``elite_fraction`` is a host float."""
    K = costs.shape[-1]
    n_elite = max(int(np.floor(np.float32(elite_fraction) * np.float32(K))), 1)
    thresh = torch.kthvalue(costs, n_elite, dim=-1).values
    return (costs <= thresh[..., None]).to(costs.dtype)


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
