"""Pluggable weight-shaping functions, in PyTorch.

Counterpart of ``mppi_generic_tpu/shaping/__init__.py`` (the reference's
``shaping_functions/`` layer, shaping_function.cuh:9-74): each shaping
function maps per-sample costs to weights with
``compute_weights(costs, baseline=None)``; without a baseline it takes the
minimum cost. A controller given one (``VanillaMPPI(shaping_function=...)``)
uses it in place of its ``weight_transform``. The parameters are host floats
rounded to float32, as the JAX package holds them.
"""

from __future__ import annotations

import numpy as np

from mppi_generic_tpu_torch.ops import weights as weight_ops


def _f32(v) -> float:
    return float(np.float32(v))


class ShapingFunction:
    """Exponentiated-utility weights exp(-(J - baseline) / lambda)
    (normExpTransform, core/mppi_common.cu:686-708)."""

    def __init__(self, lam=1.0):
        self.lam = _f32(lam)

    def compute_weights(self, costs, baseline=None):
        if baseline is None:
            baseline = weight_ops.baseline_cost(costs)
        return weight_ops.norm_exp_weights(costs, self.lam, baseline)


NormExpShapingFunction = ShapingFunction


class TsallisShapingFunction:
    """Tsallis-divergence weights (1 - dJ / gamma)_+^(1 / (r - 1))
    (TsallisTransform, mppi_common.cu:958-985)."""

    def __init__(self, gamma=10.0, r=2.0):
        self.gamma = _f32(gamma)
        self.r = _f32(r)

    def compute_weights(self, costs, baseline=None):
        if baseline is None:
            baseline = weight_ops.baseline_cost(costs)
        return weight_ops.tsallis_weights(costs, self.gamma, self.r, baseline)


class CEMShapingFunction:
    """Cross-entropy-method elite weights: 1 for the elite fraction of
    samples, 0 otherwise (CEM/cem_shaping_function.cuh:8-41)."""

    def __init__(self, elite_fraction=0.1):
        self.elite_fraction = _f32(elite_fraction)

    def compute_weights(self, costs, baseline=None):
        del baseline
        return weight_ops.cem_weights(costs, self.elite_fraction)


__all__ = [
    "ShapingFunction",
    "NormExpShapingFunction",
    "TsallisShapingFunction",
    "CEMShapingFunction",
]
