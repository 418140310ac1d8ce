"""Risk measures over per-sample cost arrays, in PyTorch.

Counterpart of ``mppi_generic_tpu/utils/risk.py`` (the reference's
``utils/risk_utils.cuh``: CVaR, VaR, max, min, mean and median reductions for
risk-aware cost shaping). Quantiles interpolate linearly, as ``jnp.quantile``
does. The median is the 0.5 quantile: ``torch.median`` returns the lower of
the two middle values of an even count, where ``jnp.median`` averages them.
"""

from __future__ import annotations

import torch


def var(costs, alpha, axis=-1):
    """Value-at-risk: the alpha-quantile of the cost distribution."""
    return torch.quantile(costs, float(alpha), dim=axis)


def cvar(costs, alpha, axis=-1):
    """Conditional value-at-risk: the mean of the costs at or above the
    alpha-quantile (risk_utils.cuh:5-40)."""
    v = var(costs, alpha, axis=axis).unsqueeze(axis)
    weight = (costs >= v).to(costs.dtype)
    denom = torch.clamp(torch.sum(weight, dim=axis), min=1.0)
    return torch.sum(costs * weight, dim=axis) / denom


def risk_measure(costs, kind: str = "mean", alpha: float = 0.9, axis=-1):
    """The reference's RiskMeasure: mean, median, min, max, var or cvar."""
    kind = kind.lower()
    if kind == "mean":
        return torch.mean(costs, dim=axis)
    if kind == "median":
        return torch.quantile(costs, 0.5, dim=axis)
    if kind == "min":
        return torch.amin(costs, dim=axis)
    if kind == "max":
        return torch.amax(costs, dim=axis)
    if kind == "var":
        return var(costs, alpha, axis=axis)
    if kind == "cvar":
        return cvar(costs, alpha, axis=axis)
    raise ValueError(f"unknown risk measure: {kind}")
