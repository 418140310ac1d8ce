"""Eager rollout: the oracle every kernel of the port is held against.

Counterpart of ``rollout_combined`` in ``mppi_generic_tpu/ops/rollout.py``
(the reference's rolloutKernel, mppi_common.cu:28-146). The horizon is a
Python loop; the samples ride the minor axis of (S, K) component blocks.

Cost convention (mppi_common.cu:98-145): the output stored at index t is the
output after stepping with u_t; the running cost at t is evaluated on it;
the total is (sum_t running + terminal(y_{T-1})) / T. Controls are already
clamped.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.costs.base import Cost
from mppi_generic_tpu_torch.models.base import Dynamics
from mppi_generic_tpu_torch.utils.math_utils import true_div


def rollout_combined(dynamics: Dynamics, cost: Cost, x0: torch.Tensor,
                     U: torch.Tensor, dt: float):
    """Rollout of every sample from one initial state x0 (S,). Returns
    (costs (K,), Y (K, T, O), crash (K,) int32); the caller adds the
    sampler's likelihood-ratio term."""
    K, T, _ = U.shape
    Uc = U.permute(2, 1, 0)  # (C, T, K): components on axis 0
    x = x0[:, None].expand(-1, K)
    crash = torch.zeros((K,), dtype=torch.int32, device=U.device)
    acc = torch.zeros((K,), dtype=torch.float32, device=U.device)
    ys = []
    for t in range(T):
        u = Uc[:, t]
        x, y = dynamics.step(x, u, float(t), dt)
        c, crash = cost.running_cost(y, u, t, crash)
        acc = acc + c
        ys.append(y)
    total = true_div(acc + cost.terminal_cost(ys[-1]), T)
    return total, torch.stack(ys, dim=-1).permute(1, 2, 0), crash
