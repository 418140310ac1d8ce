"""Eager rollout: the oracle every kernel of the port is held against.

Counterpart of ``mppi_generic_tpu/ops/rollout.py``, its two paths:

* ``rollout_combined``, the reference's rolloutKernel (mppi_common.cu:
  28-146): dynamics and running cost in one loop;
* ``rollout_outputs`` + ``trajectory_state_costs``, the split
  rolloutDynamicsKernel / rolloutCostKernel (mppi_common.cu:148-362): the
  dynamics-only loop gives the (K, T, O) outputs, then the cost pass runs
  over them, sequentially in t or, for an eligible cost, over all steps at
  once (the eager ``kernel="split"`` path of the controllers).

The horizon is a Python loop; the samples ride the minor axis of (S, K)
component blocks.

A recurrent model's LSTM state rides the loop beside the state, one (H,)
column per sample, from the model's ``init_recurrent_state``.

Cost convention (mppi_common.cu:98-145): the output stored at index t is the
output after stepping with u_t; the running cost at t is evaluated on it;
the total is (sum_t running + terminal(y_{T-1})) / T. Controls are already
clamped.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.costs.base import Cost
from mppi_generic_tpu_torch.models.base import Dynamics, broadcast_rec
from mppi_generic_tpu_torch.utils.math_utils import true_div


def rollout_combined(dynamics: Dynamics, cost: Cost, x0: torch.Tensor,
                     U: torch.Tensor, dt: float):
    """Rollout of every sample from one initial state x0 (S,). Returns
    (costs (K,), Y (K, T, O), crash (K,) int32); the caller adds the
    sampler's likelihood-ratio term."""
    K, T, _ = U.shape
    Uc = U.permute(2, 1, 0)  # (C, T, K): components on axis 0
    x = x0[:, None].expand(-1, K)
    rec = broadcast_rec(dynamics.init_recurrent_state(), K)
    crash = torch.zeros((K,), dtype=torch.int32, device=U.device)
    acc = torch.zeros((K,), dtype=torch.float32, device=U.device)
    ys = []
    for t in range(T):
        u = Uc[:, t]
        x, y, rec = dynamics.step_recurrent(x, rec, u, float(t), dt)
        c, crash = cost.running_cost(y, u, t, crash)
        acc = acc + c
        ys.append(y)
    total = true_div(acc + cost.terminal_cost(ys[-1]), T)
    return total, torch.stack(ys, dim=-1).permute(1, 2, 0), crash


def rollout_outputs(dynamics: Dynamics, x0: torch.Tensor, U: torch.Tensor,
                    dt: float) -> torch.Tensor:
    """Dynamics-only rollout (rolloutDynamicsKernel): the (K, T, O) outputs
    of every sample from x0 (S,) or one x0 per sample (K, S)."""
    K, T, _ = U.shape
    Uc = U.permute(2, 1, 0)  # (C, T, K)
    x = x0.T if x0.dim() == 2 else x0[:, None].expand(-1, K)
    rec = broadcast_rec(dynamics.init_recurrent_state(), K)
    ys = []
    for t in range(T):
        x, y, rec = dynamics.step_recurrent(x, rec, Uc[:, t], float(t), dt)
        ys.append(y)
    return torch.stack(ys, dim=-1).permute(1, 2, 0)


def trajectory_state_costs(cost: Cost, Y: torch.Tensor, U: torch.Tensor,
                           sequential_crash: bool = False,
                           batched_crash: bool = False):
    """Cost pass over precomputed outputs Y (K, T, O) (rolloutCostKernel):
    (costs (K,), crash (K,) int32), costs = (sum_t running + terminal) / T
    without the sampler's likelihood-ratio term.

    ``sequential_crash``: a loop over t carries the crash status. Without
    it the steps are evaluated all at once at crash 0 and the crash flags
    are 0 (fit for costs that declare ``time_parallel_cost``).
    ``batched_crash`` (with ``sequential_crash``, for a cost that declares
    ``time_parallel_crash`` and not ``time_parallel_cost``): all steps at
    once, at crash 0 and at crash 1, each step taking the crash-1 value
    where the inclusive running maximum of the triggers over t is set; the
    same crash flags as the loop (JAX ops/rollout.py:139-155)."""
    K, T, _ = Y.shape
    dev = Y.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    Yc, Uc = Y.permute(2, 0, 1), U.permute(2, 0, 1)  # (O, K, T), (C, K, T)
    ts = torch.arange(T, dtype=torch.float32, device=dev)
    terminal = cost.terminal_cost(Y[:, -1].T)
    if (sequential_crash and batched_crash and cost.time_parallel_crash()
            and not cost.time_parallel_cost()):
        c0, trig = cost.running_cost(Yc, Uc, ts, zero)
        c1, _ = cost.running_cost(Yc, Uc, ts, torch.ones_like(zero))
        flags = torch.cummax(trig.expand(K, T), dim=1).values
        cs = torch.where(flags > 0, c1.expand(K, T), c0.expand(K, T))
        return true_div(cs.sum(dim=1) + terminal, T), flags[:, -1]
    if sequential_crash:
        crash = torch.zeros((K,), dtype=torch.int32, device=dev)
        acc = torch.zeros((K,), dtype=torch.float32, device=dev)
        for t in range(T):
            c, crash = cost.running_cost(Yc[:, :, t], Uc[:, :, t], t, crash)
            acc = acc + c
        return true_div(acc + terminal, T), crash
    cs, _ = cost.running_cost(Yc, Uc, ts, zero)
    crash = torch.zeros((K,), dtype=torch.int32, device=dev)
    return true_div(cs.expand(K, T).sum(dim=1) + terminal, T), crash
