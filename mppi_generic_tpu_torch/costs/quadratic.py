"""Quadratic cost to a goal state or a goal trajectory, in PyTorch.

Counterpart of ``QuadraticCost`` in ``mppi_generic_tpu/costs/quadratic.py``
(reference quadratic_cost.cuh): sum_i coeffs_i (y_i - goal_i)^2 over the O
outputs, summed left to right. ``goal`` is (O,) for a fixed goal or
(H_goal, O) for a goal trajectory, whose row at step t is
goal[clip(current_time + t, 0, H_goal - 1)] (getIndex, quadratic_cost.cuh:
49-58). The terminal cost is ``terminal_scale`` times the state cost at the
last goal row (the fixed goal at t = 0).

The CUDA kernels carry the same cost in ``csrc/quadratic_cost.cuh``
(templated on O). They read the packed ``params`` buffer: coeffs (O), the
fixed goal (O; zeros for a trajectory), terminal_scale, then int32 words
[H_goal (0 for a fixed goal), current_time]; a goal trajectory rides apart
as the cost's map (``kernel_map``).
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.costs.base import Cost


class QuadraticCost(Cost):
    def __init__(self, goal, coeffs=None, output_dim=None, terminal_scale=0.0,
                 current_time=0, device="cpu"):
        super().__init__()
        goal = np.asarray(goal, np.float32)
        if goal.ndim not in (1, 2):
            raise ValueError(f"goal must be (O,) or (H_goal, O), got {goal.shape}")
        O = goal.shape[-1] if output_dim is None else int(output_dim)
        self.OUTPUT_DIM = O
        self.current_time = int(current_time)
        coeffs = np.ones((O,), np.float32) if coeffs is None else np.asarray(coeffs, np.float32)
        self.register_buffer("goal", torch.tensor(goal, device=device))
        words = np.array([goal.shape[0] if goal.ndim == 2 else 0, int(current_time)],
                         np.int32)
        fixed = goal[:O] if goal.ndim == 1 else np.zeros((O,), np.float32)
        table = np.concatenate([coeffs.reshape(O), fixed,
                                np.asarray([terminal_scale], np.float32),
                                words.view(np.float32)])
        self.register_buffer("params", torch.tensor(table, device=device))

    @classmethod
    def create(cls, goal, coeffs=None, output_dim=None, terminal_scale=0.0,
               device="cpu"):
        return cls(goal, coeffs, output_dim, terminal_scale, device=device)

    @property
    def coeffs(self):
        return self.params[:self.OUTPUT_DIM]

    @property
    def terminal_scale(self):
        return self.params[2 * self.OUTPUT_DIM]

    def time_parallel_cost(self) -> bool:
        # a goal trajectory is gathered by t; the fixed goal is elementwise
        return self.goal.dim() == 1

    def _goal_at(self, t):
        if self.goal.dim() == 1:
            return self.goal
        H = self.goal.shape[0]
        return self.goal[min(max(self.current_time + int(t), 0), H - 1)]

    def state_cost(self, y, t, crash):
        g, c = self._goal_at(t), self.coeffs
        terms = []
        for i in range(self.OUTPUT_DIM):
            err = y[i] - g[i]
            terms.append(c[i] * (err * err))
        return sum(terms[1:], terms[0]), crash

    def terminal_cost(self, y):
        t = self.goal.shape[0] - 1 if self.goal.dim() == 2 else 0
        c, _ = self.state_cost(y, t, 0)
        return self.terminal_scale * c

    def kernel_map(self):
        """The (H_goal, O) goal trajectory the kernels gather from, or None
        for a fixed goal (which rides in ``params``)."""
        return None if self.goal.dim() == 1 else self.goal
