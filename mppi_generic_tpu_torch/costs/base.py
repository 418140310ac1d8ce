"""Cost-function base class, in PyTorch.

Counterpart of ``mppi_generic_tpu/costs/base.py``. Costs are pure functions
of the dynamics output (not the state), component-indexed on axis 0 like the
models. The per-sample crash status is threaded explicitly as an int32
tensor.
"""

from __future__ import annotations

import torch
from torch import nn


class Cost(nn.Module):
    CONTROL_DIM = 0
    OUTPUT_DIM = 0

    def state_cost(self, y, t, crash):
        """Per-timestep state cost. Returns (cost, new_crash_status)."""
        raise NotImplementedError

    def control_cost(self, u, t, crash):
        """Zero (cost.cuh:128-131): the quadratic control cost is the
        sampler's likelihood-ratio term."""
        del t, crash
        return torch.zeros_like(u[0])

    def running_cost(self, y, u, t, crash):
        """State + control cost (cost.cuh:212-219). Returns (cost, crash)."""
        c_state, crash = self.state_cost(y, t, crash)
        return c_state + self.control_cost(u, t, crash), crash

    def terminal_cost(self, y):
        raise NotImplementedError

    def kernel_map(self):
        """The map the kernels' cost reads, or None for a cost without one.
        Called only on the CUDA path; raises for what the compiled kernels
        do not take."""
        return None
