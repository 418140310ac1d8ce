"""Cost-function base class, in PyTorch.

Counterpart of ``mppi_generic_tpu/costs/base.py``. Costs are pure functions
of the dynamics output (not the state), component-indexed on axis 0 like the
models. The per-sample crash status is threaded explicitly as an int32
tensor.

Two declarations make a cost eligible for the split form (a dynamics-only
pass, then a cost pass over all (sample, step) pairs at once: the eager
``ops/rollout.trajectory_state_costs`` and the kernels of
``csrc/split_kernels.cuh``): ``time_parallel_cost`` and
``time_parallel_crash``. Each is a correctness statement about the cost,
False by default, as in the JAX package.
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

    def time_parallel_cost(self) -> bool:
        """True when the running cost neither reads nor sets the crash
        status and evaluates with an extra leading time axis on every
        component block and a broadcastable float ``t`` (the eligibility of
        the reference's split rolloutCostKernel, mppi_common.cu:148-267)."""
        return False

    def time_parallel_crash(self) -> bool:
        """True when the crash status is sticky-prefix: the crash output is
        crash_in | trigger(y, t), the trigger independent of crash_in, and
        the value depends on the status only through the current flag; so
        evaluating at crash 0 and 1 and selecting per step by the inclusive
        prefix OR of the triggers reproduces the sequential result. Time
        broadcasting as in ``time_parallel_cost``."""
        return False

    def kernel_map(self):
        """The map the kernels' cost reads, or None for a cost without one.
        Called only on the CUDA path; raises for what the compiled kernels
        do not take."""
        return None
