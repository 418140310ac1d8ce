"""Dynamics base class, in PyTorch.

Counterpart of ``mppi_generic_tpu/models/base.py``. A model is an
``nn.Module`` whose parameters are buffers; its methods are pure functions
of tensors. The step contract mirrors the reference (dynamics.cuh:283-291):

    step(x, u, t, dt) = state_deriv -> Euler update -> state_to_output

Batching convention (docs/design.md section 3): methods index only axis 0
of the state, control and output tensors and otherwise broadcast, so the
same code serves one vector (S,) and a structure-of-arrays batch (S, K).
The CUDA kernels carry the same step as ``__host__ __device__`` functions
in ``csrc/``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from mppi_generic_tpu_torch.utils import math_utils


class Dynamics(nn.Module):
    """Base dynamics model.

    Subclasses define ``STATE_DIM`` / ``CONTROL_DIM`` / ``OUTPUT_DIM`` and
    implement ``state_deriv``. The control constraints (ranges, deadband,
    zero control) are buffers here, as in dynamics.cuh:250-264.
    """

    STATE_DIM = 0
    CONTROL_DIM = 0
    OUTPUT_DIM = 0

    def __init__(self, control_ranges=None, control_deadband=None,
                 zero_control=None, device="cpu"):
        super().__init__()
        C = self.CONTROL_DIM
        if control_ranges is None:
            inf = float("inf")
            control_ranges = [[-inf, inf]] * C
        if control_deadband is None:
            control_deadband = [0.0] * C
        if zero_control is None:
            zero_control = [0.0] * C
        def f32(v, shape):
            return torch.tensor(np.asarray(v, np.float32), device=device).reshape(shape)

        self.register_buffer("control_ranges", f32(control_ranges, (C, 2)))
        self.register_buffer("control_deadband", f32(control_deadband, (C,)))
        self.register_buffer("zero_control", f32(zero_control, (C,)))

    # --- core contract ---------------------------------------------------
    def state_deriv(self, x, u, t=0.0):
        """Continuous-time dx/dt, component-indexed on axis 0."""
        raise NotImplementedError

    def update_state(self, x, xdot, dt):
        """Explicit Euler (dynamics.cuh:276-281)."""
        return x + xdot * dt

    def state_to_output(self, x):
        """Output = the first OUTPUT_DIM state components."""
        if self.OUTPUT_DIM == self.STATE_DIM:
            return x
        return x[: self.OUTPUT_DIM]

    def step(self, x, u, t, dt):
        """One discrete step: returns (x_next, output)."""
        xdot = self.state_deriv(x, u, t)
        x_next = self.update_state(x, xdot, dt)
        return x_next, self.state_to_output(x_next)

    def enforce_constraints(self, x, u):
        """Deadband snap-to-zero-control, deadband shrink, then clamp
        (dynamics.cuh:250-264). ``u`` is (C, ...)."""
        del x
        db = self._bcast(self.control_deadband, u)
        zc = self._bcast(self.zero_control, u)
        lo = self._bcast(self.control_ranges[:, 0], u)
        hi = self._bcast(self.control_ranges[:, 1], u)
        shrunk = u - db * math_utils.sign(u)
        u = torch.where(torch.abs(u) < db, zc, shrunk)
        return torch.clamp(u, lo, hi)

    @staticmethod
    def _bcast(param, like):
        """Broadcast a (C,) parameter against a control of shape (C, ...)."""
        return param.reshape(param.shape + (1,) * (like.dim() - 1))


def rollout_single(dynamics: Dynamics, x0, U, dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Roll one control sequence (T, C) from x0; returns (states (T+1, S),
    outputs (T, O)). The analog of computeStateTrajectoryHelper.

    The JAX version clamps each control inside its scan; the clamp does not
    depend on the state, so here it runs once over the whole sequence.
    """
    U = dynamics.enforce_constraints(None, U.T).T
    x = x0
    states, outputs = [x0], []
    for t in range(U.shape[0]):
        x, y = dynamics.step(x, U[t], float(t), dt)
        states.append(x)
        outputs.append(y)
    return torch.stack(states), torch.stack(outputs)
