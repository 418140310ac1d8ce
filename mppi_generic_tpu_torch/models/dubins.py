"""Dubins (unicycle) dynamics, in PyTorch.

Counterpart of ``DubinsDynamics`` in ``mppi_generic_tpu/models/dubins.py``
(reference dubins.cu:8-33): state [pos_x, pos_y, yaw], control [vel,
yaw_rate], output = state; the Euler update wraps the yaw to [-pi, pi)
with ``normalize_angle``. The CUDA kernels carry the same step in
``csrc/dubins.cuh``.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.models.base import Dynamics
from mppi_generic_tpu_torch.utils import math_utils


class DubinsDynamics(Dynamics):
    STATE_DIM = 3
    CONTROL_DIM = 2
    OUTPUT_DIM = 3

    @classmethod
    def create(cls, device="cpu", **constraints):
        return cls(device=device, **constraints)

    def state_deriv(self, x, u, t=0.0):
        yaw = x[2]
        return torch.stack([u[0] * torch.cos(yaw), u[0] * torch.sin(yaw), u[1]])

    def update_state(self, x, xdot, dt):
        x_next = x + xdot * dt
        wrapped = math_utils.normalize_angle(x_next[2])
        return torch.stack([x_next[0], x_next[1], wrapped])

    def interpolate_state(self, x1, x2, alpha):
        out = (1 - alpha) * x1 + alpha * x2
        return torch.cat([out[:2], math_utils.interp_angle(x1[2], x2[2], alpha)[None]])

    def state_from_map(self, mapping):
        return torch.tensor([mapping[k] for k in ("POS_X", "POS_Y", "YAW")],
                            dtype=torch.float32, device=self.zero_control.device)
