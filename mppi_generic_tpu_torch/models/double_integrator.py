"""Planar double-integrator dynamics, in PyTorch.

Counterpart of ``mppi_generic_tpu/models/double_integrator.py``: state
[pos_x, pos_y, vel_x, vel_y], control [accel_x, accel_y]
(di_dynamics.cu:14-22). The CUDA kernels carry the same step in
``csrc/double_integrator.cuh``.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.models.base import Dynamics


class DoubleIntegratorDynamics(Dynamics):
    STATE_DIM = 4
    CONTROL_DIM = 2
    OUTPUT_DIM = 4

    def __init__(self, system_noise: float = 1.0, device="cpu", **constraints):
        super().__init__(device=device, **constraints)
        self.register_buffer(
            "system_noise",
            torch.tensor(system_noise, dtype=torch.float32, device=device))

    @classmethod
    def create(cls, system_noise: float = 1.0, device="cpu", **constraints):
        return cls(system_noise=system_noise, device=device, **constraints)

    def state_deriv(self, x, u, t=0.0):
        return torch.stack([x[2], x[3], u[0], u[1]])
