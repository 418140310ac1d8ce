"""Double-integrator annulus-tracking cost, in PyTorch.

Counterpart of ``DoubleIntegratorCircleCost`` in
``mppi_generic_tpu/costs/double_integrator.py``
(double_integrator_circle_cost.cu): a crash penalty discount^t * crash_cost
outside the [inner, outer] radius annulus, plus |speed - v_des| and
|angular momentum - L_des| tracking terms, and zero terminal cost. The CUDA
kernels carry the same cost in ``csrc/double_integrator_circle_cost.cuh``,
which reads the parameters in the order of ``PARAM_NAMES``.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.costs.base import Cost
from mppi_generic_tpu_torch.utils import math_utils


class DoubleIntegratorCircleCost(Cost):
    CONTROL_DIM = 2
    OUTPUT_DIM = 4

    # order of the packed ``params`` buffer the kernels read
    PARAM_NAMES = (
        "velocity_cost",
        "crash_cost",
        "velocity_desired",
        "inner_path_radius2",
        "outer_path_radius2",
        "angular_momentum_desired",
        "discount",
    )

    def __init__(self, velocity_cost=1.0, crash_cost=1000.0,
                 velocity_desired=2.0, inner_path_radius2=1.875**2,
                 outer_path_radius2=2.125**2, angular_momentum_desired=4.0,
                 discount=1.0, device="cpu"):
        super().__init__()
        values = [velocity_cost, crash_cost, velocity_desired,
                  inner_path_radius2, outer_path_radius2,
                  angular_momentum_desired, discount]
        self.register_buffer(
            "params", torch.tensor([float(v) for v in values],
                                   dtype=torch.float32, device=device))

    def __getattr__(self, name):
        if name in DoubleIntegratorCircleCost.PARAM_NAMES:
            return self.params[DoubleIntegratorCircleCost.PARAM_NAMES.index(name)]
        return super().__getattr__(name)

    def state_cost(self, y, t, crash):
        radial2 = y[0] * y[0] + y[1] * y[1]
        speed = torch.sqrt(y[2] * y[2] + y[3] * y[3])
        ang_mom = y[0] * y[3] - y[1] * y[2]
        out_of_track = (radial2 < self.inner_path_radius2) | (
            radial2 > self.outer_path_radius2
        )
        cost = torch.where(
            out_of_track,
            math_utils.discount_pow(self.discount, t) * self.crash_cost,
            0.0,
        )
        cost = cost + self.velocity_cost * torch.abs(speed - self.velocity_desired)
        cost = cost + self.velocity_cost * torch.abs(
            ang_mom - self.angular_momentum_desired
        )
        return cost, crash

    def terminal_cost(self, y):
        return torch.zeros_like(y[0])
