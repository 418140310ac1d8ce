"""AutoRally neural-network dynamics, in PyTorch.

Counterpart of ``mppi_generic_tpu/models/autorally.py`` (the reference's
NeuralNetModel<7, 2, 3>, ar_nn_model.cu): state [x, y, yaw, roll, u_x, u_y,
yaw_rate], control [steering, throttle]. The first three derivatives are
kinematics, the last four come from an FNN over [roll, u_x, u_y, yaw_rate,
steering, throttle]; the Euler update wraps the yaw to [-pi, pi).

The CUDA kernels carry the same step and derivative in
``csrc/autorally_nn.cuh``, compiled for the 6-32-32-4 network of the
reference's autorally_nnet; their plain versions run ``kernel_step`` and
``kernel_state_deriv`` (the DDP ladder's), which are ``step`` and
``state_deriv`` with the network summed in the kernels' order.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.models.base import Dynamics
from mppi_generic_tpu_torch.nn.fnn import FNN
from mppi_generic_tpu_torch.utils import math_utils

# the network the kernels are compiled for (csrc/autorally_nn.cuh)
KERNEL_LAYERS = (6, 32, 32, 4)


class AutorallyNNDynamics(Dynamics):
    STATE_DIM = 7
    CONTROL_DIM = 2
    OUTPUT_DIM = 7
    K_DIM = 3

    def __init__(self, nn: FNN, device="cpu", **constraints):
        super().__init__(device=device, **constraints)
        if nn.input_dim != self.STATE_DIM - self.K_DIM + self.CONTROL_DIM or (
                nn.output_dim != self.STATE_DIM - self.K_DIM):
            raise ValueError(f"AutoRally needs a 6-input, 4-output FNN, got {nn.layers}")
        self.nn = nn.to(device)

    @classmethod
    def create(cls, nn: FNN | None = None, seed=None, device="cpu", **constraints):
        """The default architecture of the autorally nnet (6-32-32-4), random
        from a numpy ``seed`` (zero without one) unless ``nn`` is given."""
        if nn is None:
            nn = FNN.create(KERNEL_LAYERS, seed=seed)
        return cls(nn, device=device, **constraints)

    @classmethod
    def from_npz(cls, npz, prefix: str = "", device="cpu", **constraints):
        """Load the FNN from the reference npz layout (dynamics_W{i}/b{i})."""
        return cls.create(nn=FNN.from_npz(npz, prefix), device=device, **constraints)

    def _deriv(self, x, u, forward):
        yaw = x[2]
        cos_y, sin_y = torch.cos(yaw), torch.sin(yaw)
        x_d = cos_y * x[4] - sin_y * x[5]
        y_d = sin_y * x[4] + cos_y * x[5]
        yaw_d = -x[6]
        feats = torch.stack([x[3], x[4], x[5], x[6], u[0], u[1]])
        return torch.cat([torch.stack([x_d, y_d, yaw_d]), forward(feats)], dim=0)

    def state_deriv(self, x, u, t=0.0):
        return self._deriv(x, u, self.nn.forward_axis0)

    def update_state(self, x, xdot, dt):
        x_next = x + xdot * dt
        wrapped = math_utils.normalize_angle(x_next[2])
        return torch.cat([x_next[:2], wrapped[None], x_next[3:]], dim=0)

    def kernel_state_deriv(self, x, u, t=0.0):
        return self._deriv(x, u, self.nn.forward_axis0_plain)

    def kernel_step(self, x, u, t, dt):
        x_next = self.update_state(x, self.kernel_state_deriv(x, u, t), dt)
        return x_next, self.state_to_output(x_next)

    def kernel_params(self):
        if self.nn.layers != KERNEL_LAYERS:
            raise NotImplementedError(
                f"the CUDA kernels are compiled for the {KERNEL_LAYERS} AutoRally "
                f"network, not {self.nn.layers}")
        return self.nn.packed
