"""Quadrotor dynamics (13 states, quaternion attitude), in PyTorch.

Counterpart of ``QuadrotorDynamics`` in
``mppi_generic_tpu/models/quadrotor.py`` (reference quadrotor_dynamics.cu
computeDynamics :70-115, updateState :117-125):

* state [x y z, vx vy vz, qw qx qy qz, wx wy wz], control [ang_rate_x,
  ang_rate_y, ang_rate_z, thrust], output = state;
* x_d = v; v_d = (thrust / m) R(q) e_z - g e_z; q_d = 0.5 q (x) [0, w];
  w_d = (u_pqr - w) / tau (first-order rate tracking);
* the Euler update, then the quaternion divided by norm * sign(q_w), the
  norm summed as ((qw^2 + qx^2) + qy^2) + qz^2 (the kernels' order).

The mass and the three time constants are the 0-dim entries of the packed
``params`` buffer (mass, tau_roll, tau_pitch, tau_yaw), so ``/ tau_roll``
is a tensor division on every device, as in the kernels. The CUDA kernels
carry the same step in ``csrc/quadrotor.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.models.base import Dynamics
from mppi_generic_tpu_torch.utils import math_utils

GRAVITY = 9.81
PARAM_NAMES = ("mass", "tau_roll", "tau_pitch", "tau_yaw")
STATE_KEYS = ("POS_X", "POS_Y", "POS_Z", "VEL_X", "VEL_Y", "VEL_Z", "QUAT_W", "QUAT_X",
              "QUAT_Y", "QUAT_Z", "ANG_VEL_X", "ANG_VEL_Y", "ANG_VEL_Z")


class QuadrotorDynamics(Dynamics):
    STATE_DIM = 13
    CONTROL_DIM = 4
    OUTPUT_DIM = 13

    def __init__(self, mass=1.0, tau_roll=0.25, tau_pitch=0.25, tau_yaw=0.25,
                 device="cpu", **constraints):
        super().__init__(device=device, **constraints)
        self.register_buffer("params", torch.tensor(
            np.asarray([mass, tau_roll, tau_pitch, tau_yaw], np.float32), device=device))

    @classmethod
    def create(cls, mass=1.0, tau_roll=0.25, tau_pitch=0.25, tau_yaw=0.25,
               device="cpu", **constraints):
        return cls(mass, tau_roll, tau_pitch, tau_yaw, device=device, **constraints)

    def __getattr__(self, name):
        if name in PARAM_NAMES:
            return self.params[PARAM_NAMES.index(name)]
        return super().__getattr__(name)

    def state_deriv(self, x, u, t=0.0):
        qw, qx, qy, qz = x[6], x[7], x[8], x[9]
        w0, w1, w2 = x[10], x[11], x[12]
        # third column of the body-to-world DCM (Quat2DCM)
        r02 = 2 * (qx * qz + qw * qy)
        r12 = 2 * (qy * qz - qw * qx)
        r22 = 1 - 2 * (qx * qx + qy * qy)
        a = u[3] / self.mass
        # quaternion kinematics 0.5 q (x) [0, w] (omega2edot)
        qd_w = 0.5 * (-qx * w0 - qy * w1 - qz * w2)
        qd_x = 0.5 * (qw * w0 - qz * w1 + qy * w2)
        qd_y = 0.5 * (qz * w0 + qw * w1 - qx * w2)
        qd_z = 0.5 * (-qy * w0 + qx * w1 + qw * w2)
        return torch.stack([
            x[3], x[4], x[5], a * r02, a * r12, a * r22 - GRAVITY,
            qd_w, qd_x, qd_y, qd_z,
            (u[0] - w0) / self.tau_roll, (u[1] - w1) / self.tau_pitch,
            (u[2] - w2) / self.tau_yaw])

    def update_state(self, x, xdot, dt):
        x_next = x + xdot * dt
        q = x_next[6:10]
        norm = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
        q = q / (norm * math_utils.sign(x_next[6]))
        return torch.cat([x_next[:6], q, x_next[10:]], dim=0)

    def get_zero_state(self):
        x = torch.zeros((13,), dtype=torch.float32, device=self.params.device)
        x[6] = 1.0
        return x

    def kernel_params(self):
        """The (mass, tau_roll, tau_pitch, tau_yaw) table csrc/quadrotor.cuh
        stages."""
        return self.params

    def state_from_map(self, mapping):
        return torch.tensor([mapping[k] for k in STATE_KEYS], dtype=torch.float32,
                            device=self.params.device)
