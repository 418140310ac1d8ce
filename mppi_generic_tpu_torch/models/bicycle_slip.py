"""Bicycle-slip parametric dynamics (a dynamic bicycle model with tire slip),
in PyTorch.

Counterpart of ``BicycleSlipDynamics`` in
``mppi_generic_tpu/models/bicycle_slip.py`` (reference
``dynamics/bicycle_slip/bicycle_slip_parametric.{cuh,cu}``), operation for
operation:

* state [pos_x, pos_y, yaw, steer_angle, brake_state, vel_x, vel_y, omega_z,
  roll, pitch], control [throttle_brake, steer_cmd], output = state;
* brake and steering actuators: first-order lags with rate clamps;
* longitudinal force: the throttle, minus c_brake tanh(v_x) brake, minus the
  tanh rolling drag; lateral force: tanh(v_x omega_z) coupling minus the tanh
  sliding drag;
* omega_z tracks the kinematic yaw rate v_x / wheel_base tan(steer / scale)
  with a velocity-dependent drag; body-frame velocity kinematics;
* the Euler update wraps the yaw (``normalize_angle``) and clamps the steer
  angle and the brake state.

The CUDA kernels carry the same step in ``csrc/bicycle_slip.cuh``; they read
the packed ``params`` table, which ends with the brake limit
-control_ranges[0, 0]. The elevation-coupled variant
(``BicycleSlipParametricElevation``) is not ported yet.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.models.base import PackedParamsDynamics
from mppi_generic_tpu_torch.utils import math_utils

# (name, default): the JAX package's fields in the order of the kernels'
# table; the pairs are [scale, rate] of a tanh term
PARAMS = (
    ("mass", 20.0),
    ("wheel_base", 0.3),
    ("steer_angle_scale", -9.1),
    ("steer_command_angle_scale", 5.0),
    ("steering_constant", 0.6),
    ("max_steer_angle", 0.5),
    ("max_steer_rate", 5.0),
    ("brake_delay_constant", 6.6),
    ("max_brake_rate_neg", 0.9),
    ("max_brake_rate_pos", 0.33),
    ("c_throttle", 40.0),
    ("c_brake", (30.0, 1.0)),
    ("c_rolling", (2.0, 0.5)),
    ("c_sliding", (10.0, 1.0)),
    ("y_f_c", (0.5, 20.0)),
    ("c_omega", 4.0),
    ("c_v_omega", 0.0),
    ("c_vx", 0.0),
    ("c_vy", 0.0),
)
PARAM_NAMES = tuple(name for name, _ in PARAMS)


def _tanh_scale(x, c):
    """c[0] tanh(c[1] x), the reference's tanh_scale drag term."""
    return c[0] * torch.tanh(c[1] * x)


class BicycleSlipDynamics(PackedParamsDynamics):
    STATE_DIM = 10
    CONTROL_DIM = 2
    OUTPUT_DIM = 10

    PARAMS = PARAMS

    def state_deriv(self, x, u, t=0.0):
        yaw, steer, brake = x[2], x[3], x[4]
        vel_x, vel_y, omega = x[5], x[6], x[7]
        throttle_brake, steer_cmd = u[0], u[1]
        enable_brake = throttle_brake < 0

        brake_d = torch.clamp(
            (torch.where(enable_brake, -throttle_brake, 0.0) - brake)
            * self.brake_delay_constant,
            -self.max_brake_rate_neg, self.max_brake_rate_pos)
        steer_d = torch.clamp(
            (steer_cmd * self.steer_command_angle_scale - steer) * self.steering_constant,
            -self.max_steer_rate, self.max_steer_rate)

        throttle = torch.where(enable_brake, 0.0, 1.0) * self.c_throttle * throttle_brake
        brake_force = _tanh_scale(vel_x, self.c_brake) * brake
        drag_x = _tanh_scale(vel_x, self.c_rolling)
        x_force = throttle - brake_force - drag_x

        drag_y = _tanh_scale(vel_y, self.c_sliding)
        y_force = torch.tanh(vel_x * omega * self.y_f_c[0]) * self.y_f_c[1] - drag_y

        wheel_angle = torch.tan(steer / self.steer_angle_scale)
        sin_w, cos_w = torch.sin(wheel_angle), torch.cos(wheel_angle)

        parametric_omega = (vel_x / self.wheel_base) * wheel_angle
        omega_d = (parametric_omega - omega) * self.c_omega - omega * self.c_v_omega

        vel_x_d = ((x_force + x_force * cos_w - y_force * sin_w) / self.mass
                   - vel_x * self.c_vx + vel_y * omega)
        vel_y_d = ((y_force + y_force * cos_w + x_force * sin_w) / self.mass
                   - vel_y * self.c_vy - vel_x * omega)

        cos_y, sin_y = torch.cos(yaw), torch.sin(yaw)
        x_d = vel_x * cos_y - vel_y * sin_y
        y_d = vel_x * sin_y + vel_y * cos_y
        zero = torch.zeros_like(x_d)
        return torch.stack([x_d, y_d, omega, steer_d, brake_d, vel_x_d, vel_y_d,
                            omega_d, zero, zero])

    def update_state(self, x, xdot, dt):
        x_next = x + xdot * dt
        yaw = math_utils.normalize_angle(x_next[2])
        steer = torch.clamp(x_next[3], -self.max_steer_angle, self.max_steer_angle)
        brake = torch.minimum(torch.clamp(x_next[4], min=0.0), self.brake_max)
        return torch.stack([x_next[0], x_next[1], yaw, steer, brake, x_next[5],
                            x_next[6], x_next[7], x_next[8], x_next[9]])

    def kernel_params(self):
        """The packed table csrc/bicycle_slip.cuh stages: PARAMS in order
        (pairs flattened), then the brake limit."""
        return self.params

    def state_from_map(self, mapping):
        keys = ["POS_X", "POS_Y", "YAW", "STEER_ANGLE", "BRAKE_STATE",
                "VEL_X", "VEL_Y", "OMEGA_Z", "ROLL", "PITCH"]
        return torch.tensor([mapping.get(k, 0.0) for k in keys], dtype=torch.float32,
                            device=self.params.device)
