"""RACER Dubins dynamics (an all-wheel-drive car with a brake state and a
steering lag), in PyTorch.

Counterpart of ``RacerDubinsDynamics`` in
``mppi_generic_tpu/models/racer_dubins.py`` (reference
``dynamics/racer_dubins/racer_dubins.{cuh,cu}``), operation for operation:
state [vel_x, yaw, pos_x, pos_y, steer_angle, brake_state,
steer_angle_rate], control [throttle_brake, steer_cmd]; the brake
actuator's lag with asymmetric rate limits, the throttle, brake, drag and
offset forces, the yaw rate (v / wheel_base) tan(steer / steer_angle_scale),
the rate-limited steering, then the Euler update with the yaw wrap, the
steer-angle clamp, the steer-rate bookkeeping and the brake clamp to
[0, -u_min_throttle_brake].

The parameters are one packed float32 buffer ``params``
(``PackedParamsDynamics``: the names of ``PARAMS`` in order, the triples
and pairs flattened, then the brake limit -control_ranges[0, 0]). The
elevation and LSTM models (``racer_dubins_elevation.py``,
``racer_dubins_unc.py``) extend ``PARAMS``; their CUDA kernels read this
table, and so do this model's (``csrc/racer_dubins.cuh``: ``kernel_params``
is ``params``).
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.models.base import PackedParamsDynamics
from mppi_generic_tpu_torch.utils import math_utils


class RacerDubinsDynamics(PackedParamsDynamics):
    STATE_DIM = 7
    CONTROL_DIM = 2
    OUTPUT_DIM = 7

    # (name, default): racer_dubins.cuh:81-102, in the kernels' table order
    PARAMS = (
        ("c_t", 1.3), ("c_b", 2.5), ("c_v", 3.7), ("c_0", 4.9),
        ("steering_constant", 0.6), ("steer_command_angle_scale", 5.0),
        ("steer_angle_scale", -9.1), ("max_steer_angle", 0.5), ("max_steer_rate", 5.0),
        ("brake_delay_constant", 6.6), ("max_brake_rate_neg", 0.9),
        ("max_brake_rate_pos", 0.33), ("wheel_base", 0.3), ("gear_sign", 1.0),
    )

    def _brake_deriv(self, throttle_brake, brake):
        return torch.clamp(
            (torch.where(throttle_brake < 0, -throttle_brake, 0.0) - brake)
            * self.brake_delay_constant,
            -self.max_brake_rate_neg, self.max_brake_rate_pos)

    def _steer_deriv(self, x, u):
        return torch.clamp(
            (u[1] * self.steer_command_angle_scale - x[4]) * self.steering_constant,
            -self.max_steer_rate, self.max_steer_rate)

    def _yaw_rate(self, vel, steer):
        return (vel / self.wheel_base) * torch.tan(steer / self.steer_angle_scale)

    def state_deriv(self, x, u, t=0.0):
        vel, yaw, brake = x[0], x[1], x[5]
        throttle_brake = u[0]
        enable_brake = throttle_brake < 0
        brake_d = self._brake_deriv(throttle_brake, brake)
        vel_d = (torch.where(enable_brake, 0.0, 1.0) * self.c_t * throttle_brake
                 * self.gear_sign
                 + self.c_b * brake * torch.where(vel >= 0, -1.0, 1.0)
                 - self.c_v * vel + self.c_0)
        yaw_d = self._yaw_rate(vel, x[4])
        x_d = vel * torch.cos(yaw)
        y_d = vel * torch.sin(yaw)
        steer_d = self._steer_deriv(x, u)
        return torch.stack([vel_d, yaw_d, x_d, y_d, steer_d, brake_d, torch.zeros_like(vel_d)])

    def _clamp_steer_brake(self, steer, brake):
        return (torch.clamp(steer, -self.max_steer_angle, self.max_steer_angle),
                torch.minimum(torch.clamp(brake, min=0.0), self.brake_max))

    def update_state(self, x, xdot, dt):
        x_next = x + xdot * dt
        yaw = math_utils.normalize_angle(x_next[1])
        steer, brake = self._clamp_steer_brake(x_next[4], x_next[5])
        # STEER_ANGLE_RATE is bookkeeping: the steering derivative
        return torch.stack([x_next[0], yaw, x_next[2], x_next[3], steer, brake, xdot[4]])

    def state_from_map(self, mapping):
        keys = ["VEL_X", "YAW", "POS_X", "POS_Y", "STEER_ANGLE", "BRAKE_STATE",
                "STEER_ANGLE_RATE"]
        return torch.tensor([mapping.get(k, 0.0) for k in keys], dtype=torch.float32,
                            device=self.params.device)
