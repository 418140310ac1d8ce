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
-control_ranges[0, 0].

``BicycleSlipParametricElevation`` (the JAX package's
bicycle_slip.py:159-363, reference ``BicycleSlipParametricImpl :
RacerDubinsElevationImpl``) adds to it, in 22 states and 14 outputs: the
normals map's gravity terms, the propagated 4 x 4 covariance (the bicycle's
Jacobian, the racer models' parametric Q, ``propagate_uncertainty``) and
static settling on the elevation map; its CUDA step is
``csrc/bicycle_elevation.cuh``. A normals map has no kernel (the JAX
package's kernel cannot read one either): the kernel wrappers refuse it.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.maps.texture import MapTexture2D
from mppi_generic_tpu_torch.models.base import PackedParamsDynamics
from mppi_generic_tpu_torch.models.racer_dubins_elevation import (
    body_frame_normals,
    map_block,
    static_settling,
)
from mppi_generic_tpu_torch.models.racer_dubins_unc import parametric_q, propagate_uncertainty
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

    def state_from_map(self, mapping):
        keys = ["POS_X", "POS_Y", "YAW", "STEER_ANGLE", "BRAKE_STATE",
                "VEL_X", "VEL_Y", "OMEGA_Z", "ROLL", "PITCH"]
        return torch.tensor([mapping.get(k, 0.0) for k in keys], dtype=torch.float32,
                            device=self.params.device)


class BicycleSlipParametricElevation(BicycleSlipDynamics):
    """The elevation-coupled bicycle-slip model. State (22): [pos_x, pos_y,
    yaw, steer_angle, brake_state, vel_x, vel_y, omega_z, roll, pitch,
    steer_angle_rate, engine_rpm] and the ten packed covariance entries.
    Per step (``step``): the slip derivative (with a ``normals_map``, minus
    the gravity terms tanhshrink(n) gravity along the body-frame normal),
    the Euler update with the yaw wrap, the steer and brake clamps and the
    steer-rate write-back, Sigma' = (I + A dt) Sigma (I + A dt)^T + Q dt, and
    roll and pitch from static settling with the new position and yaw and
    the old roll and pitch. Output (14): [vel_x, vel_y, pos_x, pos_y, pos_z,
    yaw, roll, pitch, steer_angle, steer_angle_rate, accel_x, omega_z,
    total velocity, accel_y]."""

    STATE_DIM = 22
    OUTPUT_DIM = 14

    # the gravity-along-normal coefficients and the tracking-feedback-aware
    # uncertainty (bicycle_slip_parametric.cuh:52-53, RacerDubinsElevationParams)
    PARAMS = PARAMS + (
        ("gravity_x", -3.9), ("gravity_y", -7.2), ("min_normal_x", 0.2),
        ("min_normal_y", 0.2), ("K_vel_x", 0.0), ("K_x", 0.0), ("K_y", 0.0), ("K_yaw", 0.0),
        ("Q_x_acc", 0.1), ("Q_x_v", (0.1, 0.1, 0.1)), ("Q_omega_steering", 0.1),
        ("Q_omega_v", 0.1), ("Q_y_f", 0.1),
    )

    def __init__(self, elevation_map: MapTexture2D | None = None,
                 normals_map: MapTexture2D | None = None, control_ranges=None,
                 control_deadband=None, zero_control=None, device="cpu", **params):
        super().__init__(control_ranges, control_deadband, zero_control, device=device,
                         **params)
        self.elevation_map = None if elevation_map is None else elevation_map.to(device)
        self.normals_map = None if normals_map is None else normals_map.to(device)
        self.register_buffer("map_meta", map_block(elevation_map).to(device))

    @classmethod
    def create(cls, elevation_map=None, normals_map=None, control_ranges=None, device="cpu",
               **params):
        return cls(elevation_map, normals_map, control_ranges, device=device, **params)

    def state_deriv(self, x, u, t=0.0):
        flat = super().state_deriv(x, u, t)  # the slip model on the first 10 states
        vel_x_d, vel_y_d = flat[5], flat[6]
        if self.normals_map is not None:
            nx, ny, _ = body_frame_normals(self.normals_map, x[0], x[1], x[2], x[8], x[9])
            # tanhshrink_scale(n, m) = n - m tanh(n / m)
            gx = (nx - self.min_normal_x * torch.tanh(nx / self.min_normal_x)) * self.gravity_x
            gy = (ny - self.min_normal_y * torch.tanh(ny / self.min_normal_y)) * self.gravity_y
            vel_x_d, vel_y_d = vel_x_d + -gx, vel_y_d + -gy
        zero = torch.zeros_like(flat[0])
        return torch.stack([*flat[:5], vel_x_d, vel_y_d, *flat[7:], *([zero] * 12)])

    def _unc_jacobian(self, x):
        """A in (vx, yaw, px, py) order with the bicycle's lateral-velocity
        position terms (computeUncertaintyJacobian,
        bicycle_slip_parametric.cu:467-548)."""
        vel, vel_y, yaw, steer = x[5], x[6], x[2], x[3]
        sin_y, cos_y = torch.sin(yaw), torch.cos(yaw)
        cos_d = torch.cos(steer / self.steer_angle_scale)
        cos2_d = cos_d * cos_d
        L = self.wheel_base
        zero = torch.zeros_like(vel)
        return [
            [-self.c_vx - self.K_vel_x + zero, zero, -self.K_x * cos_y, -self.K_x * sin_y],
            [zero, -torch.abs(vel) * self.K_yaw / (L * cos2_d),
             vel * self.K_y * sin_y / (L * cos2_d), -vel * self.K_y * cos_y / (L * cos2_d)],
            [cos_y + zero, -sin_y * vel - cos_y * vel_y, zero, zero],
            [sin_y + zero, cos_y * vel - sin_y * vel_y, zero, zero],
        ]

    def _q_matrix(self, x, vel_d):
        """The racer models' parametric Q (``parametric_q``) on the bicycle's
        state layout, with gravity 9.81."""
        return parametric_q(self, x[5], x[2], x[3], x[8], vel_d, 9.81)

    def _clamped(self, nxt):
        """The wrapped yaw and the clamped steer angle and brake of x + xdot dt."""
        return (math_utils.normalize_angle(nxt[2]),
                torch.clamp(nxt[3], -self.max_steer_angle, self.max_steer_angle),
                torch.minimum(torch.clamp(nxt[4], min=0.0), self.brake_max))

    def step(self, x, u, t, dt):
        xdot = self.state_deriv(x, u, t)
        nxt = x + xdot * dt
        yaw, steer, brake = self._clamped(nxt)
        unc = propagate_uncertainty(x[12:22], self._unc_jacobian(x),
                                    self._q_matrix(x, xdot[5]), dt)
        roll, pitch, height = static_settling(self.elevation_map, nxt[0], nxt[1], yaw, x[8],
                                              x[9])
        x_next = torch.cat([torch.stack([nxt[0], nxt[1], yaw, steer, brake, nxt[5], nxt[6],
                                         nxt[7], roll, pitch, xdot[3], nxt[11]]), unc])
        total_v = math_utils.sign(nxt[5]) * torch.sqrt(nxt[5] * nxt[5] + nxt[6] * nxt[6])
        y = torch.stack([x_next[5], x_next[6], x_next[0], x_next[1], height, yaw, roll, pitch,
                         steer, xdot[3], xdot[5], x_next[7], total_v, xdot[6]])
        return x_next, y

    def update_state(self, x, xdot, dt):
        """The host's updateState (bicycle_slip_parametric.cu:152-167): the
        Euler update with the yaw wrap, the clamps and the steer-rate
        write-back, roll and pitch held (``step`` settles them)."""
        nxt = x + xdot * dt
        yaw, steer, brake = self._clamped(nxt)
        return torch.cat([torch.stack([nxt[0], nxt[1], yaw, steer, brake, nxt[5], nxt[6],
                                       nxt[7], x[8], x[9], xdot[3], nxt[11]]), nxt[12:22]])

    def get_zero_state(self):
        return torch.zeros((self.STATE_DIM,), dtype=torch.float32, device=self.params.device)

    def state_from_map(self, mapping):
        keys = ["POS_X", "POS_Y", "YAW", "STEER_ANGLE", "BRAKE_STATE", "VEL_X", "VEL_Y",
                "OMEGA_Z", "ROLL", "PITCH", "STEER_ANGLE_RATE", "ENGINE_RPM"]
        return torch.tensor([mapping.get(k, 0.0) for k in keys] + [0.0] * 10,
                            dtype=torch.float32, device=self.params.device)
