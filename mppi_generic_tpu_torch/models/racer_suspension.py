"""Full-suspension racer dynamics, in PyTorch.

Counterpart of ``RacerSuspensionDynamics`` in
``mppi_generic_tpu/models/racer_suspension.py`` (reference
``dynamics/racer_suspension/racer_suspension.{cuh,cu}``), operation for
operation: a 14-state rigid body, inertial position (3), attitude quaternion
(4, [w, x, y, z]), inertial velocity (3), body angular rate (3), steering
angle (1), with four wheels:

* suspension: a spring-damper normal force per wheel against the terrain
  height under the nominally placed wheel, clamped at zero on extension;
* lateral contact: Stribeck friction clamp(v / v_slip mu, +-mu);
  longitudinal: the linear engine model's force split across the wheels and
  clamped to the friction cone;
* Ackermann steering for the two front wheels (``atan2_approx`` with the
  reference's atan quadrant: ``math_utils.sign`` of the denominator, 1 at
  0), a first-order steering actuator; the engine's brake term takes
  ``torch.sign`` of the body velocity (0 at 0), as the JAX model's
  ``jnp.sign``;
* the rigid-body derivative pdot = v, vdot = R f_B / m + g, qdot = 0.5 q (x)
  [0, w], wdot = J^-1 ((J w) x w + tau_B); explicit Euler with the
  quaternion renormalized (its norm + 1e-12).

``step`` runs one force pass at the pre-step state: the outputs (26: the
base link's body velocity and position, yaw, roll, pitch by the polynomial
``atan2_approx`` / ``asin_approx``, the steering angle and rate, the wheels'
positions and force magnitudes, the accelerations and the yaw rate) come
from that pass, not from the next state. ``state_to_output`` re-derives at
zero control. With an ``elevation_map`` each step reads the terrain height
under the four wheels (``MapTexture2D.query_world_components``, the
kernels' operations); without one the ground is flat. The reference's
torque-Jacobian typo feeds only its unused implicit path and is left out,
as in the JAX model.

The parameters are one packed float32 buffer ``params``
(``PackedParamsDynamics``: ``PARAMS`` in order, k_s and c_s four floats
each, then the brake limit); the CUDA kernels (``csrc/racer_suspension.cuh``)
read ``kernel_params()``, the params and the map block of
``racer_dubins_elevation.map_block``, and the map data ``kernel_map()``.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.maps.texture import MapTexture2D
from mppi_generic_tpu_torch.models.base import PackedParamsDynamics
from mppi_generic_tpu_torch.models.racer_dubins_elevation import map_block
from mppi_generic_tpu_torch.utils import math_utils


class RacerSuspensionDynamics(PackedParamsDynamics):
    STATE_DIM = 14
    CONTROL_DIM = 2
    OUTPUT_DIM = 26

    # (name, default): RacerSuspensionParams (racer_suspension.cuh:66-90),
    # the throttle and steering models, in the kernels' table order
    PARAMS = (
        ("wheel_radius", 0.32), ("mass", 1447.0), ("wheel_base", 2.981), ("width", 1.5),
        ("height", 1.5), ("gravity", -9.81), ("k_s", (14000.0,) * 4), ("c_s", (2000.0,) * 4),
        ("mu", 0.65), ("v_slip", 0.1), ("c_t", 3.0), ("c_b", 10.0), ("c_v", 0.2),
        ("c_0", 0.0), ("gear_sign", 1.0), ("steering_constant", 0.6),
        ("steer_command_angle_scale", -2.45),
    )

    def __init__(self, elevation_map: MapTexture2D | None = None, control_ranges=None,
                 control_deadband=None, zero_control=None, device="cpu", **params):
        super().__init__(control_ranges, control_deadband, zero_control, device=device,
                         **params)
        self.elevation_map = None if elevation_map is None else elevation_map.to(device)
        self.register_buffer("map_meta", map_block(elevation_map).to(device))

    @classmethod
    def create(cls, elevation_map=None, control_ranges=None, device="cpu", **params):
        return cls(elevation_map, control_ranges, device=device, **params)

    # the cg w.r.t. the base link, (wheel_base / 2, 0, 0.2), and the wheels
    # (racer_suspension.cuh:110-124)
    def _cg_pos(self):
        zero = torch.zeros_like(self.wheel_base)
        return self.wheel_base / 2, zero, zero + 0.2

    def _wheel_pos(self, i):
        half_w = self.width / 2
        wb = self.wheel_base
        zero = torch.zeros_like(wb)
        return [(wb, half_w, zero), (wb, -half_w, zero),
                (zero, half_w, zero), (zero, -half_w, zero)][i]

    def _l0(self, i):
        return self.wheel_radius + self.mass / 4 * (-self.gravity) / self.k_s[i]

    def _terrain_height(self, px, py):
        if self.elevation_map is None:
            return torch.zeros_like(px)
        return self.elevation_map.query_world_components(px, py)

    def _derive(self, x, u):
        """(state derivative (14, ...), the pass's values for the outputs)."""
        px, py, pz = x[0], x[1], x[2]
        qw, qx, qy, qz = x[3], x[4], x[5], x[6]
        vx, vy, vz = x[7], x[8], x[9]
        wx, wy, wz = x[10], x[11], x[12]
        steer_angle = x[13]

        r00 = 1 - 2 * (qy * qy + qz * qz)
        r01 = 2 * (qx * qy - qw * qz)
        r02 = 2 * (qx * qz + qw * qy)
        r10 = 2 * (qx * qy + qw * qz)
        r11 = 1 - 2 * (qx * qx + qz * qz)
        r12 = 2 * (qy * qz - qw * qx)
        r20 = 2 * (qx * qz - qw * qy)
        r21 = 2 * (qy * qz + qw * qx)
        r22 = 1 - 2 * (qx * qx + qy * qy)

        def R_mul(a, b, c):  # R @ [a, b, c]
            return (r00 * a + r01 * b + r02 * c, r10 * a + r11 * b + r12 * c,
                    r20 * a + r21 * b + r22 * c)

        def Rt_mul(a, b, c):  # R^T @ [a, b, c]
            return (r00 * a + r10 * b + r20 * c, r01 * a + r11 * b + r21 * c,
                    r02 * a + r12 * b + r22 * c)

        tan_delta = torch.tan(steer_angle)
        vel_bx, _, _ = Rt_mul(vx, vy, vz)
        throttle = torch.clamp_min(u[0], 0.0)
        brake = torch.clamp_min(-u[0], 0.0)
        acc = (self.c_t * throttle - torch.sign(vel_bx) * self.c_b * brake
               - self.c_v * vel_bx + self.c_0)
        propulsion_force = self.mass * acc

        cgx, cgy, cgz = self._cg_pos()
        zero, one = torch.zeros_like(px), torch.ones_like(px)
        fB = [zero] * 3
        tauB = [zero] * 3
        wheel_pos_out, wheel_force_out = [], []
        nbx, nby, nbz = Rt_mul(zero, zero, one)  # the terrain normal e_z in the body
        for i in range(4):
            wpx, wpy, wpz = self._wheel_pos(i)
            bx, by, bz = wpx - cgx, wpy - cgy, wpz - cgz
            rx, ry, rz = R_mul(bx, by, bz)
            pwx, pwy, pwz = px + rx, py + ry, pz + rz
            h_i = self._terrain_height(pwx, pwy)
            l_i = pwz - h_i
            ox, oy, oz = wy * bz - wz * by, wz * bx - wx * bz, wx * by - wy * bx
            rox, roy, roz = R_mul(ox, oy, oz)
            pdx, pdy, pdz = vx + rox, vy + roy, vz + roz
            h_dot_i = torch.zeros_like(pdx)
            l_dot_i = pdz - h_dot_i
            f_k = -self.k_s[i] * (l_i - self._l0(i)) - self.c_s[i] * l_dot_i
            f_k = torch.clamp_min(f_k, 0.0)

            if i < 2:  # Ackermann, front left then front right
                half = tan_delta * self.width / 2
                den = self.wheel_base - half if i == 0 else self.wheel_base + half
                delta = math_utils.atan2_approx(
                    self.wheel_base * tan_delta * math_utils.sign(den), torch.abs(den))
            else:
                delta = torch.zeros_like(tan_delta)

            wdx, wdy = torch.cos(delta), torch.sin(delta)
            sx = nby * 0.0 - nbz * wdy
            sy = nbz * wdx - nbx * 0.0
            sz = nbx * wdy - nby * wdx
            s_norm = torch.sqrt(sx * sx + sy * sy + sz * sz) + 1e-9
            sx, sy, sz = sx / s_norm, sy / s_norm, sz / s_norm
            tx = sy * nbz - sz * nby
            ty = sz * nbx - sx * nbz
            tz = sx * nby - sy * nbx

            cvx, cvy, cvz = Rt_mul(pdx, pdy, h_dot_i)
            v_w_s = sx * cvx + sy * cvy + sz * cvz
            f_n = f_k
            mu_s = torch.clamp(v_w_s / self.v_slip * self.mu, -self.mu, self.mu)
            f_s = -mu_s * f_n
            f_t = torch.clamp(propulsion_force / 4, -self.mu * f_n, self.mu * f_n)
            fbx = tx * f_t + sx * f_s + nbx * f_n
            fby = ty * f_t + sy * f_s + nby * f_n
            fbz = tz * f_t + sz * f_s + nbz * f_n

            pcx, pcy, pcz = Rt_mul(pwx - px, pwy - py, h_i - pz)
            fB = [fB[0] + fbx, fB[1] + fby, fB[2] + fbz]
            tauB = [tauB[0] + pcy * fbz - pcz * fby,
                    tauB[1] + pcz * fbx - pcx * fbz,
                    tauB[2] + pcx * fby - pcy * fbx]
            wheel_pos_out.extend([pwx, pwy])
            wheel_force_out.append(torch.sqrt(fbx * fbx + fby * fby + fbz * fbz))

        fwx, fwy, fwz = R_mul(*fB)
        vdx = fwx / self.mass
        vdy = fwy / self.mass
        vdz = fwz / self.mass + self.gravity
        qdw = 0.5 * (-qx * wx - qy * wy - qz * wz)
        qdx = 0.5 * (qw * wx + qy * wz - qz * wy)
        qdy = 0.5 * (qw * wy - qx * wz + qz * wx)
        qdz = 0.5 * (qw * wz + qx * wy - qy * wx)
        div = math_utils.true_div
        Jxx = div(self.mass, 12) * (self.height * self.height + self.width * self.width)
        Jyy = div(self.mass, 12) * (self.height * self.height
                                    + self.wheel_base * self.wheel_base)
        Jzz = div(self.mass, 12) * (self.wheel_base * self.wheel_base
                                    + self.width * self.width)
        jw_x, jw_y, jw_z = Jxx * wx, Jyy * wy, Jzz * wz
        wdx_ = (jw_y * wz - jw_z * wy + tauB[0]) / Jxx
        wdy_ = (jw_z * wx - jw_x * wz + tauB[1]) / Jyy
        wdz_ = (jw_x * wy - jw_y * wx + tauB[2]) / Jzz
        steer = u[1] / self.steer_command_angle_scale
        steer_d = self.steering_constant * (steer - steer_angle)

        xdot = torch.stack([vx, vy, vz, qdw, qdx, qdy, qdz, vdx, vdy, vdz, wdx_, wdy_, wdz_,
                            steer_d])
        aux = dict(R_mul=R_mul, Rt_mul=Rt_mul, wheel_pos=wheel_pos_out,
                   wheel_force=wheel_force_out, steer_rate=steer_d)
        return xdot, aux

    def state_deriv(self, x, u, t=0.0):
        return self._derive(x, u)[0]

    def update_state(self, x, xdot, dt):
        """Explicit Euler and the quaternion renormalized
        (racer_suspension.cu:55-75); its squares summed left to right."""
        x_next = x + xdot * dt
        q = x_next[3:7]
        norm = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-12
        return torch.cat([x_next[:3], q / norm, x_next[7:]], dim=0)

    def state_to_output(self, x):
        """The output of a zero-control force pass at x (``step`` assembles
        it from its own pass)."""
        xdot, aux = self._derive(x, torch.zeros_like(x[:2]))
        return self._assemble_output(x, xdot, aux)

    def _assemble_output(self, x, xdot, aux):
        px, py, pz = x[0], x[1], x[2]
        qw, qx, qy, qz = x[3], x[4], x[5], x[6]
        vx, vy, vz = x[7], x[8], x[9]
        wx, wy, wz = x[10], x[11], x[12]
        cgx, cgy, cgz = self._cg_pos()
        cvx, cvy, cvz = aux["Rt_mul"](vx, vy, vz)
        blx, bly, blz = -cgx, -cgy, -cgz
        bvx = cvx + wy * blz - wz * bly
        bvy = cvy + wz * blx - wx * blz
        bvz = cvz + wx * bly - wy * blx
        rbx, rby, rbz = aux["R_mul"](blx, bly, blz)
        bpx, bpy, bpz = px + rbx, py + rby, pz + rbz
        roll = math_utils.atan2_approx(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
        pitch = math_utils.asin_approx(2 * (qw * qy - qz * qx))
        yaw = math_utils.atan2_approx(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
        return torch.stack(
            [bvx, bvy, bvz, bpx, bpy, bpz, yaw, roll, pitch, x[13], aux["steer_rate"]]
            + aux["wheel_pos"] + aux["wheel_force"] + [xdot[7], xdot[8], wz])

    def step(self, x, u, t, dt):
        """One force pass at x: the derivative and the outputs come from it."""
        xdot, aux = self._derive(x, u)
        return self.update_state(x, xdot, dt), self._assemble_output(x, xdot, aux)

    def get_zero_state(self):
        """At rest in static equilibrium with the identity attitude: the cg
        rides cg_z above the axle plane at wheel_radius."""
        x = torch.zeros((self.STATE_DIM,), dtype=torch.float32, device=self.params.device)
        x[2] = self.wheel_radius + 0.2
        x[3] = 1.0
        return x
