"""RACER Dubins elevation variants with suspension and learned uncertainty,
in PyTorch.

Counterpart of ``mppi_generic_tpu/models/racer_dubins_unc.py``, operation
for operation:

* ``RacerDubinsElevationSuspension`` (reference
  ``racer_dubins_elevation_suspension_lstm.{cuh,cu}``): the LSTM-steering
  elevation model, a small-angle four-wheel spring-damper suspension that
  drives the cg height, roll and pitch states (computeSimpleSuspensionStep,
  :60-165), and the 4 x 4 (vel_x, yaw, pos_x, pos_y) covariance propagated
  as Sigma' = (I + A dt) Sigma (I + A dt)^T + Q dt (racer_dubins_elevation.cu:
  672-760) with the feedback-aware Jacobian A (:337-426) and the parametric
  Q (:428-516). 23 states, 27 outputs.
* ``RacerDubinsElevationLSTMUncertainty`` (``racer_dubins_elevation_lstm_unc``):
  a quadratic brake model, a *mean* LSTM correcting the velocity and yaw
  derivatives (forward gear only), an *uncertainty* LSTM whose
  sigmoid-scaled outputs replace the parametric Q, the yaw rate and the
  static roll and pitch as three more states (26 states).

State layout: the nine states of ``RacerDubinsElevationDynamics``, then
[cg_pos_z, cg_vel_i_z, roll_rate, pitch_rate], the ten packed covariance
entries [pos_x, pos_y, yaw, vel_x, pos_x_y, pos_x_yaw, pos_x_vel_x,
pos_y_yaw, pos_y_vel_x, yaw_vel_x], and (uncertainty model) [omega_z,
static_roll, static_pitch]. The reference defects the JAX package does not
reproduce are not reproduced here either (its module docstring).

The CUDA kernels carry both models' steps (``csrc/racer_lstm_unc.cuh``: the
uncertainty model, and the suspension model as its form without the mean
and uncertainty LSTMs; B1, B3 and B4 entries with ARStandardCost on the
output layout (2, 3, 5, 6, 0, 1)), on flat ground or on an elevation map,
as the table's map block says: with a map the suspension reads the ground
under the four wheels and the uncertainty model settles its static roll and
pitch on it. A table (``kernel_params``) is the packed ``params``, the map
block (``racer_dubins_elevation.map_block``), the LSTMs' tables (steering,
then mean and uncertainty) and their warm (h, c) in the order of
``init_recurrent_state``. ``kernel_step_recurrent`` runs the LSTMs in the
kernels' order of operations.
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.models.racer_dubins_elevation import (
    STEER_LSTM,
    RacerDubinsElevationDynamics,
    RacerDubinsElevationLSTMSteering,
)
from mppi_generic_tpu_torch.nn.lstm import LSTM, sigmoid
from mppi_generic_tpu_torch.utils import math_utils

# the LSTMs the uncertainty model's kernels are compiled for
# (csrc/racer_lstm_unc.cuh): (input, hidden, head layers)
MEAN_LSTM = (11, 16, (27, 16, 2))
UNC_LSTM = (12, 16, (28, 16, 5))


def _sum(terms):
    """Python's sum, left to right from 0, as the JAX package writes it."""
    acc = 0.0
    for term in terms:
        acc = acc + term
    return acc


def unc_state_to_matrix(s10):
    """(10, ...) packed entries -> 4 x 4 nested lists of (...) entries, the
    symmetric covariance in (vx, yaw, px, py) order
    (uncertaintyStateToMatrix, racer_dubins_elevation.cu:519-579)."""
    px, py, yaw, vx, px_py, px_yaw, px_vx, py_yaw, py_vx, yaw_vx = (s10[i] for i in range(10))
    return [[vx, yaw_vx, px_vx, py_vx],
            [yaw_vx, yaw, px_yaw, py_yaw],
            [px_vx, px_yaw, px, px_py],
            [py_vx, py_yaw, px_py, py]]


def unc_matrix_to_state(S):
    """4 x 4 (nested lists or a (4, 4, ...) tensor) -> (10, ...) packed
    entries (uncertaintyMatrixToState)."""
    return torch.stack([S[2][2], S[3][3], S[1][1], S[0][0],
                        S[2][3], S[2][1], S[2][0], S[3][1], S[3][0], S[1][0]])


def propagate_uncertainty(s10, A, Q, dt):
    """Sigma' = (I + A dt) Sigma (I + A dt)^T + Q dt
    (computeUncertaintyPropagation, racer_dubins_elevation.cu:672-760),
    unrolled over the 4 x 4 entries with the JAX package's sums. ``A`` and
    ``Q`` are 4 x 4 nested lists (or tensors) of (...) entries."""
    S = unc_state_to_matrix(s10)
    Ad = [[A[i][j] * dt + (1.0 if i == j else 0.0) for j in range(4)] for i in range(4)]
    M = [[_sum(Ad[i][k] * S[k][j] for k in range(4)) for j in range(4)] for i in range(4)]
    S2 = [[_sum(M[i][k] * Ad[l][k] for k in range(4)) + Q[i][l] * dt for l in range(4)]
          for i in range(4)]
    return unc_matrix_to_state(S2)


def parametric_q(model, vel, yaw, steer, roll, vel_d, gravity):
    """The parametric Q (computeQ, racer_dubins_elevation.cu:428-516) of a
    state's speed, yaw, steering angle and roll and the speed's derivative,
    with ``model``'s coefficients ``Q_x_acc``, ``Q_x_v`` (by the speed
    regime), ``Q_omega_steering``, ``Q_omega_v``, ``Q_y_f`` and its
    ``steer_angle_scale`` and ``wheel_base``: 4 x 4 nested lists of entries.
    The racer suspension models and the bicycle elevation model share it
    (csrc/racer_elevation.cuh ``racer::parametric_q``)."""
    sin_y, cos_y = torch.sin(yaw), torch.cos(yaw)
    delta = steer / model.steer_angle_scale
    abs_v = torch.abs(vel)
    side_force = abs_v * abs_v * torch.tan(delta) / model.wheel_base + gravity * torch.sin(roll)
    q11 = torch.abs(model.Q_y_f * torch.abs(side_force) * torch.clamp_min(abs_v - 2.0, 0.0))
    zero = torch.zeros_like(vel)
    q_x_v = model.Q_x_v
    regime = torch.where(abs_v <= 0.2, q_x_v[0], torch.where(abs_v <= 3.0, q_x_v[1], q_x_v[2]))
    q_vv = model.Q_x_acc * torch.abs(vel_d) + regime * abs_v
    q_yy = abs_v * (model.Q_omega_steering * torch.abs(delta) + model.Q_omega_v)
    return [[q_vv, zero, zero, zero],
            [zero, q_yy, zero, zero],
            [zero, zero, q11 * sin_y * sin_y, -q11 * sin_y * cos_y],
            [zero, zero, -q11 * sin_y * cos_y, q11 * cos_y * cos_y]]


class RacerDubinsElevationSuspension(RacerDubinsElevationLSTMSteering):
    """LSTM-steering elevation model + simple suspension + uncertainty."""

    STATE_DIM = 23
    OUTPUT_DIM = 27

    PARAMS = RacerDubinsElevationDynamics.PARAMS + (
        # suspension (suspension_lstm.cuh:54-64)
        ("spring_k", 14000.0), ("drag_c", 1000.0), ("mass", 1447.0),
        ("I_xx", 1447.0 / 12 * 2 * 1.5**2), ("I_yy", 1447.0 / 12 * (1.5**2 + 3.0**2)),
        ("wheel_radius", 0.32), ("cg_x", 2.981 / 2), ("half_track", 0.737),
        # the tracking-feedback-aware uncertainty (racer_dubins_elevation.cuh)
        ("K_x", 1.0), ("K_y", 1.0), ("K_yaw", 1.0), ("K_vel_x", 1.0),
        ("Q_x_acc", 0.1), ("Q_x_v", (0.1, 0.1, 0.1)), ("Q_omega_steering", 0.1),
        ("Q_omega_v", 0.02), ("Q_y_f", 0.05),
    )

    def _wheel_body_positions(self):
        """FR, FL, BR, BL (suspension_lstm.cu:74-77)."""
        fx, ht = 2 * self.cg_x, self.half_track
        return [(fx, -ht), (fx, ht), (0.0, ht), (0.0, -ht)]

    def _suspension_derivs(self, x):
        """Small-angle four-wheel suspension (computeSimpleSuspensionStep):
        (cgz_d, cgvz_d, rollrate_d, pitchrate_d, up_max, fwd_max, side_max).
        A flat terrain normal, so h_dot = 0; without a map the wheel's ground
        height is cg_z - wheel_radius."""
        vel, yaw, pos_x, pos_y = x[0], x[1], x[2], x[3]
        roll, pitch, cg_z, cg_vz, roll_rate, pitch_rate = x[7], x[8], x[9], x[10], x[11], x[12]
        cos_y, sin_y = torch.cos(yaw), torch.sin(yaw)
        cg_vz_d = roll_rate_d = pitch_rate_d = torch.zeros_like(vel)
        up_max = fwd_max = side_max = torch.full_like(vel, -np.inf)
        wheels = self._wheel_body_positions()
        hs = None
        if self.elevation_map is not None:
            hs = self.elevation_map.query_world_components(
                torch.stack([pos_x + bx * cos_y - by * sin_y for bx, by in wheels]),
                torch.stack([pos_y + bx * sin_y + by * cos_y for bx, by in wheels]))
            hs = torch.where(torch.isfinite(hs), hs, cg_z - self.wheel_radius)
        for i, (bx, by) in enumerate(wheels):
            wx_cg = bx - self.cg_x
            wy_cg = by
            h = hs[i] if hs is not None else cg_z - self.wheel_radius
            wheel_z = cg_z + roll * wy_cg - pitch * wx_cg - self.wheel_radius
            wheel_vz = cg_vz + roll_rate * wy_cg - pitch_rate * wx_cg
            force = -self.spring_k * (wheel_z - h) - self.drag_c * wheel_vz
            up_max = torch.maximum(up_max, force)
            fwd_max = torch.maximum(fwd_max, torch.abs(force * -pitch))
            side_max = torch.maximum(side_max, torch.abs(force * roll))
            cg_vz_d = cg_vz_d + force / self.mass
            roll_rate_d = roll_rate_d + force * wy_cg / self.I_xx
            pitch_rate_d = pitch_rate_d - force * wx_cg / self.I_yy
        return cg_vz, cg_vz_d, roll_rate_d, pitch_rate_d, up_max, fwd_max, side_max

    def _unc_jacobian(self, x):
        """A = df/dx + df/du K in (vx, yaw, px, py) order
        (computeUncertaintyJacobian, racer_dubins_elevation.cu:337-426)."""
        vel, yaw, steer, brake_raw = x[0], x[1], x[4], x[5]
        sin_y, cos_y = torch.sin(yaw), torch.cos(yaw)
        delta = steer / self.steer_angle_scale
        tan_d = torch.tan(delta)
        cos_d = torch.cos(delta)
        cos2_d = cos_d * cos_d
        brake_state = torch.clamp(brake_raw, 0.0, 0.25)
        L = self.wheel_base
        zero = torch.zeros_like(vel)
        low_regime = torch.abs(vel) <= 0.2
        a_vv = (-self._regime_select(vel, self.c_v3) - self.K_vel_x
                - torch.where(low_regime, self.c_b3[0] * brake_state, 0.0))
        return [
            [a_vv, zero, -self.K_x * cos_y, -self.K_x * sin_y],
            [tan_d / L + zero, -torch.abs(vel) * self.K_yaw / (L * cos2_d),
             vel * self.K_y * sin_y / (L * cos2_d), -vel * self.K_y * cos_y / (L * cos2_d)],
            [cos_y + zero, -sin_y * vel, zero, zero],
            [sin_y + zero, cos_y * vel, zero, zero],
        ]

    def _q_matrix(self, x, vel_d):
        """The parametric Q (``parametric_q``) of the state."""
        return parametric_q(self, x[0], x[1], x[4], x[7], vel_d, self.gravity)

    def _core_step(self, x, h, c, u, t, lstm_forward):
        """The parametric derivatives over the first nine states, the LSTM
        steering rate and the suspension."""
        x9 = x[:9]
        xdot9 = RacerDubinsElevationDynamics.state_deriv(self, x9, u, t)
        steer_d_param = self._steer_deriv(x9, u)
        feats = torch.stack([x[0], x[4], u[1], steer_d_param])
        delta_s, h, c = lstm_forward(self.lstm)(h, c, feats)
        return (xdot9, steer_d_param + delta_s[0], h, c) + self._suspension_derivs(x)

    def _integrate_core(self, x, xdot, steer_d, dt):
        """x[:13] + xdot dt with the yaw wrap, the steer and brake clamps and
        the steer rate."""
        core = x[:13] + xdot * dt
        yaw = math_utils.normalize_angle(core[1])
        steer, brake = self._clamp_steer_brake(core[4], core[5])
        return torch.cat([torch.stack([core[0], yaw, core[2], core[3], steer, brake,
                                       steer_d]), core[7:13]])

    @staticmethod
    def _output(x_next, vel_d, yaw_d, up_max, fwd_max, side_max):
        """27 outputs (racer_dubins.cuh OutputIndex): [vel_b_x, vel_b_y,
        pos_x, pos_y, pos_z, yaw, roll, pitch, steer_angle, steer_rate, the
        wheel forces up/fwd/side max, accel_x, accel_y, omega_z, |v|] and the
        ten covariance entries."""
        zero = torch.zeros_like(x_next[0])
        return torch.cat([torch.stack([
            x_next[0], zero, x_next[2], x_next[3], x_next[9], x_next[1], x_next[7],
            x_next[8], x_next[4], x_next[6], up_max, fwd_max, side_max, vel_d, zero,
            yaw_d, torch.abs(x_next[0])]), x_next[13:23]])

    def _step_unc(self, x, rec, u, t, dt, lstm_forward):
        h, c = rec
        (xdot9, steer_d, h, c, cgz_d, cgvz_d, rollrate_d, pitchrate_d,
         up_max, fwd_max, side_max) = self._core_step(x, h, c, u, t, lstm_forward)
        vel_d, yaw_d = xdot9[0], xdot9[1]
        unc_next = propagate_uncertainty(x[13:23], self._unc_jacobian(x),
                                         self._q_matrix(x, vel_d), dt)
        zero = torch.zeros_like(vel_d)
        xdot = torch.stack([vel_d, yaw_d, xdot9[2], xdot9[3], steer_d, xdot9[5], zero,
                            x[11], x[12], cgz_d, cgvz_d, rollrate_d, pitchrate_d])
        x_next = torch.cat([self._integrate_core(x, xdot, steer_d, dt), unc_next])
        return x_next, self._output(x_next, xdot[0], xdot[1], up_max, fwd_max,
                                    side_max), (h, c)

    def step_recurrent(self, x, rec, u, t, dt):
        return self._step_unc(x, rec, u, t, dt, _eager)

    def kernel_step_recurrent(self, x, rec, u, t, dt):
        return self._step_unc(x, rec, u, t, dt, _plain)

    def state_from_map(self, mapping):
        keys = ["VEL_X", "YAW", "POS_X", "POS_Y", "STEER_ANGLE", "BRAKE_STATE",
                "STEER_ANGLE_RATE", "ROLL", "PITCH", "CG_POS_Z", "CG_VEL_I_Z",
                "ROLL_RATE", "PITCH_RATE"]
        core = [mapping.get(k, 0.0) for k in keys]
        return torch.tensor(core + [0.0] * 10, dtype=torch.float32,
                            device=self.params.device)


def _eager(lstm):
    return lstm.forward_axis0


def _plain(lstm):
    return lstm.forward_axis0_plain


class RacerDubinsElevationLSTMUncertainty(RacerDubinsElevationSuspension):
    """Suspension model + quadratic brake + mean LSTM + uncertainty LSTM
    (racer_dubins_elevation_lstm_unc.{cuh,cu})."""

    STATE_DIM = 26

    PARAMS = RacerDubinsElevationSuspension.PARAMS + (
        # the quadratic brake (lstm_unc.cu:246-256) and the sigmoid output
        # scales (params_p->unc_scale, :403-406)
        ("pos_quad_brake_c", (10.0, 0.0)), ("neg_quad_brake_c", (10.0, 0.0)),
        ("unc_scale", (1.0, 0.1, 1.0, 0.1, 1.0)),
    )
    WARM = ("warm_hidden", "warm_cell", "mean_warm_hidden", "mean_warm_cell",
            "unc_warm_hidden", "unc_warm_cell")

    def __init__(self, lstm: LSTM, mean_lstm: LSTM, unc_lstm: LSTM, elevation_map=None,
                 control_ranges=None, lstm_lstm=None, mean_lstm_lstm=None,
                 unc_lstm_lstm=None, warm=None, device="cpu", **params):
        """``warm`` maps names of ``WARM`` to (H,) arrays (zeros where
        missing)."""
        warm = dict(warm or {})
        super().__init__(lstm, elevation_map, control_ranges, lstm_lstm=lstm_lstm,
                         warm_hidden=warm.get("warm_hidden"),
                         warm_cell=warm.get("warm_cell"), device=device, **params)
        self.mean_lstm = mean_lstm.to(device)
        self.unc_lstm = unc_lstm.to(device)
        self.mean_lstm_lstm = None if mean_lstm_lstm is None else mean_lstm_lstm.to(device)
        self.unc_lstm_lstm = None if unc_lstm_lstm is None else unc_lstm_lstm.to(device)
        for name, net in (("mean_warm", mean_lstm), ("unc_warm", unc_lstm)):
            H = net.hidden_dim
            for part in ("hidden", "cell"):
                v = warm.get(f"{name}_{part}")
                v = np.zeros((H,), np.float32) if v is None else np.asarray(v, np.float32)
                self.register_buffer(f"{name}_{part}", torch.tensor(v.reshape(H),
                                                                    device=device))

    @classmethod
    def create(cls, lstm=None, mean_lstm=None, unc_lstm=None, elevation_map=None,
               control_ranges=None, seed=0, device="cpu", **params):
        """The reference's three LSTMs (steering 4 -> 16, head 20-16-1; mean
        11 -> 16, head 27-16-2; uncertainty 12 -> 16, head 28-16-5), random
        from the numpy seeds ``seed``, ``seed + 1``, ``seed + 2`` at scale 0.1
        where not given."""
        nets = []
        for i, (net, arch) in enumerate(((lstm, STEER_LSTM), (mean_lstm, MEAN_LSTM),
                                         (unc_lstm, UNC_LSTM))):
            nets.append(net if net is not None
                        else LSTM.create(arch[0], arch[1], arch[2], seed=seed + i))
        return cls(*nets, elevation_map=elevation_map, control_ranges=control_ranges,
                   device=device, **params)

    @property
    def requires_buffer(self) -> bool:
        return any(n is not None for n in (self.lstm_lstm, self.mean_lstm_lstm,
                                           self.unc_lstm_lstm))

    def update_from_buffer(self, buffer):
        """Warm-start each LSTM that has an init network from the sensor
        buffer; updates the warm states in place and returns the model."""
        for prefix, init in (("", self.lstm_lstm), ("mean_", self.mean_lstm_lstm),
                             ("unc_", self.unc_lstm_lstm)):
            if init is not None:
                h0, c0 = init.initialize(buffer)
                getattr(self, f"{prefix}warm_hidden").copy_(h0)
                getattr(self, f"{prefix}warm_cell").copy_(c0)
                self.__dict__.pop("_table", None)
        return self

    def init_recurrent_state(self):
        return tuple(getattr(self, name) for name in self.WARM)

    def _nn_features(self, x, u, vel_d, yaw_d, with_roll):
        throttle = torch.clamp_min(u[0], 0.0)
        brake_cmd = torch.clamp_min(-u[0], 0.0)
        base = [x[0], x[23], x[5], x[4], x[6], throttle, brake_cmd, u[1]]
        if with_roll:
            base += [torch.sin(x[24]), torch.sin(x[25]), vel_d, yaw_d]
        else:
            base += [torch.sin(x[25]), vel_d, yaw_d]
        return torch.stack(base)

    def _step_unc(self, x, rec, u, t, dt, lstm_forward):
        h, c, mh, mc, uh, uc = rec
        (xdot9, steer_d, h, c, cgz_d, cgvz_d, rollrate_d, pitchrate_d,
         up_max, fwd_max, side_max) = self._core_step(x, h, c, u, t, lstm_forward)
        vel_d, yaw_d = xdot9[0], xdot9[1]

        # the quadratic brake replaces the parent's brake derivative
        err = torch.where(u[0] < 0, -u[0], 0.0) - x[5]
        pos, neg = self.pos_quad_brake_c, self.neg_quad_brake_c
        brake_d = torch.clamp(
            torch.where(err > 0, err * pos[0] + err * torch.abs(err) * pos[1],
                        err * neg[0] + err * torch.abs(err) * neg[1]),
            -self.max_brake_rate_neg, self.max_brake_rate_pos)

        # the mean LSTM's correction, forward gear only (lstm_unc.cu:262-281)
        feats_m = self._nn_features(x, u, vel_d, yaw_d, with_roll=False)
        mean_out, mh, mc = lstm_forward(self.mean_lstm)(mh, mc, feats_m)
        fwd_gear = self.gear_sign > 0
        vel_d = vel_d + torch.where(fwd_gear, mean_out[0], 0.0)
        yaw_d = yaw_d + torch.where(fwd_gear, mean_out[1], 0.0)

        # the uncertainty LSTM -> Q (lstm_unc.cu:300-495)
        feats_u = self._nn_features(x, u, vel_d, yaw_d, with_roll=True)
        unc_out, uh, uc = lstm_forward(self.unc_lstm)(uh, uc, feats_u)
        sig = sigmoid(unc_out)
        q = [torch.abs(sig[i] * self.unc_scale[i]) for i in range(5)]
        c_b = self._regime_select(x[0], self.c_b3) * torch.where(
            torch.abs(x[0]) <= 0.2, x[0], 1.0)
        delta = x[4] / self.steer_angle_scale
        cos_d = torch.cos(delta)
        yaw_gain = (x[0] / self.wheel_base) / (cos_d * cos_d * self.steer_angle_scale)
        q_vv = q[0] + c_b * c_b * q[4]
        q_yy = q[1] + yaw_gain * yaw_gain * q[3]
        q11 = q[2]
        sin_y, cos_y = torch.sin(x[1]), torch.cos(x[1])
        zero = torch.zeros_like(q_vv)
        q_lstm = [[q_vv, zero, zero, zero],
                  [zero, q_yy, zero, zero],
                  [zero, zero, q11 * (sin_y * sin_y), -q11 * sin_y * cos_y],
                  [zero, zero, -q11 * sin_y * cos_y, q11 * (cos_y * cos_y)]]
        q_param = self._q_matrix(x, vel_d)
        Q = [[torch.where(fwd_gear, a, b) for a, b in zip(ra, rb)]
             for ra, rb in zip(q_lstm, q_param)]
        unc_next = propagate_uncertainty(x[13:23], self._unc_jacobian(x), Q, dt)

        xdot = torch.stack([vel_d, yaw_d, xdot9[2], xdot9[3], steer_d, brake_d,
                            torch.zeros_like(vel_d), x[11], x[12], x[10], cgvz_d,
                            rollrate_d, pitchrate_d])
        core_next = self._integrate_core(x, xdot, steer_d, dt)
        # the static roll and pitch, settled with the new position and yaw
        # and the old static roll and pitch
        s_roll, s_pitch, _ = self._settle(core_next[2], core_next[3], core_next[1],
                                          x[24], x[25])
        x_next = torch.cat([core_next, unc_next, torch.stack([yaw_d, s_roll, s_pitch])])
        y = self._output(x_next, vel_d, yaw_d, up_max, fwd_max, side_max)
        return x_next, y, (h, c, mh, mc, uh, uc)

    def _kernel_table(self):
        for net, arch, what in ((self.lstm, STEER_LSTM, "steering"),
                                (self.mean_lstm, MEAN_LSTM, "mean"),
                                (self.unc_lstm, UNC_LSTM, "uncertainty")):
            self._lstm_check(net, arch, what)
        return torch.cat([self.params, self.map_meta, self.lstm.kernel_table(),
                          self.mean_lstm.kernel_table(), self.unc_lstm.kernel_table(),
                          *self.init_recurrent_state()])

    def state_from_map(self, mapping):
        base = super().state_from_map(mapping)
        tail = torch.tensor([mapping.get("OMEGA_Z", 0.0), mapping.get("STATIC_ROLL", 0.0),
                             mapping.get("STATIC_PITCH", 0.0)], dtype=torch.float32,
                            device=base.device)
        return torch.cat([base, tail])
