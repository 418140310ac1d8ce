"""RACER Dubins on an elevation map, and its LSTM-steering variant, in
PyTorch.

Counterpart of ``mppi_generic_tpu/models/racer_dubins_elevation.py``
(reference ``dynamics/racer_dubins/racer_dubins_elevation.{cuh,cu}`` and
``racer_dubins_elevation_lstm_steering.*``), operation for operation:

* state [vel_x, yaw, pos_x, pos_y, steer_angle, brake_state,
  steer_angle_rate, roll, pitch]; 13 outputs [vel_b_x, vel_b_y, pos_x,
  pos_y, pos_z, yaw, roll, pitch, steer_angle, steer_angle_rate, accel_x,
  omega_z, |v|];
* engine coefficients c_t, c_b, c_v picked by the speed regime |v| <= 0.2 /
  <= 3 / > 3 (``_regime_select``, a chain of selects), a low-throttle
  deadband and a linear brake near standstill, the acceleration clamped to
  +-clamp_ax, then the gravity term -g sin(pitch);
* roll and pitch from static settling on the elevation map
  (``static_settling``: four wheel heights, the per-axle asin slopes
  through ``asin_approx``), with the new position and yaw and the *old*
  roll and pitch;
* the LSTM variant corrects the steering rate with a prediction LSTM over
  [vel_x, steer_angle, steer_cmd, parametric steer rate]; its (h, c) ride
  the rollout beside the state, warm-started from the init LSTM over the
  sensor buffer (``update_from_buffer``).

The CUDA kernels carry both steps, the elevation model's in
``csrc/racer_dubins.cuh`` and the LSTM variant's in
``csrc/racer_lstm_steering.cuh`` (B1, B3 and B4 entries with ARStandardCost
on the output layout (2, 3, 5, 6, 0, 1)). They read ``kernel_params()``: the
packed ``params`` table, the elevation map's description (a flag word, the
int32 words [H, W, offset, stride], origin, rotation rows, resolution) and,
for the LSTM variant, the LSTM's table (``LSTM.kernel_table``) and the warm
(h, c); the map data is ``kernel_map()``. ``body_frame_normals`` (the
bicycle elevation model's normals-map terms) has no kernel.
``kernel_step_recurrent`` is the step in the kernels' order of operations
(the LSTM and its head summed left to right), which the kernels' plain
versions run; ``step_recurrent`` sums them with matmuls.
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.maps.texture import MapTexture2D
from mppi_generic_tpu_torch.models.base import broadcast_rec
from mppi_generic_tpu_torch.models.racer_dubins import RacerDubinsDynamics
from mppi_generic_tpu_torch.nn.lstm import LSTM, LSTMLSTM
from mppi_generic_tpu_torch.utils import math_utils

# wheel positions in the body frame (computeStaticSettling,
# racer_dubins.cu:364-368)
FRONT_X = 2.981
HALF_TRACK = 0.737
# the LSTM the kernels are compiled for (csrc/racer_lstm_steering.cuh):
# input 4, hidden 16, head 20-16-1
STEER_LSTM = (4, 16, (20, 16, 1))
# floats of a map's description in a kernel table (csrc/racer_elevation.cuh)
MAP_BLOCK = 20


def static_settling(elevation_map, pos_x, pos_y, yaw, roll, pitch):
    """Terrain static settling (RACER::computeStaticSettling,
    racer_dubins.cu:359-430): the elevation map under the four wheels (body
    offsets rotated by the attitude, R = Rz(yaw) Ry(pitch) Rx(roll), its
    first two columns), the per-axle asin slopes averaged into roll and
    pitch and the rear heights into the body height. Returns (roll, pitch,
    height); zeros without a map. The kernels' twin is ``static_settling``
    in csrc/racer_elevation.cuh."""
    if elevation_map is None:
        zero = torch.zeros_like(yaw)
        return zero, zero, zero
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    axx = cy * cp
    axy = cy * sp * sr - sy * cr
    ayx = sy * cp
    ayy = sy * sp * sr + cy * cr
    corners = [(FRONT_X, HALF_TRACK), (FRONT_X, -HALF_TRACK),
               (0.0, HALF_TRACK), (0.0, -HALF_TRACK)]
    px = torch.stack([pos_x + bx * axx + by * axy for bx, by in corners])
    py = torch.stack([pos_y + bx * ayx + by * ayy for bx, by in corners])
    fl, fr, rl, rr = elevation_map.query_world_components(px, py)

    asin, div = math_utils.asin_approx, math_utils.true_div
    front_roll = asin(div(torch.clamp(fl - fr, -2 * 0.736, 2 * 0.736), 2 * 0.737))
    rear_roll = asin(div(torch.clamp(rl - rr, -2 * 0.736, 2 * 0.736), 2 * 0.737))
    new_roll = 0.5 * (front_roll + rear_roll)
    left_pitch = asin(div(torch.clamp(rl - fl, -2.98, 2.98), 2.981))
    right_pitch = asin(div(torch.clamp(rr - fr, -2.98, 2.98), 2.981))
    new_pitch = 0.5 * (left_pitch + right_pitch)
    height = 0.5 * (rl + rr)

    def bounded(a):
        return torch.where(torch.isfinite(a) & (torch.abs(a) <= math_utils.PI), a,
                           2 * math_utils.PI)

    return bounded(new_roll), bounded(new_pitch), torch.where(torch.isfinite(height),
                                                              height, 0.0)


def body_frame_normals(normals_map, pos_x, pos_y, yaw, roll, pitch):
    """The mean terrain normal under the four wheels, rotated into the yaw
    frame (RACER::computeBodyFrameNormals, bicycle_slip_parametric.cu:
    391-466; ``body_frame_normals`` of the JAX package's
    racer_dubins_elevation.py:111-140). ``normals_map`` is a 3-channel
    ``MapTexture2D`` of unit normals, read at each wheel's body offset
    rotated into the world by (roll, pitch, yaw)
    (``query_at_world_offset_pose``). Returns (nx, ny, nz); (0, 0, 1) without
    a map or where a value is not finite. No kernel reads a normals map."""
    if normals_map is None:
        return torch.zeros_like(yaw), torch.zeros_like(yaw), torch.ones_like(yaw)
    world = torch.stack([pos_x, pos_y, torch.zeros_like(yaw)], dim=-1)
    rpy = torch.stack([roll, pitch, yaw])

    def corner(bx, by):
        off = torch.stack([torch.full_like(yaw, bx), torch.full_like(yaw, by),
                           torch.zeros_like(yaw)], dim=-1)
        return normals_map.query_at_world_offset_pose(world, off, rpy)

    n = (corner(FRONT_X, HALF_TRACK) + corner(FRONT_X, -HALF_TRACK)
         + corner(0.0, HALF_TRACK) + corner(0.0, -HALF_TRACK)) / 4.0
    cos_y, sin_y = torch.cos(yaw), torch.sin(yaw)
    nx = cos_y * n[..., 0] - sin_y * n[..., 1]
    ny = sin_y * n[..., 0] + cos_y * n[..., 1]
    nz = n[..., 2]
    bad = ~(torch.isfinite(nx) & torch.isfinite(ny) & torch.isfinite(nz))
    return (torch.where(bad, 0.0, nx), torch.where(bad, 0.0, ny),
            torch.where(bad, 1.0, nz))


def map_block(elevation_map) -> torch.Tensor:
    """The map's description in a kernel table (MAP_BLOCK floats): a flag
    word (1 with a map), the int32 words [H, W, offset, stride] and the
    float32 origin, rotation rows and resolution; zeros without a map."""
    if elevation_map is None:
        return torch.zeros((MAP_BLOCK,), dtype=torch.float32)
    words, geometry = elevation_map.kernel_meta(0)
    words = np.array([1, *words], np.int64)
    if words.max() >= 2**31:
        raise ValueError("the map is too large for the kernels' int32 indices")
    return torch.cat([torch.from_numpy(words.astype(np.int32).view(np.float32)),
                      geometry.cpu()])


class RacerDubinsElevationDynamics(RacerDubinsDynamics):
    STATE_DIM = 9
    OUTPUT_DIM = 13

    # the velocity-regime triples (racer_dubins.cuh:81-83) and the rest
    PARAMS = RacerDubinsDynamics.PARAMS + (
        ("c_t3", (1.3, 2.6, 3.9)), ("c_b3", (2.5, 3.5, 4.5)), ("c_v3", (3.7, 4.7, 5.7)),
        ("low_min_throttle", 0.13), ("clamp_ax", 10.0), ("gravity", 9.81),
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

    @staticmethod
    def _regime_select(vel, table):
        """table[regime(|vel|)] as a chain of selects."""
        av = torch.abs(vel)
        return torch.where(av <= 0.2, table[0], torch.where(av <= 3.0, table[1], table[2]))

    def state_deriv(self, x, u, t=0.0):
        vel, yaw, steer, brake_raw, pitch = x[0], x[1], x[4], x[5], x[8]
        throttle_brake = u[0]
        enable_brake = throttle_brake < 0
        c_t = self._regime_select(vel, self.c_t3)
        c_b = self._regime_select(vel, self.c_b3)
        c_v = self._regime_select(vel, self.c_v3)
        brake_state = torch.clamp(brake_raw, 0.0, 0.25)

        throttle_hi = c_t * throttle_brake
        brake_hi = c_b * brake_state * torch.where(vel >= 0, -1.0, 1.0)
        throttle_lo = c_t * torch.clamp_min(throttle_brake - self.low_min_throttle, 0.0)
        brake_lo = c_b * brake_state * -vel
        low_speed = torch.abs(vel) <= 0.2
        throttle = torch.where(low_speed, throttle_lo, throttle_hi)
        brake_f = torch.where(low_speed, brake_lo, brake_hi)

        vel_d = (torch.where(enable_brake, 0.0, 1.0) * throttle * self.gear_sign
                 + brake_f - c_v * vel + self.c_0)
        vel_d = torch.clamp(vel_d, -self.clamp_ax, self.clamp_ax)
        vel_d = vel_d - torch.where(torch.abs(pitch) < math_utils.HALF_PI,
                                    self.gravity * torch.sin(pitch), 0.0)
        yaw_d = self._yaw_rate(vel, steer)
        x_d = vel * torch.cos(yaw)
        y_d = vel * torch.sin(yaw)
        brake_d = self._brake_deriv(throttle_brake, brake_raw)
        steer_d = self._steer_deriv(x, u)
        zero = torch.zeros_like(vel_d)
        return torch.stack([vel_d, yaw_d, x_d, y_d, steer_d, brake_d, zero, zero, zero])

    def _settle(self, pos_x, pos_y, yaw, roll, pitch):
        return static_settling(self.elevation_map, pos_x, pos_y, yaw, roll, pitch)

    def _integrate(self, x, xdot, steer_d, dt):
        """The Euler update with the wrap and clamps, then settling with the
        new position and yaw and the old roll and pitch: (x_next, height)."""
        x_next = x + xdot * dt
        yaw = math_utils.normalize_angle(x_next[1])
        steer, brake = self._clamp_steer_brake(x_next[4], x_next[5])
        roll, pitch, height = self._settle(x_next[2], x_next[3], yaw, x[7], x[8])
        return torch.stack([x_next[0], yaw, x_next[2], x_next[3], steer, brake, steer_d,
                            roll, pitch]), height

    @staticmethod
    def _output(x_next, xdot, steer_d, height):
        """[vel_b_x, vel_b_y, pos_x, pos_y, pos_z, yaw, roll, pitch, steer_angle,
        steer_angle_rate, accel_x, omega_z, |v|]."""
        return torch.stack([x_next[0], torch.zeros_like(x_next[0]), x_next[2], x_next[3],
                            height, x_next[1], x_next[7], x_next[8], x_next[4], steer_d,
                            xdot[0], xdot[1], torch.abs(x_next[0])])

    def step(self, x, u, t, dt):
        xdot = self.state_deriv(x, u, t)
        x_next, height = self._integrate(x, xdot, xdot[4], dt)
        return x_next, self._output(x_next, xdot, xdot[4], height)

    def state_from_map(self, mapping):
        keys = ["VEL_X", "YAW", "POS_X", "POS_Y", "STEER_ANGLE", "BRAKE_STATE",
                "STEER_ANGLE_RATE", "ROLL", "PITCH"]
        return torch.tensor([mapping.get(k, 0.0) for k in keys], dtype=torch.float32,
                            device=self.params.device)


class RacerDubinsElevationLSTMSteering(RacerDubinsElevationDynamics):
    """The steering rate is the parametric estimate corrected by a
    prediction LSTM over [vel_x, steer_angle, steer_cmd, parametric steer
    rate] (racer_dubins_elevation_lstm_steering.{cuh,cu}); its (h, c) start
    from ``warm_hidden`` / ``warm_cell``, which ``update_from_buffer`` sets
    from the init LSTM (``lstm_lstm``) over the sensor buffer."""

    def __init__(self, lstm: LSTM, elevation_map=None, control_ranges=None,
                 lstm_lstm: LSTMLSTM | None = None, warm_hidden=None, warm_cell=None,
                 device="cpu", **params):
        super().__init__(elevation_map, control_ranges, device=device, **params)
        self.lstm = lstm.to(device)
        self.lstm_lstm = None if lstm_lstm is None else lstm_lstm.to(device)
        H = lstm.hidden_dim
        for name, v in (("warm_hidden", warm_hidden), ("warm_cell", warm_cell)):
            v = np.zeros((H,), np.float32) if v is None else np.asarray(v, np.float32)
            self.register_buffer(name, torch.tensor(v.reshape(H), device=device))

    @classmethod
    def create(cls, lstm=None, elevation_map=None, control_ranges=None, seed=0,
               device="cpu", **params):
        """The reference's steering LSTM (4 -> 16, head 20-16-1), random from
        a numpy ``seed`` at scale 0.1 unless ``lstm`` is given."""
        if lstm is None:
            lstm = LSTM.create(STEER_LSTM[0], STEER_LSTM[1], STEER_LSTM[2], seed=seed)
        return cls(lstm, elevation_map, control_ranges, device=device, **params)

    @property
    def requires_buffer(self) -> bool:
        return self.lstm_lstm is not None

    def update_from_buffer(self, buffer):
        """Warm-start the rollout LSTM from the time-synchronized sensor
        buffer (LSTMLSTMHelper::initializeLSTM). Updates the warm state in
        place and returns the model."""
        if self.lstm_lstm is not None:
            h0, c0 = self.lstm_lstm.initialize(buffer)
            self.warm_hidden.copy_(h0)
            self.warm_cell.copy_(c0)
            self.__dict__.pop("_table", None)
        return self

    def init_recurrent_state(self):
        return (self.warm_hidden, self.warm_cell)

    def _step_lstm(self, x, rec, u, t, dt, lstm_forward):
        h, c = rec
        steer_d_param = self._steer_deriv(x, u)
        feats = torch.stack([x[0], x[4], u[1], steer_d_param])
        delta, h, c = lstm_forward(h, c, feats)
        steer_d = steer_d_param + delta[0]
        xdot = self.state_deriv(x, u, t)
        xdot = torch.cat([xdot[:4], steer_d[None], xdot[5:]], dim=0)
        x_next, height = self._integrate(x, xdot, steer_d, dt)
        return x_next, self._output(x_next, xdot, steer_d, height), (h, c)

    def step_recurrent(self, x, rec, u, t, dt):
        return self._step_lstm(x, rec, u, t, dt, self.lstm.forward_axis0)

    def kernel_step_recurrent(self, x, rec, u, t, dt):
        return self._step_lstm(x, rec, u, t, dt, self.lstm.forward_axis0_plain)

    def step(self, x, u, t, dt):
        """One step from the warm (h, c), as the JAX model's stateless step
        (the plant's step, and each step of RMPPI's eager augmented
        rollout): of one state (S,), or of a batch (S, K), each column from
        the warm state."""
        rec = self.init_recurrent_state()
        if x.dim() > 1:
            rec = broadcast_rec(rec, x.shape[1])
        x_next, y, _ = self.step_recurrent(x, rec, u, t, dt)
        return x_next, y

    def _lstm_check(self, lstm, want, what):
        got = (lstm.input_dim, lstm.hidden_dim,
               None if lstm.output_nn is None else lstm.output_nn.layers)
        if got != (want[0], want[1], tuple(want[2])):
            raise NotImplementedError(
                f"the CUDA kernels are compiled for the {what} LSTM {want}, not {got}")

    def _kernel_table(self):
        """The table csrc/racer_lstm_steering.cuh stages: ``params``, the map
        block, the LSTM's table, the warm (h, c)."""
        self._lstm_check(self.lstm, STEER_LSTM, "steering")
        return torch.cat([self.params, self.map_meta, self.lstm.kernel_table(),
                          self.warm_hidden, self.warm_cell])
