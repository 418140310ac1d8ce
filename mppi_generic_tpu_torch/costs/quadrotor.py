"""Quadrotor costs, in PyTorch.

Counterpart of ``mppi_generic_tpu/costs/quadrotor.py``:

* ``QuadrotorQuadraticCost`` (reference quadrotor_quadratic_cost.cu): the
  squared position, velocity and angular-rate errors to a 13-dim goal, and
  the roll, pitch and yaw of the quaternion difference q_goal^-1 (x) q from
  the polynomial ``atan2_approx`` / ``asin_approx``; terminal cost
  ``terminal_cost_coeff`` times the state cost.
* ``QuadrotorMapCost`` (reference quadrotor_map_cost.cu:95-408): a
  ``MapTexture2D`` costmap query at (x, y, z) with the off-map and
  track-boundary crash penalties, the gate side-post collision band, the
  height interpolated between the previous and the current waypoint, the
  heading to the waypoint, speed tracking, attitude level-ness, the
  distance-to-waypoint term, the gate-pass reward and the sticky
  crash * crash_coeff; ``update_waypoint`` / ``update_gate_boundaries``
  return an updated cost module.

Both saturate a NaN or a cost above MAX_COST_VALUE (1e16) to 1e16. Squares
are written as ``x * x`` and sums run left to right. The CUDA kernels carry
the same costs in ``csrc/quadrotor_quadratic_cost.cuh`` and
``csrc/quadrotor_map_cost.cuh``; they read the packed ``params`` buffers
laid out by ``PARAM_NAMES`` (the map cost's followed by the int32 words
[flags, H, W, offset, stride] and the map's origin, rotation rows and
resolution, as the AutoRally cost's).
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.costs.base import Cost
from mppi_generic_tpu_torch.maps.texture import MapTexture2D
from mppi_generic_tpu_torch.utils import math_utils as mu

MAX_COST_VALUE = 1e16


def _saturate(cost):
    return torch.where(torch.isnan(cost) | (cost > MAX_COST_VALUE), MAX_COST_VALUE, cost)


def _sq(d):
    return d * d


def _euler_of(qw, qx, qy, qz):
    """(roll, pitch, yaw) of a quaternion by the polynomial atan2 / asin
    (Quat2EulerNWU)."""
    r = mu.atan2_approx(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
    p = mu.asin_approx(2 * (qw * qy - qz * qx))
    yw = mu.atan2_approx(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    return r, p, yw


class QuadrotorQuadraticCost(Cost):
    CONTROL_DIM = 4
    OUTPUT_DIM = 13

    # the packed table after the 13-dim goal [x(3), v(3), q(4), w(3)]
    PARAM_NAMES = ("x_coeff", "v_coeff", "roll_coeff", "pitch_coeff", "yaw_coeff",
                   "w_coeff", "terminal_cost_coeff")

    def __init__(self, s_goal=None, x_coeff=1.0, v_coeff=1.0, roll_coeff=1.0,
                 pitch_coeff=1.0, yaw_coeff=1.0, w_coeff=1.0, terminal_cost_coeff=0.0,
                 device="cpu"):
        super().__init__()
        if s_goal is None:
            s_goal = np.zeros((13,), np.float32)
            s_goal[6] = 1.0
        table = np.concatenate([
            np.asarray(s_goal, np.float32).reshape(13),
            np.asarray([x_coeff, v_coeff, roll_coeff, pitch_coeff, yaw_coeff, w_coeff,
                        terminal_cost_coeff], np.float32)])
        self.register_buffer("params", torch.tensor(table, device=device))

    @property
    def s_goal(self):
        return self.params[:13]

    def __getattr__(self, name):
        if name in QuadrotorQuadraticCost.PARAM_NAMES:
            return self.params[13 + QuadrotorQuadraticCost.PARAM_NAMES.index(name)]
        return super().__getattr__(name)

    def _attitude_cost(self, y):
        """Roll, pitch and yaw of q_diff = conj(q_goal) (x) q (QuatSubtract +
        Quat2EulerNWU, quadrotor_quadratic_cost.cu:24-45), unit goal."""
        qw, qx, qy, qz = y[6], y[7], y[8], y[9]
        g = self.params
        aw, ax, ay, az = g[6], -g[7], -g[8], -g[9]
        dw = aw * qw - ax * qx - ay * qy - az * qz
        dx = aw * qx + ax * qw + ay * qz - az * qy
        dy = aw * qy - ax * qz + ay * qw + az * qx
        dz = aw * qz + ax * qy - ay * qx + az * qw
        r, p, yw = _euler_of(dw, dx, dy, dz)
        return (self.roll_coeff * (r * r) + self.pitch_coeff * (p * p)
                + self.yaw_coeff * (yw * yw))

    def time_parallel_cost(self) -> bool:
        # crash is never read or set; t is unused; every term is elementwise
        return True

    def state_cost(self, y, t, crash):
        g = self.params
        pos = _sq(y[0] - g[0]) + _sq(y[1] - g[1]) + _sq(y[2] - g[2])
        vel = _sq(y[3] - g[3]) + _sq(y[4] - g[4]) + _sq(y[5] - g[5])
        ang = _sq(y[10] - g[10]) + _sq(y[11] - g[11]) + _sq(y[12] - g[12])
        cost = (self.x_coeff * pos + self.v_coeff * vel + self._attitude_cost(y)
                + self.w_coeff * ang)
        return _saturate(cost), crash

    def terminal_cost(self, y):
        c, _ = self.state_cost(y, 0, 0)
        return self.terminal_cost_coeff * c


# (name, size, default) of the map cost's table, in the kernels' order
_MAP_FIELDS = (
    ("curr_waypoint", 4, (0.0, 0.0, 0.0, 0.0)),
    ("prev_waypoint", 4, (0.0, 0.0, 0.0, 0.0)),
    ("end_waypoint", 4, (np.nan,) * 4),
    ("curr_gate_left", 3, (0.0, 0.0, 0.0)),
    ("curr_gate_right", 3, (0.0, 0.0, 0.0)),
    ("prev_gate_left", 3, (0.0, 0.0, 0.0)),
    ("prev_gate_right", 3, (0.0, 0.0, 0.0)),
    ("attitude_coeff", 1, 10.0),
    ("crash_coeff", 1, 1000.0),
    ("dist_to_waypoint_coeff", 1, 0.0),
    ("heading_coeff", 1, 5.0),
    ("heading_power", 1, 1.0),
    ("height_coeff", 1, 5.0),
    ("track_coeff", 1, 10.0),
    ("speed_coeff", 1, 5.0),
    ("track_slop", 1, 0.0),
    ("gate_pass_cost", 1, -150.0),
    ("desired_speed", 1, 5.0),
    ("gate_margin", 1, 0.5),
    ("min_dist_to_gate_side", 1, 0.5),
    ("track_boundary_cost", 1, 2.5),
    ("gate_width", 1, 2.15),
)
FLAG_MAP = 1  # the flags word: a costmap is given


# name -> (offset, size) in the table
_MAP_SLOTS = {name: (int(sum(f[1] for f in _MAP_FIELDS[:i])), size)
              for i, (name, size, _) in enumerate(_MAP_FIELDS)}


class QuadrotorMapCost(Cost):
    CONTROL_DIM = 4
    OUTPUT_DIM = 13

    PARAM_NAMES = tuple(name for name, _, _ in _MAP_FIELDS)
    NUM_VALUES = sum(size for _, size, _ in _MAP_FIELDS)

    def __init__(self, costmap: MapTexture2D | None = None, device="cpu", **values):
        super().__init__()
        unknown = set(values) - set(self.PARAM_NAMES)
        if unknown:
            raise TypeError(f"unknown QuadrotorMapCost fields {sorted(unknown)}")
        self.costmap = None if costmap is None else costmap.to(device)
        table = np.concatenate([
            np.asarray(values.get(name, default), np.float32).reshape(size)
            for name, size, default in _MAP_FIELDS])
        if costmap is None:
            words, geometry = [0, 0, 0, 0], np.zeros((15,), np.float32)
        else:
            words, geometry = costmap.kernel_meta(0)
            geometry = geometry.cpu().numpy()
        words = np.array([FLAG_MAP * (costmap is not None), *words], np.int64)
        if words.max() >= 2**31:
            raise ValueError("the map is too large for the kernels' int32 indices")
        table = np.concatenate([table, words.astype(np.int32).view(np.float32), geometry])
        self.register_buffer("params", torch.tensor(table, device=device))

    def __getattr__(self, name):
        slot = _MAP_SLOTS.get(name)
        if slot is not None:
            i, n = slot
            return self.params[i] if n == 1 else self.params[i:i + n]
        return super().__getattr__(name)

    def _values(self) -> dict:
        """The table's fields as float32 numpy arrays (host side)."""
        flat = self.params[:self.NUM_VALUES].detach().cpu().numpy()
        return {name: flat[i:i + n].copy() if n > 1 else flat[i].copy()
                for name, (i, n) in _MAP_SLOTS.items()}

    def replace(self, **changes) -> "QuadrotorMapCost":
        """A new cost with the given fields changed, on the same device,
        sharing the costmap."""
        values = {**self._values(), **changes}
        return QuadrotorMapCost(costmap=self.costmap, device=self.params.device, **values)

    # --- waypoint machinery (QuadrotorMapCostParams, quadrotor_map_cost.cuh:62-92)
    def update_waypoint(self, x, y, z, heading=0.0) -> "QuadrotorMapCost":
        """A new cost with ``curr_waypoint`` = (x, y, z, heading): the current
        waypoint becomes ``prev_waypoint`` and the gate posts move to
        +-gate_width along the heading. Unchanged (a copy) when the waypoint
        is the current one."""
        v = self._values()
        new = np.asarray([x, y, z, heading], np.float32)
        if not np.any(new != v["curr_waypoint"]):
            return self.replace()
        h, gw = torch.tensor(new[3]), torch.tensor(v["gate_width"])
        c, s = float(torch.cos(h) * gw), float(torch.sin(h) * gw)
        f32 = np.float32
        left = np.asarray([new[0] + f32(c), new[1] + f32(s), new[2]], np.float32)
        right = np.asarray([new[0] - f32(c), new[1] - f32(s), new[2]], np.float32)
        return self.replace(curr_waypoint=new, prev_waypoint=v["curr_waypoint"]
                            ).update_gate_boundaries(left, right)

    def update_gate_boundaries(self, left, right) -> "QuadrotorMapCost":
        """A new cost with the gate posts at ``left`` / ``right``; the old
        current posts become the previous ones iff a post moved."""
        v = self._values()
        left, right = np.asarray(left, np.float32), np.asarray(right, np.float32)
        if not (np.any(left != v["curr_gate_left"]) or np.any(right != v["curr_gate_right"])):
            return self.replace()
        return self.replace(curr_gate_left=left, curr_gate_right=right,
                            prev_gate_left=v["curr_gate_left"],
                            prev_gate_right=v["curr_gate_right"])

    def kernel_map(self):
        """The map data the kernels read (None without a costmap)."""
        return None if self.costmap is None else self.costmap.data

    # --- cost terms (quadrotor_map_cost.cu) ------------------------------
    def dist_to_waypoint(self, y, wp):
        """3D distance to a (4,) waypoint (distToWaypoint, :151-158)."""
        return torch.sqrt(_sq(y[0] - wp[0]) + _sq(y[1] - wp[1]) + _sq(y[2] - wp[2]))

    def _stabilizing_cost(self, y):
        roll, pitch, _ = _euler_of(y[6], y[7], y[8], y[9])
        return self.attitude_coeff * (roll * roll + pitch * pitch)

    def _heading_cost(self, y, dist):
        """The velocity rotated by the attitude DCM pointed at the waypoint,
        outside the gate margin (computeHeadingCost, :212-241)."""
        qw, qx, qy, qz = y[6], y[7], y[8], y[9]
        vx, vy, vz = y[3], y[4], y[5]
        wvx = ((1 - 2 * (qy * qy + qz * qz)) * vx + 2 * (qx * qy - qw * qz) * vy
               + 2 * (qx * qz + qw * qy) * vz)
        wvy = (2 * (qx * qy + qw * qz) * vx + (1 - 2 * (qx * qx + qz * qz)) * vy
               + 2 * (qy * qz - qw * qx) * vz)
        yaw = mu.atan2_approx(wvy, wvx)
        wp = self.curr_waypoint
        w_heading = mu.atan2_approx(wp[1] - y[1], wp[0] - y[0])
        ang = torch.abs(mu.angle_diff(yaw, w_heading))
        c = self.heading_coeff * torch.pow(ang, self.heading_power)
        return torch.where(dist > self.gate_margin, c, 0.0)

    def _speed_cost(self, y):
        speed = torch.sqrt(y[3] * y[3] + y[4] * y[4])
        return self.speed_coeff * _sq(speed - self.desired_speed)

    def _waypoint_cost(self, dist):
        return self.dist_to_waypoint_coeff * dist * dist

    def _gate_side_cost(self, y):
        """crash_coeff |comp| within min_dist_to_gate_side of the gate line
        and in the half-gate band outside either post (:276-323)."""
        gl, gr = self.curr_gate_left, self.curr_gate_right
        gvx, gvy = gl[0] - gr[0], gl[1] - gr[1]
        svx, svy = y[0] - gr[0], y[1] - gr[1]
        perp = svx * gvy - svy * gvx
        denom = gvx * gvx + gvy * gvy + 1e-12
        comp = (svx * gvx + svy * gvy) / denom
        threshold = 0.5
        hit = (torch.abs(perp) < self.min_dist_to_gate_side) & (
            ((comp < 0.0) & (comp >= -threshold))
            | ((comp > 1.0) & (comp <= 1.0 + threshold)))
        return torch.where(hit, self.crash_coeff * torch.abs(comp), 0.0)

    def _height_cost(self, y):
        """The height between the previous and the current waypoint by
        inverse xy-distance weights; +400 past gate_width (:326-358)."""
        pw, cw = self.prev_waypoint, self.curr_waypoint
        d1 = torch.sqrt(_sq(y[0] - pw[0]) + _sq(y[1] - pw[1]))
        d2 = torch.sqrt(_sq(y[0] - cw[0]) + _sq(y[1] - cw[1]))
        w1 = d1 / (d1 + d2 + 0.001)
        w2 = d2 / (d1 + d2 + 0.001)
        interp = (1.0 - w1) * pw[2] + (1.0 - w2) * cw[2]
        hd = _sq(y[2] - interp)
        return self.height_coeff * hd + torch.where(hd > self.gate_width, 400.0, 0.0)

    def _costmap_cost(self, y):
        """Off-map crash_coeff; the map value above track_slop times
        track_coeff; crash_coeff above track_boundary_cost (:361-396). The
        map is queried at (x, y, z), channel 0 of a multichannel map."""
        if self.costmap is None:
            return torch.zeros_like(y[0])
        u, v = self.costmap.world_to_tex_components(y[0], y[1], y[2])
        off_map = (u < 0.0) | (u > 1.0) | (v < 0.0) | (v > 1.0)
        track = self.costmap.query_tex_channel(u, v, 0)
        cost = torch.where(off_map, self.crash_coeff, 0.0)
        cost = cost + torch.where(track > self.track_slop, self.track_coeff * track, 0.0)
        return cost + torch.where(track > self.track_boundary_cost, self.crash_coeff, 0.0)

    def state_cost(self, y, t, crash):
        """computeStateCost (:95-149)."""
        dist = self.dist_to_waypoint(y, self.curr_waypoint)
        gate_cost = self._gate_side_cost(y)
        cost = (self._costmap_cost(y) + gate_cost + self._height_cost(y)
                + self._heading_cost(y, dist) + self._speed_cost(y)
                + self._stabilizing_cost(y) + self._waypoint_cost(dist))
        cost = cost + torch.where(dist < self.gate_margin, self.gate_pass_cost, 0.0)
        crash = torch.where(gate_cost != 0.0, torch.ones_like(crash), crash)
        cost = cost + crash.to(torch.float32) * self.crash_coeff
        return _saturate(cost), crash

    def terminal_cost(self, y):
        """terminalCost == 0 (:398-408)."""
        return torch.zeros_like(y[0])
