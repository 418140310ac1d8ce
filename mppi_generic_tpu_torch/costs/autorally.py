"""AutoRally costs (track costmap + speed, slip and crash terms), in PyTorch.

Counterpart of ``ARStandardCost`` and ``ARRobustCost`` in
``mppi_generic_tpu/costs/autorally.py`` (ar_standard_cost.cu:282-413,
ar_robust_cost.cu), term for term:

* track: the mean |costmap| under the car's front (+0.5 m) and back
  (-0.5 m) points along the heading, zeroed inside ``track_slop`` (the
  robust cost shapes it into a quadratic barrier instead); crash when either
  point reaches ``boundary_threshold``. Multichannel maps read channel 0,
  as the reference reads .x of its float4 costmap; without a costmap the
  track reads zero everywhere;
* speed: speed_coeff (v_x - desired)^2, or |.| with ``l1_speed_cost``;
* stabilizing: slip_coeff slip^2 with slip = -atan(v_y / |v_x|) (the
  polynomial ``atan_full_approx``), plus crash_coeff past ``max_slip_ang``;
  a roll past pi / 2 sets the crash flag;
* crash: discount^t crash_coeff once crashed (the flag is sticky);
* the sum saturated at MAX_COST_VALUE (1e16) and NaN-guarded.

``output_indices`` name the (x, y, yaw, roll, v_x, v_y) entries of the
dynamics' output. The CUDA kernels carry the same cost in
``csrc/ar_standard_cost.cuh`` (both variants, the indices a template
argument: each kernel entry is compiled for its model's layout, AutoRally's
(0, 1, 2, 3, 4, 5), the bicycle-slip model's (0, 1, 2, 8, 5, 6) or the racer
models' (2, 3, 5, 6, 0, 1), and refuses another); they read the packed ``params`` table: the values of
``PARAM_NAMES``, then int32 words [flags, H, W, offset, stride] and the map's
origin, rotation rows and resolution (``csrc/ar_standard_cost.cuh``
``load``).
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.costs.base import Cost
from mppi_generic_tpu_torch.maps.texture import MapTexture2D
from mppi_generic_tpu_torch.utils import math_utils

MAX_COST_VALUE = 1e16
FRONT_D = 0.5
BACK_D = -0.5
DEFAULT_OUTPUT_INDICES = (0, 1, 2, 3, 4, 5)
# bits of the flags word of the kernels' table
FLAG_L1, FLAG_ROBUST, FLAG_MAP = 1, 2, 4


class ARStandardCost(Cost):
    CONTROL_DIM = 2
    OUTPUT_DIM = 7
    ROBUST = False

    PARAM_NAMES = (
        "desired_speed",
        "speed_coeff",
        "track_coeff",
        "max_slip_ang",
        "slip_coeff",
        "track_slop",
        "crash_coeff",
        "boundary_threshold",
        "discount",
    )

    def __init__(self, desired_speed=6.0, speed_coeff=4.25, track_coeff=200.0,
                 max_slip_ang=1.25, slip_coeff=10.0, track_slop=0.0,
                 crash_coeff=10000.0, boundary_threshold=0.65, discount=1.0,
                 l1_speed_cost=False, output_indices=DEFAULT_OUTPUT_INDICES,
                 costmap: MapTexture2D | None = None, device="cpu"):
        super().__init__()
        self.l1_speed_cost = bool(l1_speed_cost)
        self.output_indices = tuple(int(i) for i in output_indices)
        self.costmap = None if costmap is None else costmap.to(device)
        values = np.array([desired_speed, speed_coeff, track_coeff, max_slip_ang,
                           slip_coeff, track_slop, crash_coeff, boundary_threshold,
                           discount], np.float32)
        flags = (FLAG_L1 * self.l1_speed_cost + FLAG_ROBUST * self.ROBUST
                 + FLAG_MAP * (costmap is not None))
        if costmap is None:
            words, geometry = [0, 0, 0, 0], np.zeros((15,), np.float32)
        else:
            words, geometry = costmap.kernel_meta(0)
            geometry = geometry.cpu().numpy()
        words = np.array([flags, *words], np.int64)
        if words.max() >= 2**31:
            raise ValueError("the map is too large for the kernels' int32 indices")
        table = np.concatenate([values, words.astype(np.int32).view(np.float32),
                                geometry])
        self.register_buffer("params", torch.tensor(table, device=device))

    def __getattr__(self, name):
        if name in ARStandardCost.PARAM_NAMES:
            return self.params[ARStandardCost.PARAM_NAMES.index(name)]
        return super().__getattr__(name)

    def kernel_map(self):
        """The map data the kernels read (None without a costmap); the
        kernel wrappers check ``output_indices`` against their entry's."""
        return None if self.costmap is None else self.costmap.data

    def time_parallel_crash(self) -> bool:
        # the boundary and rollover triggers are functions of y alone, joined
        # to the status by where(cond, 1, crash); the value reads only the
        # current flag (inherited by ARRobustCost, as in JAX)
        return True

    def _o(self, y, name):
        i = ("x", "y", "yaw", "roll", "vx", "vy").index(name)
        return y[self.output_indices[i]]

    def _track_value(self, x, y):
        if self.costmap is None:
            return torch.zeros_like(x)
        return self.costmap.query_world_components_channel(x, y, 0)

    def _track_query(self, y, crash):
        """Front/back costmap samples and the boundary crash flag."""
        yaw = self._o(y, "yaw")
        px, py = self._o(y, "x"), self._o(y, "y")
        cos_y, sin_y = torch.cos(yaw), torch.sin(yaw)
        front = self._track_value(px + FRONT_D * cos_y, py + FRONT_D * sin_y)
        back = self._track_value(px + BACK_D * cos_y, py + BACK_D * sin_y)
        track = 0.5 * (torch.abs(front) + torch.abs(back))
        hit = (front >= self.boundary_threshold) | (back >= self.boundary_threshold)
        return track, torch.where(hit, torch.ones_like(crash), crash)

    def _track_cost(self, y, crash):
        track, crash = self._track_query(y, crash)
        track = torch.where(torch.abs(track) < self.track_slop, 0.0,
                            self.track_coeff * track)
        return track, crash

    def _speed_cost(self, y):
        err = self._o(y, "vx") - self.desired_speed
        if self.l1_speed_cost:
            return self.speed_coeff * torch.abs(err)
        return self.speed_coeff * err * err

    def _stabilizing_cost(self, y, crash):
        vx, vy = self._o(y, "vx"), self._o(y, "vy")
        slip = -math_utils.atan_full_approx(vy / torch.clamp_min(torch.abs(vx), 1e-3))
        moving = torch.abs(vx) > 0.001
        cost = torch.where(moving, self.slip_coeff * slip * slip, 0.0)
        cost = cost + torch.where(moving & (torch.abs(slip) > self.max_slip_ang),
                                  self.crash_coeff, 0.0)
        rolled = torch.abs(self._o(y, "roll")) > math_utils.HALF_PI
        return cost, torch.where(rolled, torch.ones_like(crash), crash)

    def state_cost(self, y, t, crash):
        track, crash = self._track_cost(y, crash)
        speed = self._speed_cost(y)
        stab, crash = self._stabilizing_cost(y, crash)
        crash_cost = torch.where(
            crash > 0, math_utils.discount_pow(self.discount, t) * self.crash_coeff, 0.0)
        cost = speed + crash_cost + track + stab
        cost = torch.where(torch.isnan(cost) | (cost > MAX_COST_VALUE),
                           MAX_COST_VALUE, cost)
        return cost, crash

    def terminal_cost(self, y):
        return torch.zeros_like(y[0])


class ARRobustCost(ARStandardCost):
    """The robust variant (ar_robust_cost.cu): the costmap value is shaped
    into a quadratic barrier normalized by the boundary threshold."""

    ROBUST = True

    def _track_cost(self, y, crash):
        track, crash = self._track_query(y, crash)
        d = track / torch.clamp_min(self.boundary_threshold, 1e-6)
        return self.track_coeff * 0.5 * d * d, crash
