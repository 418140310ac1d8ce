// AutoRally costs (standard and robust) for the rollout and solve kernels.
//
// Device twin of ARStandardCost.state_cost / ARRobustCost in
// mppi_generic_tpu_torch/costs/autorally.py (ar_standard_cost.cu:282-413,
// ar_robust_cost.cu), the same operations in the same order: the track term
// from two map queries (map_texture.cuh) under the car's front and back
// points, the boundary crash, the speed term (L2 or L1), the slip term with
// the polynomial atan, the rollover crash, the sticky crash cost
// discount^t crash_coeff = expf(t logf(discount)) crash_coeff, the sum
// ((speed + crash) + track) + stabilizing, saturated at 1e16 and NaN-guarded.
// The six entries (x, y, yaw, roll, v_x, v_y) of the dynamics' output the
// cost reads are template arguments, the cost's output_indices: ARCost reads
// AutoRally's [x, y, yaw, roll, v_x, v_y, yaw_rate] (0, 1, 2, 3, 4, 5),
// ARCostBicycle the bicycle-slip state (0, 1, 2, 8, 5, 6), ARCostRacer the
// racer models' output (2, 3, 5, 6, 0, 1), ARCostSuspension the
// full-suspension racer's (0, 1, 5, 6, 3, 4). Compile-time
// indices keep the output in registers; the wrappers refuse an entry whose
// indices differ from the cost's.
//
// The parameters arrive as the cost's packed `params` table: the nine values
// of PARAM_NAMES, then int32 words [flags, H, W, offset, stride] and the map's
// origin (3), rotation rows (9) and resolution (3); the map data pointer comes
// apart (null without a costmap).
#pragma once

#include <math.h>

#include "map_texture.cuh"
#include "math_utils.cuh"

template <int IX, int IY, int IYAW, int IROLL, int IVX, int IVY>
struct ARCostT {
  static constexpr int kL1 = 1, kRobust = 2, kMap = 4;  // flag bits
  static constexpr int kNumParams = 9 + 5 + 15;
  // the crash flag is sticky-prefix: the boundary and rollover triggers are
  // functions of y alone, and the value reads only the current flag (the
  // split cost pass evaluates it at crash 0 and 1, split_kernels.cuh)
  static constexpr bool kStickyCrash = true;

  struct Params {
    float desired_speed, speed_coeff, track_coeff, max_slip_ang, slip_coeff,
        track_slop, crash_coeff, boundary_threshold, discount;
    int flags;
    MapTex map;
  };

  __device__ static inline Params load(const float* p, const float* map) {
    Params q;
    q.desired_speed = p[0];
    q.speed_coeff = p[1];
    q.track_coeff = p[2];
    q.max_slip_ang = p[3];
    q.slip_coeff = p[4];
    q.track_slop = p[5];
    q.crash_coeff = p[6];
    q.boundary_threshold = p[7];
    q.discount = p[8];
    q.flags = __float_as_int(p[9]);
    q.map.data = map;
    q.map.H = __float_as_int(p[10]);
    q.map.W = __float_as_int(p[11]);
    q.map.offset = __float_as_int(p[12]);
    q.map.stride = __float_as_int(p[13]);
#pragma unroll
    for (int i = 0; i < 3; ++i) q.map.origin[i] = p[14 + i];
#pragma unroll
    for (int i = 0; i < 9; ++i) q.map.rot[i] = p[17 + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) q.map.res[i] = p[26 + i];
    return q;
  }

  __device__ static inline float running_cost(const Params& q, const float* y,
                                              const float* /*u*/, int t,
                                              int* crash) {
    // track: the costmap under the front and back points
    const float cos_y = cosf(y[IYAW]);
    const float sin_y = sinf(y[IYAW]);
    float front = 0.0f;
    float back = 0.0f;
    if (q.flags & kMap) {
      front = map_query_world(q.map, y[IX] + 0.5f * cos_y, y[IY] + 0.5f * sin_y);
      back = map_query_world(q.map, y[IX] + -0.5f * cos_y, y[IY] + -0.5f * sin_y);
    }
    const float track = 0.5f * (fabsf(front) + fabsf(back));
    if (front >= q.boundary_threshold || back >= q.boundary_threshold) *crash = 1;
    float track_cost;
    if (q.flags & kRobust) {
      const float d =
          track / fmaxf(q.boundary_threshold, static_cast<float>(1e-6));
      track_cost = q.track_coeff * 0.5f * d * d;
    } else {
      track_cost = fabsf(track) < q.track_slop ? 0.0f : q.track_coeff * track;
    }
    // speed
    const float err = y[IVX] - q.desired_speed;
    const float speed = (q.flags & kL1) ? q.speed_coeff * fabsf(err)
                                        : q.speed_coeff * err * err;
    // stabilizing: slip and rollover
    const float slip =
        -atan_full_approx(y[IVY] / fmaxf(fabsf(y[IVX]), static_cast<float>(1e-3)));
    const bool moving = fabsf(y[IVX]) > static_cast<float>(0.001);
    float stab = moving ? q.slip_coeff * slip * slip : 0.0f;
    stab = stab + ((moving && fabsf(slip) > q.max_slip_ang) ? q.crash_coeff : 0.0f);
    if (fabsf(y[IROLL]) > kHalfPi) *crash = 1;
    // sticky crash
    const float crash_cost =
        *crash > 0
            ? expf(static_cast<float>(t) * logf(q.discount)) * q.crash_coeff
            : 0.0f;
    float cost = speed + crash_cost + track_cost + stab;
    if (isnan(cost) || cost > static_cast<float>(1e16)) {
      cost = static_cast<float>(1e16);
    }
    return cost;
  }

  __device__ static inline float terminal_cost(const Params& /*q*/,
                                               const float* /*y*/) {
    return 0.0f;
  }
};

using ARCost = ARCostT<0, 1, 2, 3, 4, 5>;         // AutoRally's output
using ARCostBicycle = ARCostT<0, 1, 2, 8, 5, 6>;  // the bicycle-slip state
using ARCostRacer = ARCostT<2, 3, 5, 6, 0, 1>;    // the racer models' output
// the layout the JAX package's kernel test of RacerSuspensionDynamics reads
// (tests/test_suspension_models.py:181)
using ARCostSuspension = ARCostT<0, 1, 5, 6, 3, 4>;
