// Quadrotor map and waypoint cost for the rollout and sampling kernels.
//
// Device twin of QuadrotorMapCost in mppi_generic_tpu_torch/costs/quadrotor.py
// (the JAX package's costs/quadrotor.py:96-367, reference
// quadrotor_map_cost.cu:95-408), term for term and in the same order: the
// costmap at (x, y, z) through the in-kernel map query (map_texture.cuh, B9,
// channel 0) with the off-map and track-boundary crash penalties; the gate
// side-post collision band, which sets the sticky crash flag; the height
// interpolated between the previous and the current waypoint; the heading of
// the attitude-rotated velocity to the waypoint (powf, as torch.pow); speed
// tracking; attitude level-ness; the distance-to-waypoint term; the gate-pass
// reward; crash * crash_coeff; a NaN or a cost above 1e16 saturates to 1e16.
// The terminal cost is 0.
//
// The packed `params` table (QuadrotorMapCost.PARAM_NAMES): curr, prev and
// end waypoints (4 each), the current and previous gate posts (3 each), the
// 15 coefficients; then int32 words [flags, H, W, offset, stride] and the
// map's origin, rotation rows and resolution; the map data pointer comes
// apart (null without a costmap).
#pragma once

#include <math.h>

#include "map_texture.cuh"
#include "math_utils.cuh"
#include "quadrotor_quadratic_cost.cuh"

struct QuadrotorMapCost {
  static constexpr int kFlagMap = 1;

  struct Params {
    float curr_wp[4], prev_wp[4];
    float gate_left[3], gate_right[3];
    float attitude_coeff, crash_coeff, dist_coeff, heading_coeff,
        heading_power, height_coeff, track_coeff, speed_coeff, track_slop,
        gate_pass_cost, desired_speed, gate_margin, min_dist_to_gate_side,
        track_boundary_cost, gate_width;
    int flags;
    MapTex map;
  };

  __device__ static inline Params load(const float* p, const float* map) {
    Params q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q.curr_wp[i] = p[i];
      q.prev_wp[i] = p[4 + i];
    }
    // p[8..11]: the end waypoint, which the device cost does not read
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      q.gate_left[i] = p[12 + i];
      q.gate_right[i] = p[15 + i];
    }
    // p[18..23]: the previous gate posts, which the device cost does not read
    const float* c = p + 24;
    q.attitude_coeff = c[0];
    q.crash_coeff = c[1];
    q.dist_coeff = c[2];
    q.heading_coeff = c[3];
    q.heading_power = c[4];
    q.height_coeff = c[5];
    q.track_coeff = c[6];
    q.speed_coeff = c[7];
    q.track_slop = c[8];
    q.gate_pass_cost = c[9];
    q.desired_speed = c[10];
    q.gate_margin = c[11];
    q.min_dist_to_gate_side = c[12];
    q.track_boundary_cost = c[13];
    q.gate_width = c[14];
    q.flags = __float_as_int(p[39]);
    q.map = load_map_tex(p + 40, map);
    return q;
  }

  __device__ static inline float costmap_cost(const Params& q, const float* y) {
    if (!(q.flags & kFlagMap)) return 0.0f;
    float u, v;
    map_world_to_tex(q.map, y[0], y[1], y[2], &u, &v);
    const bool off_map = (u < 0.0f) || (u > 1.0f) || (v < 0.0f) || (v > 1.0f);
    const float track = map_query_tex(q.map, u, v);
    float cost = off_map ? q.crash_coeff : 0.0f;
    cost = cost + (track > q.track_slop ? q.track_coeff * track : 0.0f);
    return cost + (track > q.track_boundary_cost ? q.crash_coeff : 0.0f);
  }

  __device__ static inline float gate_side_cost(const Params& q, const float* y) {
    const float gvx = q.gate_left[0] - q.gate_right[0];
    const float gvy = q.gate_left[1] - q.gate_right[1];
    const float svx = y[0] - q.gate_right[0];
    const float svy = y[1] - q.gate_right[1];
    const float perp = svx * gvy - svy * gvx;
    const float denom = gvx * gvx + gvy * gvy + static_cast<float>(1e-12);
    const float comp = (svx * gvx + svy * gvy) / denom;
    const bool hit = fabsf(perp) < q.min_dist_to_gate_side &&
                     ((comp < 0.0f && comp >= -0.5f) ||
                      (comp > 1.0f && comp <= 1.5f));
    return hit ? q.crash_coeff * fabsf(comp) : 0.0f;
  }

  __device__ static inline float height_cost(const Params& q, const float* y) {
    const float a0 = y[0] - q.prev_wp[0], a1 = y[1] - q.prev_wp[1];
    const float b0 = y[0] - q.curr_wp[0], b1 = y[1] - q.curr_wp[1];
    const float d1 = sqrtf(a0 * a0 + a1 * a1);
    const float d2 = sqrtf(b0 * b0 + b1 * b1);
    const float w1 = d1 / (d1 + d2 + static_cast<float>(0.001));
    const float w2 = d2 / (d1 + d2 + static_cast<float>(0.001));
    const float interp = (1.0f - w1) * q.prev_wp[2] + (1.0f - w2) * q.curr_wp[2];
    const float e = y[2] - interp;
    const float hd = e * e;
    return q.height_coeff * hd + (hd > q.gate_width ? 400.0f : 0.0f);
  }

  __device__ static inline float heading_cost(const Params& q, const float* y,
                                              float dist) {
    const float qw = y[6], qx = y[7], qy = y[8], qz = y[9];
    const float vx = y[3], vy = y[4], vz = y[5];
    const float wvx = (1.0f - 2.0f * (qy * qy + qz * qz)) * vx +
                      2.0f * (qx * qy - qw * qz) * vy +
                      2.0f * (qx * qz + qw * qy) * vz;
    const float wvy = 2.0f * (qx * qy + qw * qz) * vx +
                      (1.0f - 2.0f * (qx * qx + qz * qz)) * vy +
                      2.0f * (qy * qz - qw * qx) * vz;
    const float yaw = atan2_approx(wvy, wvx);
    const float w_heading =
        atan2_approx(q.curr_wp[1] - y[1], q.curr_wp[0] - y[0]);
    const float ang = fabsf(normalize_angle(yaw - w_heading));
    const float c = q.heading_coeff * powf(ang, q.heading_power);
    return dist > q.gate_margin ? c : 0.0f;
  }

  __device__ static inline float running_cost(const Params& q, const float* y,
                                              const float* /*u*/, int /*t*/,
                                              int* crash) {
    const float e0 = y[0] - q.curr_wp[0];
    const float e1 = y[1] - q.curr_wp[1];
    const float e2 = y[2] - q.curr_wp[2];
    const float dist = sqrtf(e0 * e0 + e1 * e1 + e2 * e2);
    const float gate = gate_side_cost(q, y);
    const float sp = sqrtf(y[3] * y[3] + y[4] * y[4]) - q.desired_speed;
    const float speed = q.speed_coeff * (sp * sp);
    float roll, pitch, yaw;
    quat_euler_approx(y[6], y[7], y[8], y[9], &roll, &pitch, &yaw);
    const float stab = q.attitude_coeff * (roll * roll + pitch * pitch);
    const float waypoint = q.dist_coeff * dist * dist;
    float cost = costmap_cost(q, y) + gate + height_cost(q, y) +
                 heading_cost(q, y, dist) + speed + stab + waypoint;
    cost = cost + (dist < q.gate_margin ? q.gate_pass_cost : 0.0f);
    if (gate != 0.0f) *crash = 1;
    cost = cost + static_cast<float>(*crash) * q.crash_coeff;
    return saturate_cost(cost);
  }

  __device__ static inline float terminal_cost(const Params& /*q*/,
                                               const float* /*y*/) {
    return 0.0f;
  }
};
