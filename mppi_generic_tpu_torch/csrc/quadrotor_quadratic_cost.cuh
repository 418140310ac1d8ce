// Quadrotor quadratic tracking cost for the rollout and sampling kernels.
//
// Device twin of QuadrotorQuadraticCost in
// mppi_generic_tpu_torch/costs/quadrotor.py (the JAX package's
// costs/quadrotor.py:27-93, reference quadrotor_quadratic_cost.cu): the
// squared position, velocity and angular-rate errors to the 13-dim goal, and
// the roll, pitch and yaw of q_diff = conj(q_goal) (x) q from the polynomial
// atan2_approx / asin_approx (math_utils.cuh), weighted and summed left to
// right; a NaN or a cost above 1e16 saturates to 1e16. The terminal cost is
// terminal_cost_coeff times the state cost. The same operations in the same
// order as the PyTorch version. The packed `params` table: the goal (13),
// then x, v, roll, pitch, yaw and w coefficients and terminal_cost_coeff.
#pragma once

#include <math.h>

#include "math_utils.cuh"

// roll, pitch, yaw of a quaternion by the polynomial atan2 / asin
// (Quat2EulerNWU), as costs/quadrotor.py _euler_of
__device__ inline void quat_euler_approx(float qw, float qx, float qy, float qz,
                                         float* r, float* p, float* yw) {
  *r = atan2_approx(2.0f * (qw * qx + qy * qz), 1.0f - 2.0f * (qx * qx + qy * qy));
  *p = asin_approx(2.0f * (qw * qy - qz * qx));
  *yw = atan2_approx(2.0f * (qw * qz + qx * qy), 1.0f - 2.0f * (qy * qy + qz * qz));
}

// NaN or above MAX_COST_VALUE -> MAX_COST_VALUE (1e16)
__device__ inline float saturate_cost(float c) {
  const float kMax = static_cast<float>(1e16);
  return (isnan(c) || c > kMax) ? kMax : c;
}

struct QuadrotorQuadraticCost {
  struct Params {
    float g[13];
    float x_coeff, v_coeff, roll_coeff, pitch_coeff, yaw_coeff, w_coeff,
        terminal;
  };

  __device__ static inline Params load(const float* p, const float* /*map*/) {
    Params q;
#pragma unroll
    for (int i = 0; i < 13; ++i) q.g[i] = p[i];
    q.x_coeff = p[13];
    q.v_coeff = p[14];
    q.roll_coeff = p[15];
    q.pitch_coeff = p[16];
    q.yaw_coeff = p[17];
    q.w_coeff = p[18];
    q.terminal = p[19];
    return q;
  }

  __device__ static inline float sq3(const Params& q, const float* y, int i0) {
    const float d0 = y[i0] - q.g[i0];
    const float d1 = y[i0 + 1] - q.g[i0 + 1];
    const float d2 = y[i0 + 2] - q.g[i0 + 2];
    return d0 * d0 + d1 * d1 + d2 * d2;
  }

  __device__ static inline float state_cost(const Params& q, const float* y) {
    const float pos = sq3(q, y, 0);
    const float vel = sq3(q, y, 3);
    const float ang = sq3(q, y, 10);
    // q_diff = conj(q_goal) (x) q, unit goal
    const float qw = y[6], qx = y[7], qy = y[8], qz = y[9];
    const float aw = q.g[6], ax = -q.g[7], ay = -q.g[8], az = -q.g[9];
    const float dw = aw * qw - ax * qx - ay * qy - az * qz;
    const float dx = aw * qx + ax * qw + ay * qz - az * qy;
    const float dy = aw * qy - ax * qz + ay * qw + az * qx;
    const float dz = aw * qz + ax * qy - ay * qx + az * qw;
    float r, p, yw;
    quat_euler_approx(dw, dx, dy, dz, &r, &p, &yw);
    const float att = q.roll_coeff * (r * r) + q.pitch_coeff * (p * p) +
                      q.yaw_coeff * (yw * yw);
    const float cost = q.x_coeff * pos + q.v_coeff * vel + att + q.w_coeff * ang;
    return saturate_cost(cost);
  }

  __device__ static inline float running_cost(const Params& q, const float* y,
                                              const float* /*u*/, int /*t*/,
                                              int* /*crash*/) {
    return state_cost(q, y);
  }

  __device__ static inline float terminal_cost(const Params& q, const float* y) {
    return q.terminal * state_cost(q, y);
  }
};
