// The bicycle-slip model on an elevation map, with the propagated 4 x 4
// covariance, for the rollout, solve and sampling kernels (their staged
// forms, sample_staged.cuh).
//
// Device twin of BicycleSlipParametricElevation.step in
// mppi_generic_tpu_torch/models/bicycle_slip.py (the JAX package's
// models/bicycle_slip.py:159-338, reference bicycle_slip_parametric.cu:
// 314-374) without a normals map (the wrappers refuse one), the same
// operations in the same order, one rounding each (--fmad=false): 22 states
// (the bicycle's ten, steer_angle_rate, engine_rpm, the ten packed
// covariance entries), control [throttle_brake, steer_cmd], 14 outputs. Per
// step: the slip derivative (BicycleSlip::state_deriv, bicycle_slip.cuh),
// the Euler update with the yaw wrap, the steer and brake clamps and the
// steer rate written back; the bicycle's Jacobian A and the racer models'
// parametric Q (racer::parametric_q, gravity 9.81) into Sigma' = (I + A dt)
// Sigma (I + A dt)^T + Q dt (racer::propagate); roll and pitch from static
// settling on the elevation map (racer::static_settling, four B9 queries)
// with the new position and yaw and the old roll and pitch.
//
// The table (kernel_params): the bicycle's params (23 floats), the normals'
// gravity terms (4, unused here), the feedback gains K (4), the Q
// coefficients (7), the brake limit, then the map block (20): 59 floats; the
// map data comes apart (ModelArgs::dyn_map).
#pragma once

#include <math.h>

#include "bicycle_slip.cuh"
#include "math_utils.cuh"
#include "racer_elevation.cuh"

struct BicycleElevation {
  static constexpr int S = 22;  // state
  static constexpr int C = 2;   // control
  static constexpr int O = 14;  // output
  static constexpr bool kStaged = true;
  static constexpr bool kDynMap = true;
  using B = BicycleSlip;
  enum {
    kGravityX = B::kBrakeMax, kGravityY, kMinNormalX, kMinNormalY, kKvelx, kKx, kKy, kKyaw,
    kQxAcc, kBrakeMax = kQxAcc + 7, kMap, kTable = kMap + racer::kMapBlock
  };

  struct Shared {
    float p[kTable];
    const float* map;
  };

  // every thread of the block; the kernel syncs after
  __device__ static inline void stage(const float* __restrict__ params, const float* map,
                                      Shared* sh) {
    for (int i = threadIdx.x; i < kTable; i += blockDim.x) sh->p[i] = params[i];
    if (threadIdx.x == 0) sh->map = map;
  }

  // A = df/dx + df/du K in (vx, yaw, px, py) order with the bicycle's
  // lateral-velocity position terms (_unc_jacobian), row-major
  __device__ static inline void jacobian(const float* p, const float* x, float* A) {
    const float vel = x[5], vel_y = x[6];
    const float sin_y = sinf(x[2]), cos_y = cosf(x[2]);
    const float cos_d = cosf(x[3] / p[B::kSteerAngleScale]);
    const float cos2_d = cos_d * cos_d;
    const float L = p[B::kWheelBase];
    A[0] = -p[B::kVx] - p[kKvelx] + 0.0f;
    A[1] = 0.0f;
    A[2] = -p[kKx] * cos_y;
    A[3] = -p[kKx] * sin_y;
    A[4] = 0.0f;
    A[5] = -fabsf(vel) * p[kKyaw] / (L * cos2_d);
    A[6] = vel * p[kKy] * sin_y / (L * cos2_d);
    A[7] = -vel * p[kKy] * cos_y / (L * cos2_d);
    A[8] = cos_y + 0.0f;
    A[9] = -sin_y * vel - cos_y * vel_y;
    A[10] = 0.0f;
    A[11] = 0.0f;
    A[12] = sin_y + 0.0f;
    A[13] = cos_y * vel - sin_y * vel_y;
    A[14] = 0.0f;
    A[15] = 0.0f;
  }

  __device__ static inline void step(const Shared& sh, float* x, const float* u,
                                     float /*t*/, float dt, float* y) {
    const float* p = sh.p;
    float xd[B::S];
    B::state_deriv(p, x, u, xd);
    float nxt[B::S];
#pragma unroll
    for (int i = 0; i < B::S; ++i) nxt[i] = x[i] + xd[i] * dt;
    const float engine_rpm = x[11] + 0.0f * dt;
    const float yaw = normalize_angle(nxt[2]);
    const float steer = clamp_nan(nxt[3], -p[B::kMaxSteerAngle], p[B::kMaxSteerAngle]);
    const float brake = min_nan(max_nan(nxt[4], 0.0f), p[kBrakeMax]);

    float A[16], Q[16], unc[10];
    jacobian(p, x, A);
    racer::parametric_q(p + kQxAcc, p[B::kSteerAngleScale], p[B::kWheelBase],
                        static_cast<float>(9.81), x[5], x[2], x[3], x[8], xd[5], Q);
    racer::propagate(x + 12, A, Q, dt, unc);
    float settled[3];  // roll, pitch, height
    racer::static_settling(p + kMap, sh.map, nxt[0], nxt[1], yaw, x[8], x[9], settled);

    x[0] = nxt[0];
    x[1] = nxt[1];
    x[2] = yaw;
    x[3] = steer;
    x[4] = brake;
    x[5] = nxt[5];
    x[6] = nxt[6];
    x[7] = nxt[7];
    x[8] = settled[0];
    x[9] = settled[1];
    x[10] = xd[3];
    x[11] = engine_rpm;
#pragma unroll
    for (int i = 0; i < 10; ++i) x[12 + i] = unc[i];
    y[0] = x[5];
    y[1] = x[6];
    y[2] = x[0];
    y[3] = x[1];
    y[4] = settled[2];
    y[5] = yaw;
    y[6] = settled[0];
    y[7] = settled[1];
    y[8] = steer;
    y[9] = xd[3];
    y[10] = xd[5];
    y[11] = x[7];
    y[12] = sign(nxt[5]) * sqrtf(nxt[5] * nxt[5] + nxt[6] * nxt[6]);
    y[13] = xd[6];
  }
};
