// Quadrotor step (13 states, quaternion attitude) for the rollout and
// sampling kernels.
//
// Device twin of QuadrotorDynamics.step in
// mppi_generic_tpu_torch/models/quadrotor.py (the JAX package's
// models/quadrotor.py:24-90, reference quadrotor_dynamics.cu:70-125): state
// [x y z, vx vy vz, qw qx qy qz, wx wy wz], control [ang_rate_x, ang_rate_y,
// ang_rate_z, thrust], output = state. x_d = v; v_d = (thrust / m) R(q) e_z -
// g e_z from the third column of the DCM; q_d = 0.5 q (x) [0, w]; w_d =
// (u_pqr - w) / tau. The Euler update, then the quaternion divided by
// norm * sign(q_w), the norm summed ((qw^2 + qx^2) + qy^2) + qz^2 as in the
// plain version. The same operations in the same order as the PyTorch
// version (--fmad=false); gravity the float32 rounding of 9.81. The mass and
// the three time constants arrive as the model's packed `params` table
// (mass, tau_roll, tau_pitch, tau_yaw), staged into shared memory (stage).
#pragma once

#include <math.h>

#include "math_utils.cuh"

struct Quadrotor {
  static constexpr int S = 13;  // state
  static constexpr int C = 4;   // control
  static constexpr int O = 13;  // output
  static constexpr bool kStaged = true;
  static constexpr float kGravity = static_cast<float>(9.81);

  struct Shared {
    float p[4];  // mass, tau_roll, tau_pitch, tau_yaw
  };

  __device__ static inline void stage(const float* __restrict__ params,
                                      Shared* sh) {
    for (int i = threadIdx.x; i < 4; i += blockDim.x) sh->p[i] = params[i];
  }

  __device__ static inline void step(const Shared& sh, float* x, const float* u,
                                     float /*t*/, float dt, float* y) {
    const float qw = x[6], qx = x[7], qy = x[8], qz = x[9];
    const float w0 = x[10], w1 = x[11], w2 = x[12];
    const float r02 = 2.0f * (qx * qz + qw * qy);
    const float r12 = 2.0f * (qy * qz - qw * qx);
    const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
    const float a = u[3] / sh.p[0];
    float xd[S];
    xd[0] = x[3];
    xd[1] = x[4];
    xd[2] = x[5];
    xd[3] = a * r02;
    xd[4] = a * r12;
    xd[5] = a * r22 - kGravity;
    xd[6] = 0.5f * ((-qx) * w0 - qy * w1 - qz * w2);
    xd[7] = 0.5f * (qw * w0 - qz * w1 + qy * w2);
    xd[8] = 0.5f * (qz * w0 + qw * w1 - qx * w2);
    xd[9] = 0.5f * ((-qy) * w0 + qx * w1 + qw * w2);
    xd[10] = (u[0] - w0) / sh.p[1];
    xd[11] = (u[1] - w1) / sh.p[2];
    xd[12] = (u[2] - w2) / sh.p[3];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x[i] + xd[i] * dt;
    const float norm =
        sqrtf(x[6] * x[6] + x[7] * x[7] + x[8] * x[8] + x[9] * x[9]);
    const float scale = norm * sign(x[6]);
#pragma unroll
    for (int i = 6; i < 10; ++i) x[i] = x[i] / scale;
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = x[i];
  }
};
