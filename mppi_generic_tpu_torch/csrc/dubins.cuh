// Dubins (unicycle) step for the rollout and sampling kernels.
//
// Device twin of DubinsDynamics.step in mppi_generic_tpu_torch/models/dubins.py
// (the JAX package's models/dubins.py:17-43, reference dubins.cu:8-33): state
// [pos_x, pos_y, yaw], control [vel, yaw_rate], output = state; the Euler
// update, then the yaw wrapped to [-pi, pi) by normalize_angle (fmodf and its
// sign fix, math_utils.cuh, as torch.fmod in the plain version). The same
// operations in the same order as the PyTorch version (--fmad=false).
// state_deriv is the derivative alone, which the DDP ladder (B7) steps with.
#pragma once

#include <math.h>

#include "math_utils.cuh"

struct Dubins {
  static constexpr int S = 3;  // state
  static constexpr int C = 2;  // control
  static constexpr int O = 3;  // output

  // no parameters to stage
  static constexpr bool kStaged = false;
  struct Shared {};
  __device__ static inline void stage(const float* /*params*/, Shared* /*sh*/) {}

  // xdot = [u0 cos(yaw), u0 sin(yaw), u1] (DubinsDynamics.state_deriv, the
  // JAX package's models/dubins.py:26-28). The DDP ladder's forward pass
  // steps x <- x + xdot * dt with it and, as the TPU kernel does
  // (pallas_riccati.py:263-264), does not wrap the yaw.
  __device__ static inline void state_deriv(const Shared& /*sh*/, const float* x,
                                            const float* u, float /*t*/,
                                            float* xdot) {
    const float yaw = x[2];
    xdot[0] = u[0] * cosf(yaw);
    xdot[1] = u[0] * sinf(yaw);
    xdot[2] = u[1];
  }

  __device__ static inline void step(const Shared& sh, float* x, const float* u,
                                     float t, float dt, float* y) {
    float xdot[S];
    state_deriv(sh, x, u, t, xdot);
    x[0] = x[0] + xdot[0] * dt;
    x[1] = x[1] + xdot[1] * dt;
    x[2] = normalize_angle(x[2] + xdot[2] * dt);
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = x[i];
  }
};
