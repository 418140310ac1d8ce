// AutoRally neural-network dynamics step for the rollout and solve kernels,
// and its derivative for the DDP ladder kernel.
//
// Device twin of AutorallyNNDynamics.kernel_step and .kernel_state_deriv in
// mppi_generic_tpu_torch/models/autorally.py (the reference's
// NeuralNetModel<7, 2, 3>, ar_nn_model.cu:91-120): state [x, y, yaw, roll,
// u_x, u_y, yaw_rate], control [steering, throttle];
//   x_d = cos(yaw) u_x - sin(yaw) u_y,  y_d = sin(yaw) u_x + cos(yaw) u_y,
//   yaw_d = -yaw_rate,  [roll_d, u_x_d, u_y_d, yaw_rate_d] =
//   FNN(roll, u_x, u_y, yaw_rate, steering, throttle)   (state_deriv),
// then x <- x + xdot dt with the yaw wrapped to [-pi, pi), output = state
// (step). The ladder's forward pass steps x + state_deriv dt, without the
// wrap, as the JAX package's (pallas_riccati.py:263, ilqr.py:84).
// Compiled for the 6-32-32-4 network of the reference's autorally_nnet; the
// wrappers refuse another architecture. The network's 1,412 parameters are
// staged into shared memory once per block (Shared, stage). AutorallyNN
// unrolls the network's layers (B1, B3); AutorallyNNRolled rolls their
// output loops (B7, B8: fnn_layer_rolled), with the same arithmetic.
// step_warp is the step of the split dynamics passes' warp form
// (split_warp.cuh): the network by FNN3::forward_warp from stage_warp's
// table, everything else the same operations on every lane.
#pragma once

#include <math.h>

#include "fnn.cuh"
#include "math_utils.cuh"

template <bool kRolled>
struct AutorallyNNT {
  static constexpr int S = 7;  // state
  static constexpr int C = 2;  // control
  static constexpr int O = 7;  // output
  using Net = FNN3<6, 32, 32, 4>;
  static constexpr bool kStaged = true;
  static constexpr bool kWarpStep = true;  // has stage_warp / step_warp
  static constexpr int kWarpSamples = 4;   // samples (warps) per block there

  struct Shared {
    float w[Net::kParams];
  };

  // every thread of the block; the kernel syncs after
  __device__ static inline void stage(const float* __restrict__ params,
                                      Shared* sh) {
    Net::stage(params, sh->w);
  }

  // the warp form's table (FNN3::stage_warp)
  __device__ static inline void stage_warp(const float* __restrict__ params,
                                           Shared* sh) {
    Net::stage_warp(params, sh->w);
  }

  // kWarp: the network's warp form, from stage_warp's table
  template <bool kWarp = false>
  __device__ static inline void state_deriv(const Shared& sh, const float* x,
                                            const float* u, float /*t*/,
                                            float* xd) {
    const float yaw = x[2];
    const float cos_y = cosf(yaw);
    const float sin_y = sinf(yaw);
    xd[0] = cos_y * x[4] - sin_y * x[5];
    xd[1] = sin_y * x[4] + cos_y * x[5];
    xd[2] = -x[6];
    const float feats[6] = {x[3], x[4], x[5], x[6], u[0], u[1]};
    if constexpr (kWarp) {
      Net::forward_warp(sh.w, feats, xd + 3);
    } else {
      Net::template forward<kRolled>(sh.w, feats, xd + 3);
    }
  }

  template <bool kWarp = false>
  __device__ static inline void step(const Shared& sh, float* x, const float* u,
                                     float t, float dt, float* y) {
    float xd[S];
    state_deriv<kWarp>(sh, x, u, t, xd);
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x[i] + xd[i] * dt;
    x[2] = normalize_angle(x[2]);
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = x[i];
  }

  __device__ static inline void step_warp(const Shared& sh, float* x, float* /*rec*/,
                                          const float* u, float t, float dt, float* y) {
    step<true>(sh, x, u, t, dt, y);
  }
};

using AutorallyNN = AutorallyNNT<false>;
using AutorallyNNRolled = AutorallyNNT<true>;
