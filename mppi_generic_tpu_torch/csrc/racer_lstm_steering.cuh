// The RACER Dubins elevation model with LSTM steering for the rollout and
// solve kernels: a recurrent model (R = 32, the LSTM's h and c) that reads
// its own elevation map.
//
// Device twin of RacerDubinsElevationLSTMSteering.kernel_step_recurrent in
// mppi_generic_tpu_torch/models/racer_dubins_elevation.py (the JAX package's
// step_recurrent, racer_dubins_elevation.py:327-357; reference
// racer_dubins_elevation_lstm_steering.cu): state [vel_x, yaw, pos_x,
// pos_y, steer_angle, brake_state, steer_angle_rate, roll, pitch], control
// [throttle_brake, steer_cmd], 13 outputs. Per step: the parametric steering
// rate, the LSTM (lstm.cuh, B10) over [vel_x, steer_angle, steer_cmd,
// parametric rate] correcting it, then the elevation model's update
// (racer::elevation_update, racer_elevation.cuh: its derivatives, the Euler
// update with the yaw wrap and the steer and brake clamps, static settling on
// the elevation map, four B9 queries, with the new position and yaw and the
// *old* roll and pitch).
//
// The table (kernel_params): the model's params (27 floats, the brake limit
// last), the map block (20), the LSTM's table (4 -> 16, head 20-16-1: 1,697
// floats) and the warm h, c (16 each): 1,776 floats staged in shared memory
// by every block. The map data pointer comes apart (ModelArgs::dyn_map).
//
// step_warp is the step of the split dynamics passes' warp form
// (split_warp.cuh): the LSTM by LSTMNet::forward_warp from stage_warp's table
// (the network block laid out for it, the rest in place), its carry (h, c)
// of this lane's unit (RW = 2); the rest of the step, the four map queries
// included, the same operations on every lane.
#pragma once

#include <math.h>

#include "lstm.cuh"
#include "math_utils.cuh"
#include "racer_elevation.cuh"

struct RacerLSTMSteering {
  static constexpr int S = 9;    // state
  static constexpr int C = 2;    // control
  static constexpr int O = 13;   // output
  static constexpr int H = 16;   // the LSTM's hidden units
  static constexpr int R = 2 * H;  // the carry: h, c
  static constexpr int RW = 2;     // the warp form's carry: this lane's h, c
  static constexpr bool kStaged = true;
  static constexpr bool kWarpStep = true;  // has stage_warp / step_warp
  static constexpr int kWarpSamples = 8;   // samples (warps) per block there
  static constexpr bool kDynMap = true;
  using Net = LSTMNet<4, H, 16, 1>;
  // offsets into the table
  static constexpr int kBrakeMax = racer::kElevationParams;
  static constexpr int kMap = kBrakeMax + 1;
  static constexpr int kNet = kMap + racer::kMapBlock;
  static constexpr int kWarm = kNet + Net::kParams;
  static constexpr int kTable = kWarm + R;

  struct Shared {
    float p[kTable];
    const float* map;
  };

  // every thread of the block; the kernel syncs after
  __device__ static inline void stage(const float* __restrict__ params,
                                      const float* map, Shared* sh) {
    for (int i = threadIdx.x; i < kTable; i += blockDim.x) sh->p[i] = params[i];
    if (threadIdx.x == 0) sh->map = map;
  }

  __device__ static inline void init_rec(const Shared& sh, float* rec) {
#pragma unroll
    for (int i = 0; i < R; ++i) rec[i] = sh.p[kWarm + i];
  }

  // the warp form's table: the network block at LSTMNet::warp_slot
  __device__ static inline void stage_warp(const float* __restrict__ params,
                                           const float* map, Shared* sh) {
    for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
      const bool net = i >= kNet && i < kNet + Net::kParams;
      sh->p[net ? kNet + Net::warp_slot(i - kNet) : i] = params[i];
    }
    if (threadIdx.x == 0) sh->map = map;
  }

  __device__ static inline void init_rec_warp(const Shared& sh, float* rec) {
    rec[0] = sh.p[kWarm + (threadIdx.x & 31) % H];
    rec[1] = sh.p[kWarm + H + (threadIdx.x & 31) % H];
  }

  __device__ static inline void step(const Shared& sh, float* x, float* rec,
                                     const float* u, float t, float dt,
                                     float* y) {
    step_impl<false>(sh, x, rec, u, t, dt, y);
  }

  __device__ static inline void step_warp(const Shared& sh, float* x, float* rec,
                                          const float* u, float t, float dt,
                                          float* y) {
    step_impl<true>(sh, x, rec, u, t, dt, y);
  }

  template <bool kWarp>
  __device__ static inline void step_impl(const Shared& sh, float* x, float* rec,
                                          const float* u, float /*t*/, float dt,
                                          float* y) {
    const float* p = sh.p;
    const float steer_d_param = racer::steer_deriv(p, x, u);
    const float feats[4] = {x[0], x[4], u[1], steer_d_param};
    float delta[1];
    lstm_forward<kWarp, Net>(p + kNet, rec, feats, delta);
    const float steer_d = steer_d_param + delta[0];
    racer::elevation_update(p, p[kBrakeMax], p + kMap, sh.map, x, u, steer_d, dt, y);
  }
};
