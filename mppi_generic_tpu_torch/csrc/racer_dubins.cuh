// The RACER Dubins model and its elevation variant without an LSTM, for the
// rollout, solve and sampling kernels (their staged forms,
// sample_staged.cuh).
//
// Device twins of RacerDubinsDynamics.step in
// mppi_generic_tpu_torch/models/racer_dubins.py (the JAX package's
// models/racer_dubins.py, reference racer_dubins.cu:5-59) and of
// RacerDubinsElevationDynamics.step in models/racer_dubins_elevation.py
// (racer_dubins_elevation.py:241-272), the same operations in the same
// order, one rounding each (--fmad=false); the clamps keep a NaN as
// torch.clamp does.
//
// RacerDubins: state [vel_x, yaw, pos_x, pos_y, steer_angle, brake_state,
// steer_angle_rate], control [throttle_brake, steer_cmd], output = state. Per
// step: the throttle, brake, drag and offset forces, the yaw rate
// (v / wheel_base) tanf(steer / steer_angle_scale), the rate-limited steering
// and brake lags, then the Euler update with the yaw wrap, the steer and
// brake clamps and the steer rate written back. Its table: the packed params
// (14 floats, racer::ElevationParams up to kGearSign) and the brake limit.
//
// RacerElevation: the nine states and 13 outputs of the elevation model: the
// parametric steering rate, then racer::elevation_update (the regime
// coefficients, the gravity term of the pitch, static settling on the map,
// four B9 queries a step, map_texture.cuh). Its table: the params (26
// floats), the brake limit, the map block (20): 47 floats; the map data comes
// apart (ModelArgs::dyn_map).
#pragma once

#include <math.h>

#include "math_utils.cuh"
#include "racer_elevation.cuh"

struct RacerDubins {
  static constexpr int S = 7;  // state
  static constexpr int C = 2;  // control
  static constexpr int O = 7;  // output
  static constexpr bool kStaged = true;
  static constexpr int kBrakeMax = racer::kGearSign + 1;
  static constexpr int kTable = kBrakeMax + 1;

  struct Shared {
    float p[kTable];
  };

  __device__ static inline void stage(const float* __restrict__ params, Shared* sh) {
    for (int i = threadIdx.x; i < kTable; i += blockDim.x) sh->p[i] = params[i];
  }

  __device__ static inline void step(const Shared& sh, float* x, const float* u,
                                     float /*t*/, float dt, float* y) {
    using namespace racer;
    const float* p = sh.p;
    const float vel = x[0], yaw = x[1], brake = x[5];
    const bool enable_brake = u[0] < 0.0f;
    float xd[S];
    xd[0] = (enable_brake ? 0.0f : 1.0f) * p[kCt] * u[0] * p[kGearSign] +
            p[kCb] * brake * (vel >= 0.0f ? -1.0f : 1.0f) - p[kCv] * vel + p[kC0];
    xd[1] = yaw_rate(p, vel, x[4]);
    xd[2] = vel * cosf(yaw);
    xd[3] = vel * sinf(yaw);
    xd[4] = steer_deriv(p, x, u);
    xd[5] = brake_deriv(p, u[0], brake);
    xd[6] = 0.0f;
    float xn[S];
#pragma unroll
    for (int i = 0; i < S; ++i) xn[i] = x[i] + xd[i] * dt;
    x[0] = xn[0];
    x[1] = normalize_angle(xn[1]);
    x[2] = xn[2];
    x[3] = xn[3];
    x[4] = clamp_steer(p, xn[4]);
    x[5] = clamp_brake(xn[5], p[kBrakeMax]);
    x[6] = xd[4];
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = x[i];
  }
};

struct RacerElevation {
  static constexpr int S = 9;   // state
  static constexpr int C = 2;   // control
  static constexpr int O = 13;  // output
  static constexpr bool kStaged = true;
  static constexpr bool kDynMap = true;
  static constexpr int kBrakeMax = racer::kElevationParams;
  static constexpr int kMap = kBrakeMax + 1;
  static constexpr int kTable = kMap + racer::kMapBlock;

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

  __device__ static inline void step(const Shared& sh, float* x, const float* u,
                                     float /*t*/, float dt, float* y) {
    const float* p = sh.p;
    racer::elevation_update(p, p[kBrakeMax], p + kMap, sh.map, x, u,
                            racer::steer_deriv(p, x, u), dt, y);
  }
};
