// Bicycle-slip parametric dynamics step for the rollout kernel.
//
// Device twin of BicycleSlipDynamics.step in
// mppi_generic_tpu_torch/models/bicycle_slip.py (the JAX package's
// models/bicycle_slip.py:35-156, reference bicycle_slip_parametric.cu): state
// [pos_x, pos_y, yaw, steer_angle, brake_state, vel_x, vel_y, omega_z, roll,
// pitch], control [throttle_brake, steer_cmd], output = state. The same
// operations in the same order as the PyTorch version, one rounding each
// (--fmad=false): the brake and steering lags with their rate clamps, the
// tanh force terms, the wheel angle tanf(steer / steer_angle_scale), the yaw
// rate tracking, the body-frame velocity kinematics, then the Euler update
// with the yaw wrap (math_utils.cuh) and the steer and brake clamps
// (min(max(x, lo), hi), as torch.clamp and jnp.clip).
//
// The parameters arrive as the model's packed `params` table (PARAMS in
// models/bicycle_slip.py, the pairs flattened [scale, rate], then the brake
// limit -control_ranges[0, 0]); every thread of a block stages its share
// into shared memory (stage), the kernel syncs after.
#pragma once

#include <math.h>

#include "math_utils.cuh"
#include "warp.cuh"

struct BicycleSlip {
  static constexpr int S = 10;  // state
  static constexpr int C = 2;   // control
  static constexpr int O = 10;  // output
  static constexpr bool kStaged = true;
  // indices into the table
  enum {
    kMass, kWheelBase, kSteerAngleScale, kSteerCmdScale, kSteeringConst,
    kMaxSteerAngle, kMaxSteerRate, kBrakeDelay, kMaxBrakeRateNeg,
    kMaxBrakeRatePos, kThrottle, kBrake0, kBrake1, kRolling0, kRolling1,
    kSliding0, kSliding1, kYf0, kYf1, kOmega, kVOmega, kVx, kVy, kBrakeMax,
    kParams
  };

  struct Shared {
    float p[kParams];
  };

  __device__ static inline void stage(const float* __restrict__ params,
                                      Shared* sh) {
    for (int i = threadIdx.x; i < kParams; i += blockDim.x) sh->p[i] = params[i];
  }

  __device__ static inline float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
  }

  // BicycleSlipDynamics.state_deriv: the derivative xd of the ten states
  // (the bicycle elevation model's slip derivative too, bicycle_elevation.cuh)
  __device__ static inline void state_deriv(const float* p, const float* x, const float* u,
                                            float* xd) {
    const float yaw = x[2], steer = x[3];
    const float vx = x[5], vy = x[6], om = x[7];

    const float brake_force = p[kBrake0] * tanhf(p[kBrake1] * vx) * x[4];
    const float drag_x = p[kRolling0] * tanhf(p[kRolling1] * vx);
    const float drag_y = p[kSliding0] * tanhf(p[kSliding1] * vy);
    const float y_force = tanhf(vx * om * p[kYf0]) * p[kYf1] - drag_y;

    const float wheel_angle = tanf(steer / p[kSteerAngleScale]);
    const float sin_w = sinf(wheel_angle);
    const float cos_w = cosf(wheel_angle);

    const float parametric_omega = (vx / p[kWheelBase]) * wheel_angle;
    const float x_force = throttle(p, u) - brake_force - drag_x;
    const float fx_m = (x_force + x_force * cos_w - y_force * sin_w) / p[kMass];
    const float fy_m = (y_force + y_force * cos_w + x_force * sin_w) / p[kMass];
    derivs(p, x, u, parametric_omega, fx_m, fy_m, cosf(yaw), sinf(yaw), xd);
  }

  __device__ static inline void step(const Shared& sh, float* x, const float* u,
                                     float /*t*/, float dt, float* y) {
    float xd[S];
    state_deriv(sh.p, x, u, xd);
    update(sh.p, x, xd, dt, y);
  }

  // The lane-group form of step (split_lanes.cuh): the kLaneGroup lanes of a
  // group (groups aligned in the warp) hold the same state and run one
  // instruction stream. Where step evaluates one function on independent
  // operands, lane l takes operand set l % 4 (each set on two lanes; eight
  // lanes a sample beat four, PERF.md section 6) and the results reach every
  // lane of the group by __shfl_sync (width kLaneGroup):
  //   the divisions steer / steer_angle_scale (sets 0 and 2) and
  //   vx / wheel_base (1 and 3), then tanf of the quotient (the wheel angle
  //   on the even sets);
  //   the four tanh terms as (A tanhf((a b) c)) B: set 0 the brake force, 1
  //   the rolling drag, 2 the sliding drag, 3 tanh(vx omega y_f_c[0])
  //   y_f_c[1] (the factors of 1 are exact, the products commute);
  //   sinf and cosf of the wheel angle (set 0) and of the yaw (the others);
  //   the divisions by the mass of the y (set 1) and x (the others)
  //   numerators.
  // The rest (derivs: the lags, the yaw rate, the accelerations; update: the
  // Euler update, the yaw wrap, the clamps) every lane computes alike. Each
  // value is made with step's operations on step's operands and a shuffle
  // moves bits exactly, so x and y are step's floats.
  static constexpr int kLaneGroup = 8;

  __device__ static inline void step_lanes(const Shared& sh, float* x, const float* u,
                                           float /*t*/, float dt, float* y) {
    constexpr int G = kLaneGroup;
    const float* p = sh.p;
    const int set = threadIdx.x & 3;
    const float yaw = x[2], steer = x[3];
    const float vx = x[5], vy = x[6], om = x[7];

    // sets 0 and 2: steer / steer_angle_scale; 1 and 3: vx / wheel_base
    const bool odd = set & 1;
    const float q = (odd ? vx : steer) / (odd ? p[kWheelBase] : p[kSteerAngleScale]);
    const float a = set == 0 ? p[kBrake1] : set == 1 ? p[kRolling1] : set == 2 ? p[kSliding1] : vx;
    const float b = set == 2 ? vy : set == 3 ? om : vx;
    const float c = set == 3 ? p[kYf0] : 1.0f;
    const float A = set == 0 ? p[kBrake0] : set == 1 ? p[kRolling0] : set == 2 ? p[kSliding0]
                                                                               : p[kYf1];
    const float B = set == 0 ? x[4] : 1.0f;
    const float f = (A * tanhf((a * b) * c)) * B;

    // tanf of the set's own quotient: the wheel angle on the even sets
    const float wa = tanf(q);
    const float ang = set == 0 ? wa : yaw;
    const float sn = sinf(ang);
    const float cn = cosf(ang);
    const float sin_w = __shfl_sync(kFullMask, sn, 0, G);
    const float cos_w = __shfl_sync(kFullMask, cn, 0, G);

    const float wheel_angle = __shfl_sync(kFullMask, wa, 0, G);
    const float parametric_omega = __shfl_sync(kFullMask, q, 1, G) * wheel_angle;
    const float x_force = throttle(p, u) - __shfl_sync(kFullMask, f, 0, G) -
                          __shfl_sync(kFullMask, f, 1, G);
    const float y_force = __shfl_sync(kFullMask, f, 3, G) - __shfl_sync(kFullMask, f, 2, G);
    const float num_x = x_force + x_force * cos_w - y_force * sin_w;
    const float num_y = y_force + y_force * cos_w + x_force * sin_w;
    const float dv = (set == 1 ? num_y : num_x) / p[kMass];
    float xd[S];
    derivs(p, x, u, parametric_omega, __shfl_sync(kFullMask, dv, 0, G),
           __shfl_sync(kFullMask, dv, 1, G), __shfl_sync(kFullMask, cn, 1, G),
           __shfl_sync(kFullMask, sn, 1, G), xd);
    update(p, x, xd, dt, y);
  }

 private:
  // (enable_brake ? 0 : 1) c_throttle throttle_brake
  __device__ static inline float throttle(const float* p, const float* u) {
    return (u[0] < 0.0f ? 0.0f : 1.0f) * p[kThrottle] * u[0];
  }

  // The derivative from the yaw-rate term (vx / wheel_base) wheel_angle, the
  // force terms over the mass and the yaw's cosine and sine: the lags with
  // their rate clamps, the yaw rate, the accelerations, the kinematics.
  __device__ static inline void derivs(const float* p, const float* x, const float* u,
                                       float parametric_omega, float fx_m, float fy_m,
                                       float cos_y, float sin_y, float* xd) {
    const float steer = x[3], brake = x[4];
    const float vx = x[5], vy = x[6], om = x[7];
    const float tb = u[0], sc = u[1];
    const bool enable_brake = tb < 0.0f;
    xd[0] = vx * cos_y - vy * sin_y;
    xd[1] = vx * sin_y + vy * cos_y;
    xd[2] = om;
    xd[3] = clampf((sc * p[kSteerCmdScale] - steer) * p[kSteeringConst], -p[kMaxSteerRate],
                   p[kMaxSteerRate]);
    xd[4] = clampf(((enable_brake ? -tb : 0.0f) - brake) * p[kBrakeDelay],
                   -p[kMaxBrakeRateNeg], p[kMaxBrakeRatePos]);
    xd[5] = fx_m - vx * p[kVx] + vy * om;
    xd[6] = fy_m - vy * p[kVy] - vx * om;
    xd[7] = (parametric_omega - om) * p[kOmega] - om * p[kVOmega];
    xd[8] = 0.0f;
    xd[9] = 0.0f;
  }

  // The Euler update with the yaw wrap and the clamps; y <- x.
  __device__ static inline void update(const float* p, float* x, const float* xd, float dt,
                                       float* y) {
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x[i] + xd[i] * dt;
    x[2] = normalize_angle(x[2]);
    x[3] = clampf(x[3], -p[kMaxSteerAngle], p[kMaxSteerAngle]);
    x[4] = clampf(x[4], 0.0f, p[kBrakeMax]);
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = x[i];
  }
};
