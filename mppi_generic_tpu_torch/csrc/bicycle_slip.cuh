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

  __device__ static inline void step(const Shared& sh, float* x, const float* u,
                                     float /*t*/, float dt, float* y) {
    const float* p = sh.p;
    const float yaw = x[2], steer = x[3], brake = x[4];
    const float vx = x[5], vy = x[6], om = x[7];
    const float tb = u[0], sc = u[1];
    const bool enable_brake = tb < 0.0f;

    const float brake_d = clampf(
        ((enable_brake ? -tb : 0.0f) - brake) * p[kBrakeDelay],
        -p[kMaxBrakeRateNeg], p[kMaxBrakeRatePos]);
    const float steer_d = clampf((sc * p[kSteerCmdScale] - steer) * p[kSteeringConst],
                                 -p[kMaxSteerRate], p[kMaxSteerRate]);

    const float throttle = (enable_brake ? 0.0f : 1.0f) * p[kThrottle] * tb;
    const float brake_force = p[kBrake0] * tanhf(p[kBrake1] * vx) * brake;
    const float drag_x = p[kRolling0] * tanhf(p[kRolling1] * vx);
    const float x_force = throttle - brake_force - drag_x;

    const float drag_y = p[kSliding0] * tanhf(p[kSliding1] * vy);
    const float y_force = tanhf(vx * om * p[kYf0]) * p[kYf1] - drag_y;

    const float wheel_angle = tanf(steer / p[kSteerAngleScale]);
    const float sin_w = sinf(wheel_angle);
    const float cos_w = cosf(wheel_angle);

    const float parametric_omega = (vx / p[kWheelBase]) * wheel_angle;
    const float omega_d = (parametric_omega - om) * p[kOmega] - om * p[kVOmega];

    const float vx_d = (x_force + x_force * cos_w - y_force * sin_w) / p[kMass] -
                       vx * p[kVx] + vy * om;
    const float vy_d = (y_force + y_force * cos_w + x_force * sin_w) / p[kMass] -
                       vy * p[kVy] - vx * om;

    const float cos_y = cosf(yaw);
    const float sin_y = sinf(yaw);
    const float xd[S] = {vx * cos_y - vy * sin_y,
                         vx * sin_y + vy * cos_y,
                         om,
                         steer_d,
                         brake_d,
                         vx_d,
                         vy_d,
                         omega_d,
                         0.0f,
                         0.0f};
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x[i] + xd[i] * dt;
    x[2] = normalize_angle(x[2]);
    x[3] = clampf(x[3], -p[kMaxSteerAngle], p[kMaxSteerAngle]);
    x[4] = clampf(x[4], 0.0f, p[kBrakeMax]);
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = x[i];
  }
};
