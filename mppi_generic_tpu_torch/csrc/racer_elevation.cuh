// The RACER Dubins elevation model's parametric pieces for the racer steps
// (racer_dubins.cuh, racer_lstm_steering.cuh, racer_elev_susp.cuh,
// racer_lstm_unc.cuh, bicycle_elevation.cuh): the table layout, the
// speed-regime select, the steering, brake and longitudinal derivatives, the
// elevation model's update after its steering rate, the static settling on
// the elevation map, and the uncertainty pieces (the parametric Q and the
// covariance propagation).
//
// Device twins of RacerDubinsElevationDynamics in
// mppi_generic_tpu_torch/models/racer_dubins_elevation.py (the JAX package's
// models/racer_dubins_elevation.py, reference racer_dubins_elevation.cu:
// 33-67 and RACER::computeStaticSettling, racer_dubins.cu:359-430) and of
// _q_matrix and propagate_uncertainty in models/racer_dubins_unc.py
// (racer_dubins_elevation.cu:428-516, :672-760), the same operations in the
// same order, one rounding each (--fmad=false); the clamps and minima keep a
// NaN as torch.clamp and torch.minimum do.
//
// Static settling reads the elevation map four times per sample-step through
// map_query_world (B9, map_texture.cuh), then takes the per-axle slopes with
// asin_approx (math_utils.cuh). It replaces the TPU kernels' in-kernel map
// query of the same four corners (maps/texture.py::_query_tex_pallas :456,
// the tent-mask bilinear).
#pragma once

#include <math.h>

#include "map_texture.cuh"
#include "math_utils.cuh"

namespace racer {

// The packed `params` table of models/racer_dubins.py and
// racer_dubins_elevation.py (PARAMS in order, triples flattened).
enum ElevationParams {
  kCt, kCb, kCv, kC0, kSteeringConst, kSteerCmdScale, kSteerAngleScale,
  kMaxSteerAngle, kMaxSteerRate, kBrakeDelay, kMaxBrakeRateNeg,
  kMaxBrakeRatePos, kWheelBase, kGearSign,
  kCt3, kCb3 = kCt3 + 3, kCv3 = kCb3 + 3, kLowMinThrottle = kCv3 + 3,
  kClampAx, kGravity,
  kElevationParams  // the LSTM-steering model's brake limit sits here
};

// floats of a map's description after the params (map_block in
// models/racer_dubins_elevation.py): a flag word (1 with a map), the int32
// words [H, W, offset, stride], origin (3), rotation rows (9), resolution (3)
constexpr int kMapBlock = 20;

// wheel positions in the body frame (racer_dubins.cu:364-368)
constexpr float kFrontX = static_cast<float>(2.981);
constexpr float kHalfTrack = static_cast<float>(0.737);

// table[regime(|vel|)]: |v| <= 0.2, <= 3, above
__device__ inline float regime_select(float vel, const float* table) {
  const float av = fabsf(vel);
  return av <= static_cast<float>(0.2) ? table[0] : (av <= 3.0f ? table[1] : table[2]);
}

__device__ inline float steer_deriv(const float* p, const float* x, const float* u) {
  return clamp_nan((u[1] * p[kSteerCmdScale] - x[4]) * p[kSteeringConst],
                   -p[kMaxSteerRate], p[kMaxSteerRate]);
}

__device__ inline float brake_deriv(const float* p, float throttle_brake, float brake) {
  return clamp_nan(((throttle_brake < 0.0f ? -throttle_brake : 0.0f) - brake) *
                       p[kBrakeDelay],
                   -p[kMaxBrakeRateNeg], p[kMaxBrakeRatePos]);
}

// (vel / wheel_base) tanf(steer / steer_angle_scale)
__device__ inline float yaw_rate(const float* p, float vel, float steer) {
  return (vel / p[kWheelBase]) * tanf(steer / p[kSteerAngleScale]);
}

// The longitudinal acceleration of RacerDubinsElevationDynamics.state_deriv:
// the regime coefficients, the low-speed deadband and brake, the clamp, then
// the gravity term of the pitch.
__device__ inline float vel_deriv(const float* p, float vel, float brake_raw,
                                  float pitch, float throttle_brake) {
  const bool enable_brake = throttle_brake < 0.0f;
  const float c_t = regime_select(vel, p + kCt3);
  const float c_b = regime_select(vel, p + kCb3);
  const float c_v = regime_select(vel, p + kCv3);
  const float brake_state = clamp_nan(brake_raw, 0.0f, 0.25f);
  const float throttle_hi = c_t * throttle_brake;
  const float brake_hi = c_b * brake_state * (vel >= 0.0f ? -1.0f : 1.0f);
  const float throttle_lo = c_t * max_nan(throttle_brake - p[kLowMinThrottle], 0.0f);
  const float brake_lo = c_b * brake_state * -vel;
  const bool low_speed = fabsf(vel) <= static_cast<float>(0.2);
  const float throttle = low_speed ? throttle_lo : throttle_hi;
  const float brake_f = low_speed ? brake_lo : brake_hi;
  float vel_d = (enable_brake ? 0.0f : 1.0f) * throttle * p[kGearSign] + brake_f -
                c_v * vel + p[kC0];
  vel_d = clamp_nan(vel_d, -p[kClampAx], p[kClampAx]);
  return vel_d - (fabsf(pitch) < kHalfPi ? p[kGravity] * sinf(pitch) : 0.0f);
}

// the steer clamp and the brake clamp to [0, brake_max]
__device__ inline float clamp_steer(const float* p, float steer) {
  return clamp_nan(steer, -p[kMaxSteerAngle], p[kMaxSteerAngle]);
}
__device__ inline float clamp_brake(float brake, float brake_max) {
  return min_nan(max_nan(brake, 0.0f), brake_max);
}

__device__ inline float settle_bounded(float a) {
  return (isfinite(a) && fabsf(a) <= kPi) ? a : kTwoPi;
}

// static_settling (models/racer_dubins_elevation.py): the elevation map under
// the four wheels (FL, FR, RL, RR), rotated by yaw, pitch and roll; the
// per-axle asin slopes; (roll, pitch, height), zeros without a map.
__device__ inline void static_settling(const float* block, const float* map,
                                       float pos_x, float pos_y, float yaw,
                                       float roll, float pitch, float* out) {
  if (__float_as_int(block[0]) == 0) {
    out[0] = 0.0f;
    out[1] = 0.0f;
    out[2] = 0.0f;
    return;
  }
  const MapTex m = load_map_tex(block + 1, map);
  const float cy = cosf(yaw), sy = sinf(yaw);
  const float cp = cosf(pitch), sp = sinf(pitch);
  const float cr = cosf(roll), sr = sinf(roll);
  const float axx = cy * cp;
  const float axy = cy * sp * sr - sy * cr;
  const float ayx = sy * cp;
  const float ayy = sy * sp * sr + cy * cr;
  const float bx[4] = {kFrontX, kFrontX, 0.0f, 0.0f};
  const float by[4] = {kHalfTrack, -kHalfTrack, kHalfTrack, -kHalfTrack};
  float v[4];  // fl, fr, rl, rr
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float px = pos_x + bx[i] * axx + by[i] * axy;
    const float py = pos_y + bx[i] * ayx + by[i] * ayy;
    v[i] = map_query_world(m, px, py);
  }
  const float roll_lim = static_cast<float>(2 * 0.736);
  const float roll_den = static_cast<float>(2 * 0.737);
  const float pitch_lim = static_cast<float>(2.98);
  const float pitch_den = static_cast<float>(2.981);
  const float front_roll = asin_approx(clamp_nan(v[0] - v[1], -roll_lim, roll_lim) / roll_den);
  const float rear_roll = asin_approx(clamp_nan(v[2] - v[3], -roll_lim, roll_lim) / roll_den);
  const float new_roll = 0.5f * (front_roll + rear_roll);
  const float left_pitch =
      asin_approx(clamp_nan(v[2] - v[0], -pitch_lim, pitch_lim) / pitch_den);
  const float right_pitch =
      asin_approx(clamp_nan(v[3] - v[1], -pitch_lim, pitch_lim) / pitch_den);
  const float new_pitch = 0.5f * (left_pitch + right_pitch);
  const float height = 0.5f * (v[2] + v[3]);
  out[0] = settle_bounded(new_roll);
  out[1] = settle_bounded(new_pitch);
  out[2] = isfinite(height) ? height : 0.0f;
}

// The rest of RacerDubinsElevationDynamics.step after the steering rate
// steer_d (the parametric one, or the LSTM's correction of it): the
// derivatives, the Euler update with the yaw wrap and the steer and brake
// clamps, static settling with the new position and yaw and the old roll
// and pitch (the map block `block`, its data `map`), then the 13 outputs.
__device__ inline void elevation_update(const float* p, float brake_max, const float* block,
                                        const float* map, float* x, const float* u,
                                        float steer_d, float dt, float* y) {
  float xd[6];
  xd[0] = vel_deriv(p, x[0], x[5], x[8], u[0]);
  xd[1] = yaw_rate(p, x[0], x[4]);
  xd[2] = x[0] * cosf(x[1]);
  xd[3] = x[0] * sinf(x[1]);
  xd[4] = steer_d;
  xd[5] = brake_deriv(p, u[0], x[5]);
  float xn[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xn[i] = x[i] + xd[i] * dt;
  const float yaw = normalize_angle(xn[1]);
  const float steer = clamp_steer(p, xn[4]);
  const float brake = clamp_brake(xn[5], brake_max);
  float settled[3];  // roll, pitch, height
  static_settling(block, map, xn[2], xn[3], yaw, x[7], x[8], settled);
  x[0] = xn[0];
  x[1] = yaw;
  x[2] = xn[2];
  x[3] = xn[3];
  x[4] = steer;
  x[5] = brake;
  x[6] = steer_d;
  x[7] = settled[0];
  x[8] = settled[1];
  y[0] = x[0];
  y[1] = 0.0f;
  y[2] = x[2];
  y[3] = x[3];
  y[4] = settled[2];
  y[5] = yaw;
  y[6] = x[7];
  y[7] = x[8];
  y[8] = steer;
  y[9] = steer_d;
  y[10] = xd[0];
  y[11] = xd[1];
  y[12] = fabsf(x[0]);
}

// The parametric Q (RacerDubinsElevationSuspension._q_matrix, and the
// bicycle elevation model's, models/bicycle_slip.py), row-major, from a
// state's speed, yaw, steering angle and roll and the speed's derivative:
// q points at the seven floats [Q_x_acc, Q_x_v (3), Q_omega_steering,
// Q_omega_v, Q_y_f] of a table.
__device__ inline void parametric_q(const float* q, float steer_angle_scale, float wheel_base,
                                    float gravity, float vel, float yaw, float steer,
                                    float roll, float vel_d, float* Q) {
  const float sin_y = sinf(yaw), cos_y = cosf(yaw);
  const float delta = steer / steer_angle_scale;
  const float abs_v = fabsf(vel);
  const float side_force = abs_v * abs_v * tanf(delta) / wheel_base + gravity * sinf(roll);
  const float q11 = fabsf(q[6] * fabsf(side_force) * max_nan(abs_v - 2.0f, 0.0f));
  const float q_vv = q[0] * fabsf(vel_d) + regime_select(vel, q + 1) * abs_v;
  const float q_yy = abs_v * (q[4] * fabsf(delta) + q[5]);
#pragma unroll
  for (int i = 0; i < 16; ++i) Q[i] = 0.0f;
  Q[0] = q_vv;
  Q[5] = q_yy;
  Q[10] = q11 * sin_y * sin_y;
  Q[11] = -q11 * sin_y * cos_y;
  Q[14] = -q11 * sin_y * cos_y;
  Q[15] = q11 * cos_y * cos_y;
}

// Sigma' = (I + A dt) Sigma (I + A dt)^T + Q dt over the packed entries s10
// (propagate_uncertainty, the JAX package's sums from 0), written to out;
// A and Q row-major in (vx, yaw, px, py) order
__device__ inline void propagate(const float* s10, const float* A, const float* Q, float dt,
                                 float* out) {
  // (vx, yaw, px, py) order: packed [px, py, yaw, vx, px_py, px_yaw, px_vx,
  // py_yaw, py_vx, yaw_vx]
  const float S[16] = {s10[3], s10[9], s10[6], s10[8],
                       s10[9], s10[2], s10[5], s10[7],
                       s10[6], s10[5], s10[0], s10[4],
                       s10[8], s10[7], s10[4], s10[1]};
  float Ad[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) Ad[i * 4 + j] = A[i * 4 + j] * dt + (i == j ? 1.0f : 0.0f);
  }
  float M[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) a = a + Ad[i * 4 + k] * S[k * 4 + j];
      M[i * 4 + j] = a;
    }
  }
  float S2[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float a = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) a = a + M[i * 4 + k] * Ad[l * 4 + k];
      S2[i * 4 + l] = a + Q[i * 4 + l] * dt;
    }
  }
  out[0] = S2[10];
  out[1] = S2[15];
  out[2] = S2[5];
  out[3] = S2[0];
  out[4] = S2[11];
  out[5] = S2[9];
  out[6] = S2[8];
  out[7] = S2[13];
  out[8] = S2[12];
  out[9] = S2[4];
}

}  // namespace racer
