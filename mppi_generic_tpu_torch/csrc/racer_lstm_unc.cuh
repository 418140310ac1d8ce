// The RACER Dubins elevation model with suspension, three LSTMs and the
// propagated 4 x 4 covariance, on flat ground, for the rollout and solve
// kernels: a recurrent model (R = 96, three LSTMs' h and c).
//
// Device twin of RacerDubinsElevationLSTMUncertainty.kernel_step_recurrent
// in mppi_generic_tpu_torch/models/racer_dubins_unc.py (the JAX package's
// step_recurrent, racer_dubins_unc.py:404-519; reference
// racer_dubins_elevation_lstm_unc.cu) without an elevation map: 26 states
// (the elevation model's nine, [cg_pos_z, cg_vel_i_z, roll_rate,
// pitch_rate], the ten packed covariance entries, [omega_z, static_roll,
// static_pitch]), control [throttle_brake, steer_cmd], 27 outputs. Per step,
// in the plain version's order:
//   the parametric derivatives and the steering LSTM (4 -> 16, head 20-16-1)
//   correcting the steering rate; the four-wheel spring-damper suspension
//   with the ground at cg_z - wheel_radius; the quadratic brake; the mean
//   LSTM (11 -> 16, head 27-16-2) correcting the velocity and yaw rates in
//   forward gear; the uncertainty LSTM (12 -> 16, head 28-16-5) whose
//   sigmoid-scaled outputs give Q (the parametric Q in reverse gear); the
//   Jacobian A; Sigma' = (I + A dt) Sigma (I + A dt)^T + Q dt, unrolled with
//   the JAX package's sums from 0; the Euler update, the yaw wrap, the steer
//   and brake clamps; static settling on flat ground (zeros).
//
// The table (kernel_params): the params (55 floats, the brake limit last),
// the map block (20, zeros: this entry refuses an elevation map), the three
// LSTMs' tables (1,697 + 2,274 + 2,405 floats) and the warm (h, c) of each
// (96): 6,547 floats, 26 KB of shared memory per block, under the 48 KB of
// static shared memory. The state, the outputs and the carry (26 + 27 + 96
// floats) do not fit the registers with the step's temporaries: the carry and
// the LSTMs' hidden vectors live in local memory (L1).
//
// step_warp is the step of the split dynamics passes' warp form
// (split_warp.cuh): the three LSTMs by LSTMNet::forward_warp from
// stage_warp's table (the network blocks laid out for it, the rest in place),
// the carry (h, c) of this lane's unit for each (RW = 6 floats against R = 96);
// the suspension, the brake, the Jacobian, the covariance and the Euler
// update the same operations on every lane.
#pragma once

#include <math.h>

#include "lstm.cuh"
#include "math_utils.cuh"
#include "racer_elevation.cuh"

struct RacerLSTMUnc {
  static constexpr int S = 26;   // state
  static constexpr int C = 2;    // control
  static constexpr int O = 27;   // output
  static constexpr int H = 16;   // each LSTM's hidden units
  static constexpr int R = 6 * H;  // (h, c) of the steering, mean, uncertainty LSTMs
  static constexpr int RW = 6;     // the warp form's: this lane's unit of each
  static constexpr bool kStaged = true;
  static constexpr bool kWarpStep = true;  // has stage_warp / step_warp
  static constexpr int kWarpSamples = 8;   // samples (warps) per block there
  using SteerNet = LSTMNet<4, H, 16, 1>;
  using MeanNet = LSTMNet<11, H, 16, 2>;
  using UncNet = LSTMNet<12, H, 16, 5>;
  // the params beyond the elevation model's (models/racer_dubins_unc.py)
  enum {
    kSpringK = racer::kElevationParams, kDragC, kMass, kIxx, kIyy, kWheelRadius,
    kCgX, kHalfTrack, kKx, kKy, kKyaw, kKvelx, kQxAcc, kQxV,
    kQomegaSteering = kQxV + 3, kQomegaV, kQyf, kPosQuad,
    kNegQuad = kPosQuad + 2, kUncScale = kNegQuad + 2, kBrakeMax = kUncScale + 5
  };
  static constexpr int kMap = kBrakeMax + 1;
  static constexpr int kSteerNet = kMap + racer::kMapBlock;
  static constexpr int kMeanNet = kSteerNet + SteerNet::kParams;
  static constexpr int kUncNet = kMeanNet + MeanNet::kParams;
  static constexpr int kWarm = kUncNet + UncNet::kParams;
  static constexpr int kTable = kWarm + R;

  struct Shared {
    float p[kTable];
  };

  // every thread of the block; the kernel syncs after
  __device__ static inline void stage(const float* __restrict__ params, Shared* sh) {
    for (int i = threadIdx.x; i < kTable; i += blockDim.x) sh->p[i] = params[i];
  }

  __device__ static inline void init_rec(const Shared& sh, float* rec) {
#pragma unroll 1
    for (int i = 0; i < R; ++i) rec[i] = sh.p[kWarm + i];
  }

  // the warp form's table: each network block at LSTMNet::warp_slot
  __device__ static inline void stage_warp(const float* __restrict__ params, Shared* sh) {
    for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
      int d = i;
      if (i >= kSteerNet && i < kMeanNet) d = kSteerNet + SteerNet::warp_slot(i - kSteerNet);
      if (i >= kMeanNet && i < kUncNet) d = kMeanNet + MeanNet::warp_slot(i - kMeanNet);
      if (i >= kUncNet && i < kWarm) d = kUncNet + UncNet::warp_slot(i - kUncNet);
      sh->p[d] = params[i];
    }
  }

  __device__ static inline void init_rec_warp(const Shared& sh, float* rec) {
    const int o = (threadIdx.x & 31) % H;
#pragma unroll
    for (int i = 0; i < RW; ++i) rec[i] = sh.p[kWarm + i * H + o];
  }

  // the parametric Q (RacerDubinsElevationSuspension._q_matrix), row-major
  __device__ static inline void q_param(const float* p, const float* x, float vel_d,
                                        float* Q) {
    const float vel = x[0];
    const float sin_y = sinf(x[1]), cos_y = cosf(x[1]);
    const float delta = x[4] / p[racer::kSteerAngleScale];
    const float abs_v = fabsf(vel);
    const float side_force =
        abs_v * abs_v * tanf(delta) / p[racer::kWheelBase] + p[racer::kGravity] * sinf(x[7]);
    const float q11 = fabsf(p[kQyf] * fabsf(side_force) * max_nan(abs_v - 2.0f, 0.0f));
    const float q_vv = p[kQxAcc] * fabsf(vel_d) + racer::regime_select(vel, p + kQxV) * abs_v;
    const float q_yy = abs_v * (p[kQomegaSteering] * fabsf(delta) + p[kQomegaV]);
#pragma unroll
    for (int i = 0; i < 16; ++i) Q[i] = 0.0f;
    Q[0] = q_vv;
    Q[5] = q_yy;
    Q[10] = q11 * sin_y * sin_y;
    Q[11] = -q11 * sin_y * cos_y;
    Q[14] = -q11 * sin_y * cos_y;
    Q[15] = q11 * cos_y * cos_y;
  }

  // A = df/dx + df/du K in (vx, yaw, px, py) order (_unc_jacobian), row-major
  __device__ static inline void jacobian(const float* p, const float* x, float* A) {
    const float vel = x[0];
    const float sin_y = sinf(x[1]), cos_y = cosf(x[1]);
    const float delta = x[4] / p[racer::kSteerAngleScale];
    const float tan_d = tanf(delta);
    const float cos_d = cosf(delta);
    const float cos2_d = cos_d * cos_d;
    const float brake_state = clamp_nan(x[5], 0.0f, 0.25f);
    const float L = p[racer::kWheelBase];
    const bool low_regime = fabsf(vel) <= static_cast<float>(0.2);
    A[0] = -racer::regime_select(vel, p + racer::kCv3) - p[kKvelx] -
           (low_regime ? p[racer::kCb3] * brake_state : 0.0f);
    A[1] = 0.0f;
    A[2] = -p[kKx] * cos_y;
    A[3] = -p[kKx] * sin_y;
    A[4] = tan_d / L + 0.0f;
    A[5] = -fabsf(vel) * p[kKyaw] / (L * cos2_d);
    A[6] = vel * p[kKy] * sin_y / (L * cos2_d);
    A[7] = -vel * p[kKy] * cos_y / (L * cos2_d);
    A[8] = cos_y + 0.0f;
    A[9] = -sin_y * vel;
    A[10] = 0.0f;
    A[11] = 0.0f;
    A[12] = sin_y + 0.0f;
    A[13] = cos_y * vel;
    A[14] = 0.0f;
    A[15] = 0.0f;
  }

  // Sigma' = (I + A dt) Sigma (I + A dt)^T + Q dt over the packed entries
  // s10 (propagate_uncertainty), written to out
  __device__ static inline void propagate(const float* s10, const float* A,
                                          const float* Q, float dt, float* out) {
    // (vx, yaw, px, py) order: packed [px, py, yaw, vx, px_py, px_yaw,
    // px_vx, py_yaw, py_vx, yaw_vx]
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
    constexpr int kCarry = kWarp ? 2 : 2 * H;  // the carry of one LSTM
    const float* p = sh.p;
    // the parametric derivatives over the first nine states and the LSTM
    // steering rate (_core_step)
    float vel_d = racer::vel_deriv(p, x[0], x[5], x[8], u[0]);
    float yaw_d = racer::yaw_rate(p, x[0], x[4]);
    const float x_d = x[0] * cosf(x[1]);
    const float y_d = x[0] * sinf(x[1]);
    const float steer_d_param = racer::steer_deriv(p, x, u);
    float steer_d;
    {
      const float feats[4] = {x[0], x[4], u[1], steer_d_param};
      float delta[1];
      lstm_forward<kWarp, SteerNet>(p + kSteerNet, rec, feats, delta);
      steer_d = steer_d_param + delta[0];
    }

    // the suspension on flat ground (_suspension_derivs)
    float cgvz_d = 0.0f, rollrate_d = 0.0f, pitchrate_d = 0.0f;
    float up_max = -INFINITY, fwd_max = -INFINITY, side_max = -INFINITY;
    {
      const float fx = 2.0f * p[kCgX];
      const float ht = p[kHalfTrack];
      const float wbx[4] = {fx, fx, 0.0f, 0.0f};
      const float wby[4] = {-ht, ht, ht, -ht};
      const float cg_z = x[9], cg_vz = x[10], roll = x[7], pitch = x[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wx_cg = wbx[i] - p[kCgX];
        const float wy_cg = wby[i];
        const float h = cg_z - p[kWheelRadius];
        const float wheel_z = cg_z + roll * wy_cg - pitch * wx_cg - p[kWheelRadius];
        const float wheel_vz = cg_vz + x[11] * wy_cg - x[12] * wx_cg;
        const float force = -p[kSpringK] * (wheel_z - h) - p[kDragC] * wheel_vz;
        up_max = max_nan(up_max, force);
        fwd_max = max_nan(fwd_max, fabsf(force * -pitch));
        side_max = max_nan(side_max, fabsf(force * roll));
        cgvz_d = cgvz_d + force / p[kMass];
        rollrate_d = rollrate_d + force * wy_cg / p[kIxx];
        pitchrate_d = pitchrate_d - force * wx_cg / p[kIyy];
      }
    }

    // the quadratic brake
    const float err = (u[0] < 0.0f ? -u[0] : 0.0f) - x[5];
    const float* quad = err > 0.0f ? p + kPosQuad : p + kNegQuad;
    const float brake_d =
        clamp_nan(err * quad[0] + err * fabsf(err) * quad[1],
                  -p[racer::kMaxBrakeRateNeg], p[racer::kMaxBrakeRatePos]);

    // the mean LSTM's correction, forward gear only
    const bool fwd_gear = p[racer::kGearSign] > 0.0f;
    const float throttle = max_nan(u[0], 0.0f);
    const float brake_cmd = max_nan(-u[0], 0.0f);
    {
      const float feats[11] = {x[0], x[23], x[5], x[4], x[6], throttle, brake_cmd, u[1],
                               sinf(x[25]), vel_d, yaw_d};
      float out[2];
      lstm_forward<kWarp, MeanNet>(p + kMeanNet, rec + kCarry, feats, out);
      vel_d = vel_d + (fwd_gear ? out[0] : 0.0f);
      yaw_d = yaw_d + (fwd_gear ? out[1] : 0.0f);
    }

    // the uncertainty LSTM -> Q
    float Q[16];
    if (fwd_gear) {
      const float feats[12] = {x[0], x[23], x[5], x[4], x[6], throttle, brake_cmd, u[1],
                               sinf(x[24]), sinf(x[25]), vel_d, yaw_d};
      float out[5];
      lstm_forward<kWarp, UncNet>(p + kUncNet, rec + 2 * kCarry, feats, out);
      float q[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) q[i] = fabsf(lstm_sigmoid(out[i]) * p[kUncScale + i]);
      const float c_b = racer::regime_select(x[0], p + racer::kCb3) *
                        (fabsf(x[0]) <= static_cast<float>(0.2) ? x[0] : 1.0f);
      const float delta = x[4] / p[racer::kSteerAngleScale];
      const float cos_d = cosf(delta);
      const float yaw_gain =
          (x[0] / p[racer::kWheelBase]) / (cos_d * cos_d * p[racer::kSteerAngleScale]);
      const float sin_y = sinf(x[1]), cos_y = cosf(x[1]);
#pragma unroll
      for (int i = 0; i < 16; ++i) Q[i] = 0.0f;
      Q[0] = q[0] + c_b * c_b * q[4];
      Q[5] = q[1] + yaw_gain * yaw_gain * q[3];
      Q[10] = q[2] * (sin_y * sin_y);
      Q[11] = -q[2] * sin_y * cos_y;
      Q[14] = -q[2] * sin_y * cos_y;
      Q[15] = q[2] * (cos_y * cos_y);
    } else {
      // the LSTM still steps: its (h, c) ride on
      const float feats[12] = {x[0], x[23], x[5], x[4], x[6], throttle, brake_cmd, u[1],
                               sinf(x[24]), sinf(x[25]), vel_d, yaw_d};
      float out[5];
      lstm_forward<kWarp, UncNet>(p + kUncNet, rec + 2 * kCarry, feats, out);
      q_param(p, x, vel_d, Q);
    }
    float A[16];
    jacobian(p, x, A);
    float unc[10];
    propagate(x + 13, A, Q, dt, unc);

    // the Euler update of the first 13 states (_integrate_core)
    const float xd[13] = {vel_d, yaw_d, x_d, y_d, steer_d, brake_d, 0.0f,
                          x[11], x[12], x[10], cgvz_d, rollrate_d, pitchrate_d};
    float core[13];
#pragma unroll
    for (int i = 0; i < 13; ++i) core[i] = x[i] + xd[i] * dt;
    core[1] = normalize_angle(core[1]);
    core[4] = racer::clamp_steer(p, core[4]);
    core[5] = racer::clamp_brake(core[5], p[kBrakeMax]);
    core[6] = steer_d;
#pragma unroll
    for (int i = 0; i < 13; ++i) x[i] = core[i];
#pragma unroll
    for (int i = 0; i < 10; ++i) x[13 + i] = unc[i];
    x[23] = yaw_d;
    x[24] = 0.0f;  // static roll and pitch: flat ground
    x[25] = 0.0f;

    y[0] = x[0];
    y[1] = 0.0f;
    y[2] = x[2];
    y[3] = x[3];
    y[4] = x[9];
    y[5] = x[1];
    y[6] = x[7];
    y[7] = x[8];
    y[8] = x[4];
    y[9] = x[6];
    y[10] = up_max;
    y[11] = fwd_max;
    y[12] = side_max;
    y[13] = vel_d;
    y[14] = 0.0f;
    y[15] = yaw_d;
    y[16] = fabsf(x[0]);
#pragma unroll
    for (int i = 0; i < 10; ++i) y[17 + i] = unc[i];
  }
};
