// The RACER Dubins elevation model with the four-wheel suspension, the LSTM
// steering and the propagated 4 x 4 covariance (RacerDubinsElevationSuspension,
// 23 states), and with kUnc its uncertainty variant (two more LSTMs, 26
// states: racer_lstm_unc.cuh), for the rollout, solve and sampling kernels:
// recurrent models (R = 32, the steering LSTM's h and c; 96 with kUnc).
//
// Device twins of kernel_step_recurrent of RacerDubinsElevationSuspension and
// RacerDubinsElevationLSTMUncertainty in
// mppi_generic_tpu_torch/models/racer_dubins_unc.py (the JAX package's
// step_recurrent, racer_dubins_unc.py:262-302 and :404-519; reference
// racer_dubins_elevation_suspension_lstm.cu, racer_dubins_elevation_lstm_unc.cu):
// the elevation model's nine states, [cg_pos_z, cg_vel_i_z, roll_rate,
// pitch_rate], the ten packed covariance entries and, with kUnc, [omega_z,
// static_roll, static_pitch]; control [throttle_brake, steer_cmd], 27
// outputs. Per step, in the plain version's order:
//   the parametric derivatives and the steering LSTM (4 -> 16, head 20-16-1)
//   correcting the steering rate; the four-wheel spring-damper suspension,
//   its ground under each wheel from the elevation map (four B9 queries,
//   map_query_world; cg_z - wheel_radius where a query is not finite, and
//   everywhere on flat ground); the brake (kUnc: the quadratic brake; else
//   the parametric lag); with kUnc the mean LSTM (11 -> 16, head 27-16-2)
//   correcting the velocity and yaw rates in forward gear and the
//   uncertainty LSTM (12 -> 16, head 28-16-5) whose sigmoid-scaled outputs
//   give Q (the parametric Q in reverse gear); else the parametric Q
//   (racer::parametric_q); the Jacobian A; Sigma' = (I + A dt) Sigma
//   (I + A dt)^T + Q dt (racer::propagate); the Euler update, the yaw wrap,
//   the steer and brake clamps; with kUnc, static settling of the static roll
//   and pitch on the map (zeros on flat ground).
// The map block of the table switches the map on, as for the steering model:
// flat ground and a map run the same code.
//
// The table (kernel_params): the params (45 floats; kUnc 55), the brake
// limit, the map block (20), the LSTMs' tables (1,697; kUnc also 2,274 and
// 2,405 floats) and the warm (h, c) of each (32; kUnc 96): 1,795 floats
// (kUnc 6,547, 26 KB of shared memory per block, under the 48 KB of static
// shared memory). The state, the outputs and the carry do not fit the
// registers with the step's temporaries: the carry and the LSTMs' hidden
// vectors live in local memory (L1). The map data comes apart
// (ModelArgs::dyn_map).
//
// step_warp is the step of the warp forms (B1, B3, B4: one warp per sample;
// the split dynamics passes of split_warp.cuh): the LSTMs by
// LSTMNet::forward_warp from stage_warp's table (the network blocks laid out
// for it, the rest in place), the carry (h, c) of this lane's unit for each
// (RW = 2; kUnc 6 floats against R = 96); the suspension, the brake, the
// Jacobian, the covariance and the Euler update the same operations on every
// lane.
#pragma once

#include <math.h>

#include "lstm.cuh"
#include "map_texture.cuh"
#include "math_utils.cuh"
#include "racer_elevation.cuh"

template <bool kUnc>
struct RacerElevSuspT {
  static constexpr int S = kUnc ? 26 : 23;  // state
  static constexpr int C = 2;               // control
  static constexpr int O = 27;              // output
  static constexpr int H = 16;              // each LSTM's hidden units
  // (h, c) of the steering LSTM, and with kUnc of the mean and uncertainty LSTMs
  static constexpr int R = (kUnc ? 6 : 2) * H;
  static constexpr int RW = kUnc ? 6 : 2;  // the warp form's: this lane's unit of each
  static constexpr bool kStaged = true;
  static constexpr bool kWarpStep = true;  // has stage_warp / step_warp
  static constexpr int kWarpSamples = 8;   // samples (warps) per block there
  static constexpr bool kDynMap = true;
  using SteerNet = LSTMNet<4, H, 16, 1>;
  using MeanNet = LSTMNet<11, H, 16, 2>;
  using UncNet = LSTMNet<12, H, 16, 5>;
  // the params beyond the elevation model's (models/racer_dubins_unc.py)
  enum {
    kSpringK = racer::kElevationParams, kDragC, kMass, kIxx, kIyy, kWheelRadius,
    kCgX, kHalfTrack, kKx, kKy, kKyaw, kKvelx, kQxAcc, kQxV,
    kQomegaSteering = kQxV + 3, kQomegaV, kQyf, kPosQuad,
    kNegQuad = kPosQuad + 2, kUncScale = kNegQuad + 2
  };
  static constexpr int kBrakeMax = kUnc ? kUncScale + 5 : kPosQuad;
  static constexpr int kMap = kBrakeMax + 1;
  static constexpr int kSteerNet = kMap + racer::kMapBlock;
  static constexpr int kMeanNet = kSteerNet + SteerNet::kParams;
  static constexpr int kUncNet = kMeanNet + (kUnc ? MeanNet::kParams : 0);
  static constexpr int kWarm = kUncNet + (kUnc ? UncNet::kParams : 0);
  static constexpr int kTable = kWarm + R;

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

  __device__ static inline void init_rec(const Shared& sh, float* rec) {
#pragma unroll 1
    for (int i = 0; i < R; ++i) rec[i] = sh.p[kWarm + i];
  }

  // the warp form's table: each network block at LSTMNet::warp_slot
  __device__ static inline void stage_warp(const float* __restrict__ params, const float* map,
                                           Shared* sh) {
    for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
      int d = i;
      if (i >= kSteerNet && i < kMeanNet) d = kSteerNet + SteerNet::warp_slot(i - kSteerNet);
      if (i >= kMeanNet && i < kUncNet) d = kMeanNet + MeanNet::warp_slot(i - kMeanNet);
      if (i >= kUncNet && i < kWarm) d = kUncNet + UncNet::warp_slot(i - kUncNet);
      sh->p[d] = params[i];
    }
    if (threadIdx.x == 0) sh->map = map;
  }

  __device__ static inline void init_rec_warp(const Shared& sh, float* rec) {
    const int o = (threadIdx.x & 31) % H;
#pragma unroll
    for (int i = 0; i < RW; ++i) rec[i] = sh.p[kWarm + i * H + o];
  }

  // the parametric Q (RacerDubinsElevationSuspension._q_matrix), row-major
  __device__ static inline void q_param(const float* p, const float* x, float vel_d,
                                        float* Q) {
    racer::parametric_q(p + kQxAcc, p[racer::kSteerAngleScale], p[racer::kWheelBase],
                        p[racer::kGravity], x[0], x[1], x[4], x[7], vel_d, Q);
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

    // the suspension (_suspension_derivs): the ground under each wheel from
    // the map, or at cg_z - wheel_radius
    const bool has_map = __float_as_int(p[kMap]) != 0;
    float cgvz_d = 0.0f, rollrate_d = 0.0f, pitchrate_d = 0.0f;
    float up_max = -INFINITY, fwd_max = -INFINITY, side_max = -INFINITY;
    {
      const float fx = 2.0f * p[kCgX];
      const float ht = p[kHalfTrack];
      const float wbx[4] = {fx, fx, 0.0f, 0.0f};
      const float wby[4] = {-ht, ht, ht, -ht};
      const float cg_z = x[9], cg_vz = x[10], roll = x[7], pitch = x[8];
      MapTex m;
      float cos_y = 0.0f, sin_y = 0.0f;
      if (has_map) {
        m = load_map_tex(p + kMap + 1, sh.map);
        cos_y = cosf(x[1]);
        sin_y = sinf(x[1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wx_cg = wbx[i] - p[kCgX];
        const float wy_cg = wby[i];
        float h = cg_z - p[kWheelRadius];
        if (has_map) {
          const float q = map_query_world(m, x[2] + wbx[i] * cos_y - wby[i] * sin_y,
                                          x[3] + wbx[i] * sin_y + wby[i] * cos_y);
          if (isfinite(q)) h = q;
        }
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

    float brake_d;
    float Q[16];
    if constexpr (kUnc) {
      // the quadratic brake
      const float err = (u[0] < 0.0f ? -u[0] : 0.0f) - x[5];
      const float* quad = err > 0.0f ? p + kPosQuad : p + kNegQuad;
      brake_d = clamp_nan(err * quad[0] + err * fabsf(err) * quad[1],
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

      // the uncertainty LSTM -> Q; it steps in either gear, its (h, c) ride on
      const float feats[12] = {x[0], x[23], x[5], x[4], x[6], throttle, brake_cmd, u[1],
                               sinf(x[24]), sinf(x[25]), vel_d, yaw_d};
      float out[5];
      lstm_forward<kWarp, UncNet>(p + kUncNet, rec + 2 * kCarry, feats, out);
      if (fwd_gear) {
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
        q_param(p, x, vel_d, Q);
      }
    } else {
      brake_d = racer::brake_deriv(p, u[0], x[5]);
      q_param(p, x, vel_d, Q);
    }
    float A[16];
    jacobian(p, x, A);
    float unc[10];
    racer::propagate(x + 13, A, Q, dt, unc);

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
    if constexpr (kUnc) {
      // the static roll and pitch, settled with the new position and yaw and
      // the old static roll and pitch (zeros on flat ground)
      float settled[3];
      racer::static_settling(p + kMap, sh.map, core[2], core[3], core[1], x[24], x[25],
                             settled);
      x[23] = yaw_d;
      x[24] = settled[0];
      x[25] = settled[1];
    }
#pragma unroll
    for (int i = 0; i < 13; ++i) x[i] = core[i];
#pragma unroll
    for (int i = 0; i < 10; ++i) x[13 + i] = unc[i];

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

using RacerElevSusp = RacerElevSuspT<false>;
