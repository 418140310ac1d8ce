// The full-suspension racer (a 14-state rigid body on four spring-damper
// wheels) for the rollout, solve and sampling kernels (their staged forms,
// sample_staged.cuh).
//
// Device twin of RacerSuspensionDynamics.step in
// mppi_generic_tpu_torch/models/racer_suspension.py (the JAX package's
// models/racer_suspension.py:47-352, reference racer_suspension.cu:31-300),
// the same operations in the same order, one rounding each (--fmad=false):
// state [pos (3), quaternion (4, w x y z), velocity (3), body rates (3),
// steering angle], control [throttle_brake, steer_cmd], 26 outputs. One force
// pass a step at the pre-step state: the rotation R of the quaternion; the
// engine force (the brake term with the sign of the body velocity, 0 at 0);
// for each wheel, unrolled, its nominal position, the terrain height under
// it (a B9 query, map_query_world, when the table's map block has a map;
// flat ground otherwise), the spring-damper force clamped at 0, the
// Ackermann angle of a front wheel (atan2_approx, the sign of the
// denominator 1 at 0), the contact frame (its norm + 1e-9), the Stribeck
// lateral force and the longitudinal force clamped to the friction cone, the
// force and torque in the body; the rigid-body derivative; then the outputs
// from that pass (the base link's velocity and position, yaw, roll, pitch by
// atan2_approx / asin_approx, the wheels' positions and forces) and the
// Euler update with the quaternion renormalized (its norm + 1e-12).
//
// The table (kernel_params): the packed params (PARAMS of the model: 6
// scalars, k_s (4), c_s (4), 7 scalars, then the brake limit, 24 floats) and
// the map block (20, racer_elevation.cuh); the map data comes apart
// (ModelArgs::dyn_map).
#pragma once

#include <math.h>

#include "map_texture.cuh"
#include "math_utils.cuh"
#include "racer_elevation.cuh"

struct RacerSuspension {
  static constexpr int S = 14;  // state
  static constexpr int C = 2;   // control
  static constexpr int O = 26;  // output
  static constexpr bool kStaged = true;
  static constexpr bool kDynMap = true;
  enum {
    kWheelRadius, kMass, kWheelBase, kWidth, kHeight, kGravity, kKs, kCs = kKs + 4,
    kMu = kCs + 4, kVSlip, kCt, kCb, kCv, kC0, kGearSign, kSteeringConst, kSteerCmdScale,
    kBrakeMax, kMap, kTable = kMap + racer::kMapBlock
  };

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

  // torch.sign: 0 at 0
  __device__ static inline float sign0(float v) {
    return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  }

  __device__ static inline void step(const Shared& sh, float* x, const float* u,
                                     float /*t*/, float dt, float* y) {
    const float* p = sh.p;
    const float px = x[0], py = x[1], pz = x[2];
    const float qw = x[3], qx = x[4], qy = x[5], qz = x[6];
    const float vx = x[7], vy = x[8], vz = x[9];
    const float wx = x[10], wy = x[11], wz = x[12];
    const float steer_angle = x[13];

    const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    const float r01 = 2.0f * (qx * qy - qw * qz);
    const float r02 = 2.0f * (qx * qz + qw * qy);
    const float r10 = 2.0f * (qx * qy + qw * qz);
    const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
    const float r12 = 2.0f * (qy * qz - qw * qx);
    const float r20 = 2.0f * (qx * qz - qw * qy);
    const float r21 = 2.0f * (qy * qz + qw * qx);
    const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);

    const float tan_delta = tanf(steer_angle);
    const float vel_bx = r00 * vx + r10 * vy + r20 * vz;
    const float throttle = max_nan(u[0], 0.0f);
    const float brake = max_nan(-u[0], 0.0f);
    const float acc =
        p[kCt] * throttle - sign0(vel_bx) * p[kCb] * brake - p[kCv] * vel_bx + p[kC0];
    const float propulsion_force = p[kMass] * acc;

    const float wb = p[kWheelBase];
    const float cgx = wb / 2.0f;
    const float cgy = 0.0f;
    const float cgz = 0.0f + static_cast<float>(0.2);
    const float half_w = p[kWidth] / 2.0f;
    const bool has_map = __float_as_int(p[kMap]) != 0;
    MapTex m;
    if (has_map) m = load_map_tex(p + kMap + 1, sh.map);
    // the terrain normal e_z in the body, R^T (0, 0, 1)
    const float nbx = r00 * 0.0f + r10 * 0.0f + r20 * 1.0f;
    const float nby = r01 * 0.0f + r11 * 0.0f + r21 * 1.0f;
    const float nbz = r02 * 0.0f + r12 * 0.0f + r22 * 1.0f;

    float fB0 = 0.0f, fB1 = 0.0f, fB2 = 0.0f;
    float tau0 = 0.0f, tau1 = 0.0f, tau2 = 0.0f;
    float wheel_pos[8], wheel_force[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float wpx = i < 2 ? wb : 0.0f;
      const float wpy = (i & 1) ? -half_w : half_w;
      const float wpz = 0.0f;
      const float bx = wpx - cgx, by = wpy - cgy, bz = wpz - cgz;
      const float pwx = px + (r00 * bx + r01 * by + r02 * bz);
      const float pwy = py + (r10 * bx + r11 * by + r12 * bz);
      const float pwz = pz + (r20 * bx + r21 * by + r22 * bz);
      const float h = has_map ? map_query_world(m, pwx, pwy) : 0.0f;
      const float l = pwz - h;
      const float ox = wy * bz - wz * by;
      const float oy = wz * bx - wx * bz;
      const float oz = wx * by - wy * bx;
      const float pdx = vx + (r00 * ox + r01 * oy + r02 * oz);
      const float pdy = vy + (r10 * ox + r11 * oy + r12 * oz);
      const float pdz = vz + (r20 * ox + r21 * oy + r22 * oz);
      const float l_dot = pdz - 0.0f;
      const float l0 = p[kWheelRadius] + p[kMass] / 4.0f * (-p[kGravity]) / p[kKs + i];
      const float f_k = max_nan(-p[kKs + i] * (l - l0) - p[kCs + i] * l_dot, 0.0f);

      float delta = 0.0f;
      if (i < 2) {  // Ackermann, front left then front right
        const float half = tan_delta * p[kWidth] / 2.0f;
        const float den = i == 0 ? wb - half : wb + half;
        delta = atan2_approx(wb * tan_delta * sign(den), fabsf(den));
      }
      const float wdx = cosf(delta), wdy = sinf(delta);
      float sx = nby * 0.0f - nbz * wdy;
      float sy = nbz * wdx - nbx * 0.0f;
      float sz = nbx * wdy - nby * wdx;
      const float s_norm = sqrtf(sx * sx + sy * sy + sz * sz) + static_cast<float>(1e-9);
      sx = sx / s_norm;
      sy = sy / s_norm;
      sz = sz / s_norm;
      const float tx = sy * nbz - sz * nby;
      const float ty = sz * nbx - sx * nbz;
      const float tz = sx * nby - sy * nbx;

      const float cvx = r00 * pdx + r10 * pdy + r20 * 0.0f;
      const float cvy = r01 * pdx + r11 * pdy + r21 * 0.0f;
      const float cvz = r02 * pdx + r12 * pdy + r22 * 0.0f;
      const float v_w_s = sx * cvx + sy * cvy + sz * cvz;
      const float f_n = f_k;
      const float mu = p[kMu];
      const float mu_s = clamp_nan(v_w_s / p[kVSlip] * mu, -mu, mu);
      const float f_s = -mu_s * f_n;
      const float f_t = clamp_nan(propulsion_force / 4.0f, -mu * f_n, mu * f_n);
      const float fbx = tx * f_t + sx * f_s + nbx * f_n;
      const float fby = ty * f_t + sy * f_s + nby * f_n;
      const float fbz = tz * f_t + sz * f_s + nbz * f_n;

      const float dx = pwx - px, dy = pwy - py, dz = h - pz;
      const float pcx = r00 * dx + r10 * dy + r20 * dz;
      const float pcy = r01 * dx + r11 * dy + r21 * dz;
      const float pcz = r02 * dx + r12 * dy + r22 * dz;
      fB0 = fB0 + fbx;
      fB1 = fB1 + fby;
      fB2 = fB2 + fbz;
      tau0 = tau0 + pcy * fbz - pcz * fby;
      tau1 = tau1 + pcz * fbx - pcx * fbz;
      tau2 = tau2 + pcx * fby - pcy * fbx;
      wheel_pos[2 * i] = pwx;
      wheel_pos[2 * i + 1] = pwy;
      wheel_force[i] = sqrtf(fbx * fbx + fby * fby + fbz * fbz);
    }

    const float mass = p[kMass];
    const float fwx = r00 * fB0 + r01 * fB1 + r02 * fB2;
    const float fwy = r10 * fB0 + r11 * fB1 + r12 * fB2;
    const float fwz = r20 * fB0 + r21 * fB1 + r22 * fB2;
    float xd[S];
    xd[0] = vx;
    xd[1] = vy;
    xd[2] = vz;
    xd[3] = 0.5f * (-qx * wx - qy * wy - qz * wz);
    xd[4] = 0.5f * (qw * wx + qy * wz - qz * wy);
    xd[5] = 0.5f * (qw * wy - qx * wz + qz * wx);
    xd[6] = 0.5f * (qw * wz + qx * wy - qy * wx);
    xd[7] = fwx / mass;
    xd[8] = fwy / mass;
    xd[9] = fwz / mass + p[kGravity];
    const float h_ = p[kHeight], w_ = p[kWidth];
    const float Jxx = mass / 12.0f * (h_ * h_ + w_ * w_);
    const float Jyy = mass / 12.0f * (h_ * h_ + wb * wb);
    const float Jzz = mass / 12.0f * (wb * wb + w_ * w_);
    const float jw_x = Jxx * wx, jw_y = Jyy * wy, jw_z = Jzz * wz;
    xd[10] = (jw_y * wz - jw_z * wy + tau0) / Jxx;
    xd[11] = (jw_z * wx - jw_x * wz + tau1) / Jyy;
    xd[12] = (jw_x * wy - jw_y * wx + tau2) / Jzz;
    const float steer = u[1] / p[kSteerCmdScale];
    xd[13] = p[kSteeringConst] * (steer - steer_angle);

    // the outputs of this pass, at the pre-step state
    const float blx = -cgx, bly = -cgy, blz = -cgz;
    const float cvx = r00 * vx + r10 * vy + r20 * vz;
    const float cvy = r01 * vx + r11 * vy + r21 * vz;
    const float cvz = r02 * vx + r12 * vy + r22 * vz;
    y[0] = cvx + wy * blz - wz * bly;
    y[1] = cvy + wz * blx - wx * blz;
    y[2] = cvz + wx * bly - wy * blx;
    y[3] = px + (r00 * blx + r01 * bly + r02 * blz);
    y[4] = py + (r10 * blx + r11 * bly + r12 * blz);
    y[5] = pz + (r20 * blx + r21 * bly + r22 * blz);
    y[6] = atan2_approx(2.0f * (qw * qz + qx * qy), 1.0f - 2.0f * (qy * qy + qz * qz));
    y[7] = atan2_approx(2.0f * (qw * qx + qy * qz), 1.0f - 2.0f * (qx * qx + qy * qy));
    y[8] = asin_approx(2.0f * (qw * qy - qz * qx));
    y[9] = steer_angle;
    y[10] = xd[13];
#pragma unroll
    for (int i = 0; i < 8; ++i) y[11 + i] = wheel_pos[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[19 + i] = wheel_force[i];
    y[23] = xd[7];
    y[24] = xd[8];
    y[25] = wz;

    // explicit Euler and the quaternion renormalized
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x[i] + xd[i] * dt;
    const float norm =
        sqrtf(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]) + static_cast<float>(1e-12);
#pragma unroll
    for (int i = 3; i < 7; ++i) x[i] = x[i] / norm;
  }
};
