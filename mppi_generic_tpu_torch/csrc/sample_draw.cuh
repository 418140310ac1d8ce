// The in-kernel draw of the fused sampling kernels (B3, B4: sample_kernels.cuh;
// their staged forms: sample_staged.cuh; B4's warp form: sample_warp.cuh;
// B3's split pass: split_kernels.cuh, split_warp.cuh): the sampling
// arguments, a step's normals and B3's and B4's state-free controls of a
// step.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mppi_common.cuh"
#include "philox.cuh"

namespace {

constexpr int kGaussian = 0, kNLN = 1, kSmooth = 2;

struct SampleArgs {
  const float* mean;    // (T, C) control mean
  const float* sigma;   // (T, C) std-dev of this iteration
  const float* aux;     // (T, C) NLN: raw std-dev; Smooth: derivative mean
  const float* lr_tab;  // B3: (T, C) coeff / sigma^2; B4: (C,) coeff
  const float* cons;    // (4, C) [lo; hi; deadband; zero control]
  const int* seed;      // () the iteration's seed, on the device
  const float* zinj;    // (n_z, K, T, C) injected normals, or null
  int stride;           // steps t < stride are pinned to the mean
  float pure_thresh;    // (1 - p) K: samples k >= it carry no mean
  float dt_smooth;      // Smooth-MPPI's derivative-integration step
};

// eps[c] of sample k at step t: the standard normal, or NLN's
// z * expf(aux * z2)
template <int C, int NOISE>
__device__ inline void draw_eps(const SampleArgs& a, uint32_t seed, int k,
                                int K, int T, int t, float* eps) {
  float z[C];
  float z2[C];
  if (a.zinj != nullptr) {
    const size_t off = (static_cast<size_t>(k) * T + t) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) z[c] = a.zinj[off + c];
    if (NOISE == kNLN) {
      const size_t off2 = static_cast<size_t>(K) * T * C + off;
#pragma unroll
      for (int c = 0; c < C; ++c) z2[c] = a.zinj[off2 + c];
    }
  } else {
    philox_normals<C, NOISE == kNLN>(seed, k, t, z, z2);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    eps[c] = NOISE == kNLN ? z[c] * expf(a.aux[t * C + c] * z2[c]) : z[c];
  }
}

// B4's controls of sample k at step t, which depend on no state: the draw,
// the carve-outs (Smooth-MPPI in derivative space, its W unclamped), the
// clamp into u[C], and the step's LR cost scaled by lr_gain, returned.
// Writes the step's U row and (Smooth) W row where they are given.
template <int C, int NOISE>
__device__ inline float sample_controls(const SampleArgs& a, uint32_t seed, int k,
                                        int K, int T, int t, bool pure, float lr_gain,
                                        float* U, float* W, float* u) {
  float eps[C];
  draw_eps<C, NOISE>(a, seed, k, K, T, t, eps);
  const bool pin = k == 0 || t < a.stride;
  const size_t off = (static_cast<size_t>(k) * T + t) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float m = a.mean[t * C + c];
    const float noise = a.sigma[t * C + c] * eps[c];
    float v;
    if (NOISE == kSmooth) {
      const float dm = a.aux[t * C + c];
      const float w = pin ? dm : (pure ? noise : dm + noise);
      if (W != nullptr) W[off + c] = w;
      v = m + w * a.dt_smooth;
    } else {
      v = pin ? m : (pure ? noise : m + noise);
    }
    v = clamp_channel(v, a.cons, C, c);
    u[c] = v;
    if (U != nullptr) U[off + c] = v;
  }
  float lr_t = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float mu = pure ? 0.0f : a.mean[t * C + c];
    const float sg = a.sigma[t * C + c];
    lr_t = lr_t + a.lr_tab[c] * mu * (mu - 2.0f * u[c]) / (sg * sg);
  }
  return lr_gain * lr_t;
}

// B3's controls of sample k at step t, which depend on no state: the draw,
// the carve-outs and the clamp into u[C], written to the step's U row, and
// the step's C LR terms lrc mu (mu - 2 u) into terms[C], which B3 sums apart
// in (t, c) order.
template <int C, int NOISE>
__device__ inline void solve_controls(const SampleArgs& a, uint32_t seed, int k, int K,
                                      int T, int t, bool pure, float* U, float* u,
                                      float* terms) {
  float eps[C];
  draw_eps<C, NOISE>(a, seed, k, K, T, t, eps);
  const bool pin = k == 0 || t < a.stride;
  const size_t off = (static_cast<size_t>(k) * T + t) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float m = a.mean[t * C + c];
    const float noise = a.sigma[t * C + c] * eps[c];
    const float mu = pure ? 0.0f : m;
    float v = pin ? m : (pure ? noise : m + noise);
    v = clamp_channel(v, a.cons, C, c);
    u[c] = v;
    U[off + c] = v;
    terms[c] = a.lr_tab[t * C + c] * mu * (mu - 2.0f * v);
  }
}

}  // namespace
