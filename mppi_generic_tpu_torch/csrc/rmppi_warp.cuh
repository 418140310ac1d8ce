// The warp form of the RMPPI augmented rollout (B8) for the network models:
// one warp per sample, one network output unit per lane, both systems on the
// same lanes.
//
// Replaces, for a model whose step is a network (AutoRally's FNN,
// rmppi_rollout.cu), the one-thread rmppi_rollout_kernel (rmppi_kernel.cuh),
// the counterpart of the TPU kernel
// mppi_generic_tpu/ops/pallas_rollout.py::_fused_rmppi_call (:2127, entry
// fused_rmppi_rollout :2352). One thread per sample ran two networks per
// sample-step as serial chains, on 30 blocks of 64 threads at K = 1920.
//
// rmppi_rollout_warp_kernel<Dyn, Cost>: blocks of the model's kWarpSamples
// samples, one warp each, the table staged once per block
// (stage_model_warp). The raw sample and its clamp depend on no state, so
// each chunk of 32 steps starts with lane j reading and clamping step
// t0 + j (coalesced) and step t takes u_raw and u_nom by __shfl_sync from
// lane t - t0. The feedback dx, u_fb = K[t] dx, its cost and u_real depend
// on the state and run on every lane (the gain and sigma tables read at one
// address a warp); lane 0 writes U_real. Then the two network steps
// (Dyn::step_warp) and the two running costs on every lane, each with its
// own sticky crash counter, in rmppi_rollout_kernel's order, so every output
// is the float of the one-thread kernel and of rmppi_rollout_plain. Lane 0
// writes s_nom, j_real, s_fb and the real system's crash flag.
//
// What bounds it on this card: operations (two networks per sample-step,
// each multiply-add a shared-memory load, a shuffle and a separate multiply
// and add, and two costs on every lane).
//
// The k >= K test is the same on every lane of a warp and comes after the
// staging barrier; no block barrier follows, so a warp past K leaves whole.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "mppi_common.cuh"
#include "warp.cuh"
#include "warp_model.cuh"

namespace {

template <class Dyn, class Cost>
__global__ void __launch_bounds__(32 * Dyn::kWarpSamples)
rmppi_rollout_warp_kernel(const float* __restrict__ x0_nom,
                          const float* __restrict__ x0_real,
                          const float* __restrict__ U, int K, int T, float dt,
                          ModelArgs m, const float* __restrict__ cons,
                          const float* __restrict__ gains,
                          const float* __restrict__ sigma,
                          const float* __restrict__ coeff, float fb_gain,
                          float* __restrict__ s_nom_out,
                          float* __restrict__ j_real_out,
                          float* __restrict__ s_fb_out, int* __restrict__ crash_out,
                          float* __restrict__ U_real) {
  static_assert(WarpRecDim<Dyn>::value == 0, "B8's recurrent carry is not ported");
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * Dyn::kWarpSamples + (threadIdx.x >> 5);

  __shared__ typename Dyn::Shared dyn_sh;
  stage_model_warp<Dyn>(m, &dyn_sh);
  __syncthreads();
  if (k >= K) return;  // the whole warp

  const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
  float x_nom[S], x_real[S], y_nom[O], y_real[O];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    x_nom[i] = x0_nom[i];
    x_real[i] = x0_real[i];
  }
#pragma unroll
  for (int i = 0; i < O; ++i) {
    y_nom[i] = 0.0f;
    y_real[i] = 0.0f;
  }
  int crash_n = 0;
  int crash_r = 0;
  float s_nom = 0.0f;
  float j_real = 0.0f;
  float s_fb = 0.0f;
  const size_t row = static_cast<size_t>(k) * T * C;
  float raw_lane[C], nom_lane[C];  // this lane's step of the chunk
#pragma unroll
  for (int c = 0; c < C; ++c) raw_lane[c] = nom_lane[c] = 0.0f;
  for (int t = 0; t < T; ++t) {
    // a compiler barrier, as in split_dynamics_warp_kernel: the staged weights
    // are read from shared memory each step, not hoisted and spilled
    asm volatile("" ::: "memory");
    const int j = t & 31;
    if (j == 0 && t + lane < T) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        raw_lane[c] = U[row + (t + lane) * C + c];
        nom_lane[c] = clamp_channel(raw_lane[c], cons, C, c);
      }
    }
    float u_raw[C], u_nom[C], u_real[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      u_raw[c] = __shfl_sync(kFullMask, raw_lane[c], j);
      u_nom[c] = __shfl_sync(kFullMask, nom_lane[c], j);
    }
    float dx[S];
#pragma unroll
    for (int s = 0; s < S; ++s) dx[s] = x_real[s] - x_nom[s];
    float fb = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* g = gains + (t * C + c) * S;
      float u_fb = g[0] * dx[0];
#pragma unroll
      for (int s = 1; s < S; ++s) u_fb = u_fb + g[s] * dx[s];
      const float sg = sigma[t * C + c];
      fb = fb + coeff[c] * u_fb * u_fb / (sg * sg);
      u_real[c] = clamp_channel(u_raw[c] + u_fb, cons, C, c);
      if (lane == 0) U_real[row + t * C + c] = u_real[c];
    }
    fb = fb_gain * fb;
    Dyn::step_warp(dyn_sh, x_nom, nullptr, u_nom, static_cast<float>(t), dt, y_nom);
    Dyn::step_warp(dyn_sh, x_real, nullptr, u_real, static_cast<float>(t), dt, y_real);
    const float c_nom = Cost::running_cost(cp, y_nom, u_nom, t, &crash_n);
    const float c_real = Cost::running_cost(cp, y_real, u_real, t, &crash_r);
    s_nom = s_nom + c_nom;
    j_real = j_real + c_real;
    s_fb = s_fb + c_real + fb;
  }
  if (lane == 0) {
    const float term_n = Cost::terminal_cost(cp, y_nom);
    const float term_r = Cost::terminal_cost(cp, y_real);
    const float Tf = static_cast<float>(T);
    s_nom_out[k] = (s_nom + term_n) / Tf;
    j_real_out[k] = (j_real + term_r) / Tf;
    s_fb_out[k] = (s_fb + term_r) / Tf;
    crash_out[k] = crash_r;
  }
}

}  // namespace
