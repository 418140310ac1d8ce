// The warp forms of the fused sampling kernel (B4) and of the fused solve
// (B3) for the network models: one warp per sample, one network output unit
// per lane.
//
// Replaces, for the models whose step is a network (AutoRally's FNN, the
// racer LSTMs), the one-thread fused_sample_rollout_kernel
// (sample_kernels.cuh), the counterpart of the TPU kernel
// mppi_generic_tpu/ops/pallas_rollout.py::_fused_sample_call (:1631, entry
// fused_sample_rollout_costs :2457). One thread per sample made each
// sample-step's network one serial chain of multiply-adds on 30 blocks of 64
// threads at K = 1920, a quarter of the card's SMs.
//
// fused_sample_rollout_warp_kernel<Dyn, Cost, NOISE>: a block holds the
// model's kWarpSamples samples, one warp each (AutoRally 4, the racers 8:
// 480 or 240 blocks at K = 1920); the model's table is staged once per block
// (stage_model_warp) and a recurrent model's carry starts from its warm
// (h, c) (init_rec_warp). Nothing in B4's controls depends on the state, so
// each chunk of 32 steps starts with a prologue spread over the lanes: lane
// j makes step t0 + j (t0 = 0, 32, 64, ...) by sample_controls (the draw, the
// carve-outs, the clamp, the step's LR term; the U and W rows written, 32 C
// consecutive floats a chunk), and step t takes u and lr_t by __shfl_sync
// from lane t - t0; lanes past T make nothing. Then the network step
// (Dyn::step_warp: lane o computes unit o of each layer, split_warp.cuh) and
// the running cost, the same operations on every lane (its map queries read
// one address a warp), in fused_sample_rollout_kernel's order. Every value is
// computed once, by the same operations, so every output is the float of the
// one-thread kernel and of the plain version (sample_rollout_plain).
//
// With Smooth-MPPI's epilogue the carry rows stay rows of kBlockSamples = 64
// samples (their layout is BLOCK in ops/fused_rollout.py and flash_combine's),
// which a block of warps does not hold: the carry pass (block_pass.cuh:
// block_carry_tiled_kernel, launched after the warp kernel as its
// programmatic dependent) writes them from the costs and W, the same
// function on the same floats as the one-thread kernel's epilogue
// (write_block_carry).
//
// fused_solve_warp_kernel (below) is B3 on the same blocks, lanes and chunk
// prologue, in place of the one-thread fused_solve_kernel for these models
// (the TPU kernel mppi_generic_tpu/ops/pallas_solve.py::_fused_solve_call),
// and the carry pass writes its carry rows over U.
//
// What bounds it on this card: operations (the network's multiply-adds, each
// a shared-memory load, a shuffle and a separate multiply and add under
// --fmad=false, and the cost on every lane), not the fp32 count PERF.md takes
// as the bound.
//
// The k >= K test is the same on every lane of a warp and comes after the
// staging barrier; no block barrier follows it, so a warp past K leaves
// whole. Every shuffle takes the full mask, in a warp whose lanes are all in
// the branch.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "block_pass.cuh"
#include "mppi_common.cuh"
#include "sample_draw.cuh"
#include "warp.cuh"
#include "warp_model.cuh"

namespace {

template <class Dyn, class Cost, int NOISE>
__global__ void __launch_bounds__(32 * Dyn::kWarpSamples)
fused_sample_rollout_warp_kernel(const float* __restrict__ x0, SampleArgs a, int K,
                                 int T, float dt, ModelArgs m, float lr_gain,
                                 float* __restrict__ costs, int* __restrict__ crash_out,
                                 float* __restrict__ U, float* __restrict__ W) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int RW = WarpRecDim<Dyn>::value;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * Dyn::kWarpSamples + (threadIdx.x >> 5);

  __shared__ typename Dyn::Shared dyn_sh;
  stage_model_warp<Dyn>(m, &dyn_sh);
  __syncthreads();
  if (k >= K) return;  // the whole warp

  const uint32_t seed = static_cast<uint32_t>(*a.seed);
  const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
  float x[S];
  float y[O];
  float rec[RW > 0 ? RW : 1];
  init_rec_warp<Dyn>(dyn_sh, rec);
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x0[i];
#pragma unroll
  for (int i = 0; i < O; ++i) y[i] = 0.0f;
  int crash = 0;
  float acc = 0.0f;
  const bool pure = static_cast<float>(k) >= a.pure_thresh;
  float u_lane[C];  // this lane's step of the chunk: its controls and LR term
  float lr_lane = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) u_lane[c] = 0.0f;
  for (int t = 0; t < T; ++t) {
    // a compiler barrier, as in split_dynamics_warp_kernel: the staged weights
    // are read from shared memory each step, not hoisted and spilled
    asm volatile("" ::: "memory");
    const int j = t & 31;
    if (j == 0 && t + lane < T) {
      lr_lane = sample_controls<C, NOISE>(a, seed, k, K, T, t + lane, pure, lr_gain, U, W,
                                          u_lane);
    }
    float u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = __shfl_sync(kFullMask, u_lane[c], j);
    const float lr_t = __shfl_sync(kFullMask, lr_lane, j);
    Dyn::step_warp(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
    acc = acc + Cost::running_cost(cp, y, u, t, &crash) + lr_t;
  }
  if (lane == 0) {
    costs[k] = (acc + Cost::terminal_cost(cp, y)) / static_cast<float>(T);
    crash_out[k] = crash;
  }
}

// B3's warp form, fused_solve_warp_kernel<Dyn, Cost, NOISE>: the fused solve
// iteration (fused_solve_kernel, sample_kernels.cuh; the TPU kernel
// mppi_generic_tpu/ops/pallas_solve.py::_fused_solve_call, :103, call :438)
// on the blocks and lanes of B4's warp form above. B3's controls depend on no
// state either, so lane j of each chunk's prologue makes step t0 + j by
// solve_controls (sample_draw.cuh: the draw or the injected normals, NLN's
// z * expf(aux * z2), the stride and k = 0 pins, the pure-noise tail, the
// clamp, the U row written and the step's C LR terms lrc mu (mu - 2 u)), and
// step t takes the controls and the C terms from lane t - t0 by __shfl_sync;
// lanes past T make nothing. Every lane adds the terms one by one, in (t, c)
// order, into the LR sum kept apart, runs the network step and the running
// cost, and J = (acc + terminal + lr_gain lr) / T: fused_solve_kernel's
// operations in its order, so the costs, crash flags and U are its floats.
// The carry rows (m_b, d_b, num_b[T*C]) stay rows of 64 samples over U:
// the carry pass writes them after this launch (launch_block_carry,
// block_pass.cuh).
template <class Dyn, class Cost, int NOISE>
__global__ void __launch_bounds__(32 * Dyn::kWarpSamples)
fused_solve_warp_kernel(const float* __restrict__ x0, SampleArgs a, int K, int T, float dt,
                        ModelArgs m, float lr_gain, float* __restrict__ costs,
                        int* __restrict__ crash_out, float* __restrict__ U) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int RW = WarpRecDim<Dyn>::value;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * Dyn::kWarpSamples + (threadIdx.x >> 5);

  __shared__ typename Dyn::Shared dyn_sh;
  stage_model_warp<Dyn>(m, &dyn_sh);
  __syncthreads();
  if (k >= K) return;  // the whole warp

  const uint32_t seed = static_cast<uint32_t>(*a.seed);
  const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
  float x[S];
  float y[O];
  float rec[RW > 0 ? RW : 1];
  init_rec_warp<Dyn>(dyn_sh, rec);
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x0[i];
#pragma unroll
  for (int i = 0; i < O; ++i) y[i] = 0.0f;
  int crash = 0;
  float acc = 0.0f;
  float lr = 0.0f;
  const bool pure = static_cast<float>(k) >= a.pure_thresh;
  float u_lane[C];  // this lane's step of the chunk: its controls and LR terms
  float terms_lane[C];
#pragma unroll
  for (int c = 0; c < C; ++c) u_lane[c] = terms_lane[c] = 0.0f;
  for (int t = 0; t < T; ++t) {
    // a compiler barrier, as in split_dynamics_warp_kernel: the staged weights
    // are read from shared memory each step, not hoisted and spilled
    asm volatile("" ::: "memory");
    const int j = t & 31;
    if (j == 0 && t + lane < T) {
      solve_controls<C, NOISE>(a, seed, k, K, T, t + lane, pure, U, u_lane, terms_lane);
    }
    float u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = __shfl_sync(kFullMask, u_lane[c], j);
#pragma unroll
    for (int c = 0; c < C; ++c) lr = lr + __shfl_sync(kFullMask, terms_lane[c], j);
    Dyn::step_warp(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
    acc = acc + Cost::running_cost(cp, y, u, t, &crash);
  }
  if (lane == 0) {
    costs[k] = (acc + Cost::terminal_cost(cp, y) + lr_gain * lr) / static_cast<float>(T);
    crash_out[k] = crash;
  }
}

// B4's warp form for the pair (Dyn, Cost), noise_kind already checked: the
// warp kernel and, with epilogue, the carry pass. Returns the first launch
// error.
template <class Dyn, class Cost>
cudaError_t launch_sample_warp(int noise_kind, bool epilogue, const float* x0,
                               const SampleArgs& a, int K, int T, float dt, ModelArgs m,
                               float lr_gain, float lam_w, float* costs, int* crash,
                               float* U, float* W, float* carry, cudaStream_t s) {
  constexpr int NW = Dyn::kWarpSamples;
  const int nb = (K + NW - 1) / NW;
#define B4_WARP_LAUNCH(NOISE)                                                    \
  fused_sample_rollout_warp_kernel<Dyn, Cost, NOISE><<<nb, 32 * NW, 0, s>>>(     \
      x0, a, K, T, dt, m, lr_gain, costs, crash, U, W)
  if (noise_kind == kGaussian) {
    B4_WARP_LAUNCH(kGaussian);
  } else if (noise_kind == kNLN) {
    B4_WARP_LAUNCH(kNLN);
  } else {
    B4_WARP_LAUNCH(kSmooth);
  }
#undef B4_WARP_LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !epilogue) return err;
  return launch_block_carry<kBlockSamples>(costs, W, K, T * Dyn::C, lam_w, carry, s);
}

// B3's warp form for the pair (Dyn, Cost), noise_kind (Gaussian or NLN)
// already checked: the warp kernel, then the carry pass over U. Returns the
// first launch error.
template <class Dyn, class Cost>
cudaError_t launch_solve_warp(int noise_kind, const float* x0, const SampleArgs& a, int K,
                              int T, float dt, ModelArgs m, float lr_gain, float lam_w,
                              float* costs, int* crash, float* U, float* carry,
                              cudaStream_t s) {
  constexpr int NW = Dyn::kWarpSamples;
  const int nb = (K + NW - 1) / NW;
  if (noise_kind == kGaussian) {
    fused_solve_warp_kernel<Dyn, Cost, kGaussian><<<nb, 32 * NW, 0, s>>>(
        x0, a, K, T, dt, m, lr_gain, costs, crash, U);
  } else {
    fused_solve_warp_kernel<Dyn, Cost, kNLN><<<nb, 32 * NW, 0, s>>>(
        x0, a, K, T, dt, m, lr_gain, costs, crash, U);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_block_carry<kBlockSamples>(costs, U, K, T * Dyn::C, lam_w, carry, s);
}

}  // namespace
