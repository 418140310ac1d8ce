// The warp form of the split dynamics passes (split_kernels.cuh) for the
// network models: one warp per sample, one network output unit per lane.
//
// Replaces, for the models whose step is a network (AutoRally's FNN, the
// racer LSTMs: B10 inside B1's and B3's split dynamics passes), the
// one-thread split_dynamics_kernel and split_solve_dynamics_kernel: the
// dynamics pass of the split mode of the TPU kernels
// mppi_generic_tpu/ops/pallas_rollout.py::_fused_call (run_tile, :663-696)
// and mppi_generic_tpu/ops/pallas_solve.py::_fused_solve_call (:274-290).
// On the TPU each network layer is one MXU product over a 128-sample tile;
// one thread per sample made each sample-step's network one serial chain of
// multiply-adds (1,344 for AutoRally's 6-32-32-4 FNN, about 1,600 per racer
// LSTM) on 30 blocks of 64 threads at K = 1920, a quarter of the card's SMs.
//
// The design: a block holds W samples, one warp each (the model's
// kWarpSamples: 4 for AutoRally, 8 for the racer models: 480 or 240 blocks
// at K = 1920). The model's table is staged into shared memory once per block (Dyn::stage_warp, the network blocks laid out so
// that the lanes read consecutive words). Lane o of a warp computes output
// unit o of each layer (fnn.cuh / lstm.cuh forward_warp): its inputs summed
// left to right as the one-thread form sums them, the layer's inputs taken
// by __shfl_sync from lane j in the order j = 0..N-1; no dot product is
// split across lanes and no tensor core is used, so every value is the
// float of the one-thread form and of the plain versions (split_rollout_plain
// and fused_solve_split_plain). Everything else in the step (kinematics,
// suspension, Jacobian, covariance, Euler update, clamps, the racer's map
// queries) runs the same operations on the same values on every lane. B3's
// pass draws, carves out, clamps and sums the LR term on every lane in
// fused_solve_kernel's order; lane 0 writes U and lr_out. Each step's
// outputs go to a double-buffered shared tile, and the block writes Y
// (T, O, K) from it, W consecutive samples per (t, o) row.
//
// What bounds it on this card: each multiply-add is a shared-memory load,
// a shuffle (for a layer's input from another lane) and a separate multiply
// and add (--fmad=false), so the load/store pipe and the chain of adds of
// the widest layer bound a step, not the fp32 operation count that PERF.md
// takes as the bound.
//
// The k >= K test is the same on every lane of a warp and comes after the
// staging and its barrier; a warp past K skips the step but keeps to the
// block's barriers. Every shuffle takes the full mask, in a warp whose 32
// lanes are all in the branch.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mppi_common.cuh"
#include "sample_draw.cuh"
#include "warp.cuh"
#include "warp_model.cuh"

namespace {

// The split passes take the warp form where the model has it
// (HasWarpStep, warp_model.cuh). A build with MPPI_SPLIT_ONE_THREAD defined
// gives every model the one-thread passes: chip_smoke.py builds the network
// pairs' split sources so to time the two forms against each other; the
// port never loads such a build. The define changes no other kernel's form.
#ifdef MPPI_SPLIT_ONE_THREAD
template <class D>
constexpr bool kSplitWarp = false;
#else
template <class D>
constexpr bool kSplitWarp = HasWarpStep<D>::value;
#endif

// Y[t, :, base + i] for the block's valid samples from the step's tile
// ys[o][i]: thread (o, i) writes one float, W neighbours a row
template <int O, int W>
__device__ inline void store_outputs(float (*ys)[W], int t, int K, int base,
                                     int n_valid, float* __restrict__ Y) {
  for (int idx = threadIdx.x; idx < O * W; idx += 32 * W) {
    const int o = idx / W;
    const int i = idx % W;
    if (i < n_valid) Y[(static_cast<size_t>(t) * O + o) * K + base + i] = ys[o][i];
  }
}

template <class Dyn, bool X0>
__global__ void __launch_bounds__(32 * Dyn::kWarpSamples)
split_dynamics_warp_kernel(const float* __restrict__ x0, const float* __restrict__ U,
                           int K, int T, float dt, ModelArgs m,
                           float* __restrict__ Y) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int RW = WarpRecDim<Dyn>::value;
  constexpr int W = Dyn::kWarpSamples;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int base = blockIdx.x * W;
  const int k = base + w;

  __shared__ typename Dyn::Shared dyn_sh;
  __shared__ float y_s[2][O][W];  // the step's outputs, double-buffered
  stage_model_warp<Dyn>(m, &dyn_sh);
  __syncthreads();
  const bool valid = k < K;  // the same on every lane of the warp
  const int n_valid = min(W, K - base);

  float x[S];
  float rec[RW > 0 ? RW : 1];
  init_rec_warp<Dyn>(dyn_sh, rec);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    x[i] = !valid ? 0.0f : X0 ? x0[static_cast<size_t>(k) * S + i] : x0[i];
  }
  const float* u_row = U + static_cast<size_t>(valid ? k : 0) * T * C;
  for (int t = 0; t < T; ++t) {
    // a compiler barrier, as in split_dynamics_kernel: the staged weights
    // are read from shared memory each step, not hoisted and spilled
    asm volatile("" ::: "memory");
    float(*ys)[W] = y_s[t & 1];
    if (valid) {
      float u[C];
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = u_row[t * C + c];
      float y[O];
      Dyn::step_warp(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
      if (lane == 0) {
#pragma unroll
        for (int o = 0; o < O; ++o) ys[o][w] = y[o];
      }
    }
    // one barrier a step: the tile written at step t is read after it and
    // written again at step t + 2, after every thread passed step t + 1's
    __syncthreads();
    store_outputs<O, W>(ys, t, K, base, n_valid, Y);
  }
}

template <class Dyn, int NOISE>
__global__ void __launch_bounds__(32 * Dyn::kWarpSamples)
split_solve_dynamics_warp_kernel(const float* __restrict__ x0, SampleArgs a, int K,
                                 int T, float dt, ModelArgs m,
                                 float* __restrict__ U, float* __restrict__ Y,
                                 float* __restrict__ lr_out) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int RW = WarpRecDim<Dyn>::value;
  constexpr int W = Dyn::kWarpSamples;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int base = blockIdx.x * W;
  const int k = base + w;

  __shared__ typename Dyn::Shared dyn_sh;
  __shared__ float y_s[2][O][W];
  stage_model_warp<Dyn>(m, &dyn_sh);
  __syncthreads();
  const bool valid = k < K;
  const int n_valid = min(W, K - base);

  const uint32_t seed = static_cast<uint32_t>(*a.seed);
  float x[S];
  float rec[RW > 0 ? RW : 1];
  init_rec_warp<Dyn>(dyn_sh, rec);
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x0[i];
  float lr = 0.0f;
  const bool pure = static_cast<float>(k) >= a.pure_thresh;
  float* u_row = U + static_cast<size_t>(valid ? k : 0) * T * C;
  for (int t = 0; t < T; ++t) {
    asm volatile("" ::: "memory");  // as in split_dynamics_warp_kernel
    float(*ys)[W] = y_s[t & 1];
    if (valid) {
      // split_solve_dynamics_kernel's draw, carve-outs, clamp and LR sum
      float eps[C];
      draw_eps<C, NOISE>(a, seed, k, K, T, t, eps);
      const bool pin = k == 0 || t < a.stride;
      float u[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float mn = a.mean[t * C + c];
        const float noise = a.sigma[t * C + c] * eps[c];
        const float mu = pure ? 0.0f : mn;
        float v = pin ? mn : (pure ? noise : mn + noise);
        v = clamp_channel(v, a.cons, C, c);
        u[c] = v;
        if (lane == 0) u_row[t * C + c] = v;
        lr = lr + a.lr_tab[t * C + c] * mu * (mu - 2.0f * v);
      }
      float y[O];
      Dyn::step_warp(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
      if (lane == 0) {
#pragma unroll
        for (int o = 0; o < O; ++o) ys[o][w] = y[o];
      }
    }
    __syncthreads();  // as in split_dynamics_warp_kernel
    store_outputs<O, W>(ys, t, K, base, n_valid, Y);
  }
  if (valid && lane == 0) lr_out[k] = lr;
}

}  // namespace
