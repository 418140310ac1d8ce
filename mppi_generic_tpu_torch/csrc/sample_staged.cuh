// The staged form of the fused sampling kernel (B4) for the models without
// the warp form: producer warps draw each chunk of steps into shared memory
// while consumer threads walk the chain of states.
//
// Replaces, for every model without a network step (the double integrator,
// the cartpole, the quadrotor, Dubins, the bicycle), the one-thread
// fused_sample_rollout_kernel (sample_kernels.cuh), the counterpart of the
// TPU kernel mppi_generic_tpu/ops/pallas_rollout.py::_fused_sample_call
// (:1631, entry fused_sample_rollout_costs :2457). There each of a block's
// 64 threads drew its own controls inside its chain of T steps: a ten-round
// Philox, the Box-Muller logf, sqrtf, cosf and sinf, the carve-outs, the
// clamp and the LR term, none of which depends on the state, on two warps
// per SM (K = 8192) or on 30 SMs (K = 1920); and each thread wrote its own U
// row, T C floats from its neighbours'.
//
// fused_sample_rollout_staged_kernel<Dyn, Cost, NOISE, EPILOGUE>: a block
// holds NS = kBlockSamples = 64 samples. Threads 0..NS-1 are the consumers,
// one sample each: the model's step and the running cost, acc = acc +
// running_cost + lr_t, in the one-thread kernel's order. The kProducerWarps warps after them are the producers
// (produce_chunk): for each chunk of kChunk = 32 steps, lane j makes step
// t0 + j of samples w, w + kProducerWarps, ... by sample_controls, writing
// the U (and Smooth-MPPI's W) rows, one contiguous run of 32 C floats of
// each sample a warp, and the controls and LR term into a stage in shared
// memory. Two stages form a ring: named barriers (bar.arrive / bar.sync,
// ids kBarFull + s and kBarEmpty + s over the whole block) hand stage s to
// the consumers when it is full and back to the producers when it has been
// read, so the producers fill chunk i + 1 while the consumers step through
// chunk i. Every value is made once, by the same operations as in the
// one-thread kernel, so U, W, the costs, the crash flags and the carry rows
// are its floats and those of sample_rollout_plain. With Smooth-MPPI's
// epilogue every thread of the block then writes the carry row
// (write_block_carry; the producers hold no sample and share the columns),
// so the staged form needs no carry pass of its own.
//
// Shared memory: a stage is kChunk (C + 1) rows of NS + 1 floats (the pad
// keeps a consumer's reads and most of a producer's writes off a shared
// bank), 24.4 KB for two controls at NS = 64; the two stages take the
// opt-in above 48 KB (the quadrotor's four controls: 81.2 KB).
//
// What bounds it on this card: operations, not bytes (sample_kernels.cuh);
// the consumers' chain is the pair's step and cost, the producers' work is
// spread over eight warps a block.
//
// The k >= K and t >= T tests skip work only: every consumer and producer
// thread takes part in every barrier, so the last block's and the last
// chunk's raggedness changes no barrier count.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mppi_common.cuh"
#include "sample_draw.cuh"

namespace {

constexpr int kChunk = 32;          // steps of a stage: one per producer lane
constexpr int kProducerWarps = 8;   // producer warps of a block
constexpr int kBarFull = 1;         // named barriers kBarFull + s: stage s full
constexpr int kBarEmpty = 3;        // kBarEmpty + s: stage s read (0: __syncthreads)

__device__ inline void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ inline void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// A stage: for step j of the chunk, C + 1 rows (its controls, then its LR
// term) of NS samples, each row padded to NS + 1 floats.
template <int NS, int C>
struct StageLayout {
  static constexpr int kRow = NS + 1;
  static constexpr int kFloats = kChunk * (C + 1) * kRow;
  __device__ static inline int at(int j, int c, int i) { return (j * (C + 1) + c) * kRow + i; }
};

// The producer of one chunk, run by a whole warp: lane j makes step
// t0 + j of samples k0 + i, i = first, first + stride, ... < NS, by
// sample_controls (U and W rows written where given) into the stage; lanes
// past T and samples past K make nothing. The draw of a step depends on no
// state, so any kernel whose chain reads its controls and LR term from a
// stage can take it.
template <int NS, int C, int NOISE>
__device__ inline void produce_chunk(const SampleArgs& a, uint32_t seed, int k0, int K,
                                     int T, int t0, int first, int stride, float lr_gain,
                                     float* U, float* W, float* stage) {
  using L = StageLayout<NS, C>;
  const int j = threadIdx.x & 31;
  const int t = t0 + j;
  for (int i = first; i < NS; i += stride) {
    const int k = k0 + i;
    if (k < K && t < T) {
      const bool pure = static_cast<float>(k) >= a.pure_thresh;
      float u[C];
      const float lr_t =
          sample_controls<C, NOISE>(a, seed, k, K, T, t, pure, lr_gain, U, W, u);
#pragma unroll
      for (int c = 0; c < C; ++c) stage[L::at(j, c, i)] = u[c];
      stage[L::at(j, C, i)] = lr_t;
    }
  }
}

template <class Dyn, class Cost, int NOISE, bool EPILOGUE>
__global__ void __launch_bounds__(kBlockSamples + 32 * kProducerWarps)
fused_sample_rollout_staged_kernel(const float* __restrict__ x0, SampleArgs a, int K,
                                   int T, float dt, ModelArgs m, float lr_gain, float lam_w,
                                   float* __restrict__ costs, int* __restrict__ crash_out,
                                   float* U, float* W, float* __restrict__ carry) {
  constexpr int NS = kBlockSamples;
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int R = RecDim<Dyn>::value;
  using L = StageLayout<NS, C>;
  constexpr int kThreads = NS + 32 * kProducerWarps;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int k0 = blockIdx.x * NS;

  extern __shared__ float stages[];  // two stages of L::kFloats
  __shared__ typename Dyn::Shared dyn_sh;
  stage_model<Dyn>(m, &dyn_sh);
  __syncthreads();
  const uint32_t seed = static_cast<uint32_t>(*a.seed);

  float J = 0.0f;
  bool valid = false;
  if (threadIdx.x < NS) {  // a consumer: sample k0 + i
    const int i = threadIdx.x;
    const int k = k0 + i;
    valid = k < K;
    const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
    float x[S];
    float y[O];
    float rec[R > 0 ? R : 1];
    init_rec<Dyn>(dyn_sh, rec);
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = x0[s];
#pragma unroll
    for (int o = 0; o < O; ++o) y[o] = 0.0f;
    int crash = 0;
    float acc = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const float* st = stages + (ch & 1) * L::kFloats;
      named_sync(kBarFull + (ch & 1), kThreads);
      if (valid) {
        const int t0 = ch * kChunk;
        const int n = min(kChunk, T - t0);
        for (int j = 0; j < n; ++j) {
          float u[C];
#pragma unroll
          for (int c = 0; c < C; ++c) u[c] = st[L::at(j, c, i)];
          const float lr_t = st[L::at(j, C, i)];
          const int t = t0 + j;
          step_model<Dyn>(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
          acc = acc + Cost::running_cost(cp, y, u, t, &crash) + lr_t;
        }
      }
      // the producers wait for stage (ch & 1) only to fill chunk ch + 2
      if (ch + 2 < n_chunks) named_arrive(kBarEmpty + (ch & 1), kThreads);
    }
    if (valid) {
      J = (acc + Cost::terminal_cost(cp, y)) / static_cast<float>(T);
      costs[k] = J;
      crash_out[k] = crash;
    }
  } else {  // a producer warp
    const int w = (threadIdx.x - NS) >> 5;
    for (int ch = 0; ch < n_chunks; ++ch) {
      float* st = stages + (ch & 1) * L::kFloats;
      if (ch >= 2) named_sync(kBarEmpty + (ch & 1), kThreads);
      produce_chunk<NS, C, NOISE>(a, seed, k0, K, T, ch * kChunk, w, kProducerWarps, lr_gain,
                                  U, W, st);
      named_arrive(kBarFull + (ch & 1), kThreads);
    }
  }
  // every thread: the U / W rows of the block are visible after the first
  // barrier inside
  if (EPILOGUE) write_block_carry<NS>(J, valid, lam_w, W, K, T * C, carry);
}

// B4's staged form for the pair (Dyn, Cost), noise_kind already checked,
// its Smooth-MPPI epilogue inside. Returns the launch error.
template <class Dyn, class Cost>
cudaError_t launch_sample_staged(int noise_kind, bool epilogue, const float* x0,
                                 const SampleArgs& a, int K, int T, float dt, ModelArgs m,
                                 float lr_gain, float lam_w, float* costs, int* crash,
                                 float* U, float* W, float* carry, cudaStream_t s) {
  constexpr int NS = kBlockSamples;
  constexpr int kThreads = NS + 32 * kProducerWarps;
  const size_t smem = 2 * sizeof(float) * StageLayout<NS, Dyn::C>::kFloats;
  // static memory: the model's table and write_block_carry's two rows
  const bool opt_in = smem + sizeof(typename Dyn::Shared) + 2 * sizeof(float) * NS > 48 * 1024;
  const int nb = (K + NS - 1) / NS;
  cudaError_t err = cudaSuccess;
#define B4_STAGED_LAUNCH(NOISE, EPI)                                                   \
  do {                                                                                 \
    const auto kern = fused_sample_rollout_staged_kernel<Dyn, Cost, NOISE, EPI>;       \
    if (opt_in) {                                                                      \
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                                 static_cast<int>(smem));                              \
      if (err != cudaSuccess) return err;                                              \
    }                                                                                  \
    kern<<<nb, kThreads, smem, s>>>(x0, a, K, T, dt, m, lr_gain, lam_w, costs, crash,  \
                                    U, W, carry);                                      \
  } while (0)
  if (epilogue) {
    B4_STAGED_LAUNCH(kSmooth, true);
  } else if (noise_kind == kGaussian) {
    B4_STAGED_LAUNCH(kGaussian, false);
  } else if (noise_kind == kNLN) {
    B4_STAGED_LAUNCH(kNLN, false);
  } else {
    B4_STAGED_LAUNCH(kSmooth, false);
  }
#undef B4_STAGED_LAUNCH
  return cudaGetLastError();
}

}  // namespace
