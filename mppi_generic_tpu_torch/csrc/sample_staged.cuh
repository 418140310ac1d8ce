// The staged form of the fused kernels B4, B3 and B1 for the models without
// the warp form: producer warps make each chunk of steps' state-free work
// into shared memory while consumer threads walk the chain of states.
//
// Replaces, for every model without a network step (the double integrator,
// the cartpole, the quadrotor, Dubins, the bicycle), three one-thread
// kernels, each the counterpart of a TPU kernel:
//   fused_sample_rollout_kernel (sample_kernels.cuh; B4,
//     mppi_generic_tpu/ops/pallas_rollout.py::_fused_sample_call :1631);
//   fused_solve_kernel (sample_kernels.cuh; B3,
//     mppi_generic_tpu/ops/pallas_solve.py::_fused_solve_call :103);
//   rollout_costs_kernel (rollout_kernel.cuh; B1,
//     mppi_generic_tpu/ops/pallas_rollout.py::_fused_call :548).
// There each of a block's 64 threads made its own step's inputs inside its
// chain of T steps, none of which depends on the state: B4's and B3's
// ten-round Philox, the Box-Muller logf, sqrtf, cosf and sinf, the
// carve-outs, the clamp, the LR term and the thread's own U row, T C floats
// from its neighbours'; B1's read of its own U row, as far from its
// neighbours', and its LR term with C divisions. K = 8192 fills the 132 SMs
// with two warps each.
//
// One ring (staged_ring) serves the three kernels and the split form's two
// dynamics passes (split_staged.cuh). A block holds NS = kBlockSamples = 64
// samples. Threads 0..NS-1 are the consumers, one sample each: the model's
// step and the consumer's action on its outputs (the sink: in the three
// kernels the running cost, CostSink), in the one-thread kernel's order.
// The kProducerWarps warps after them are the producers (the policy's
// produce_chunk): for each chunk of kChunk = 32 steps, lane j makes step
// t0 + j of samples w, w + kProducerWarps, ... into a stage in shared
// memory. Two stages form a ring: named barriers (bar.arrive / bar.sync, ids
// kBarFull + s and kBarEmpty + s over the whole block) hand stage s to the
// consumers when it is full and back to the producers when it has been
// read, so the producers fill chunk i + 1 while the consumers step through
// chunk i. What a step's rows hold, and how the consumer adds them up, is
// the kernel's policy (the split passes' sink stores each step's outputs
// instead, split_staged.cuh):
//   B4 (SamplePolicy): the controls and the step's LR term by
//     sample_controls, U and W rows written; acc = acc + running + lr_t.
//   B3 (SolvePolicy): the controls and the C LR terms by solve_controls, U
//     written; acc = acc + running, and the terms added one by one into the
//     LR sum kept apart, in (t, c) order; J = (acc + terminal + gain lr) / T.
//   B1 (RolloutPolicy, rollout_kernel.cuh): the controls read from U, lane
//     j's C floats of step t0 + j, so a warp reads 32 C contiguous floats of
//     a sample; with LR also gain lr_t; cost = running + gain lr_t, acc =
//     acc + cost.
// Every value is made once, by the same operations as in the one-thread
// kernel, so the outputs are its floats and those of the plain versions.
// After the ring every thread of the block writes the kernel's epilogue:
// B4 Smooth-MPPI's carry row over W, B3's carry row over U, B1's carry row
// over U or its block minimum (write_block_carry, write_block_min; the
// producers hold no sample and share the columns), so no pass of its own.
//
// Shared memory: a stage is kChunk * kRows rows of NS + 1 floats (the pad
// keeps a consumer's reads and most of a producer's writes off a shared
// bank); kRows is C + 1 for B4 and for B1 with LR, C for B1 without it, and
// 2 C for B3 (its C LR terms must reach the consumer apart: float sums are
// not associative, and the sum is the consumer's, in (t, c) order). Two
// stages take the opt-in above 48 KB (the quadrotor's four controls: B4
// 81.2 KB, B3 130 KB of the 227 KB a block may hold).
//
// What bounds it on this card: for B4 and B3 operations, not bytes
// (sample_kernels.cuh); for B1 with the analytic models bytes (U once).
// What bounds the form is the consumers' chain, the pair's step and cost;
// the producers' work is spread over eight warps a block. No step of these
// models is a matrix product, so the tensor cores have nothing to do here.
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
// threads of a block; the kernels' launch bounds also ask for one block an
// SM at least: with the block size alone ptxas held some of them to 32 or 64
// registers and spilled (the quadrotor, Dubins, the bicycle)
constexpr int kStagedThreads = kBlockSamples + 32 * kProducerWarps;
constexpr int kBarFull = 1;         // named barriers kBarFull + s: stage s full
constexpr int kBarEmpty = 3;        // kBarEmpty + s: stage s read (0: __syncthreads)

__device__ inline void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ inline void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// A stage: for step j of the chunk, ROWS rows (the controls first) of NS
// samples, each row padded to NS + 1 floats.
template <int NS, int ROWS>
struct StageLayout {
  static constexpr int kNS = NS;
  static constexpr int kRow = NS + 1;
  static constexpr int kFloats = kChunk * ROWS * kRow;
  __device__ static inline int at(int j, int r, int i) { return (j * ROWS + r) * kRow + i; }
};

// The producer of one chunk, run by a whole warp: lane j makes step t0 + j
// of samples k0 + i, i = first, first + stride, ... < NS, by the policy's
// make, into the stage; lanes past T and samples past K make nothing. Each
// policy's produce_chunk (what the ring calls) is this one unless it says
// otherwise.
template <class L, class P>
__device__ inline void produce_each(const P& p, uint32_t key, int k0, int K, int T, int t0,
                                    int first, int stride, float* stage) {
  const int j = threadIdx.x & 31;
  const int t = t0 + j;
  for (int i = first; i < L::kNS; i += stride) {
    const int k = k0 + i;
    if (k < K && t < T) {
      float v[P::kRows];
      p.make(key, k, K, T, t, v);
#pragma unroll
      for (int r = 0; r < P::kRows; ++r) stage[L::at(j, r, i)] = v[r];
    }
  }
}

// A consumer's running sums: the running costs and (B3) the LR sum.
struct StagedSums {
  float acc = 0.0f;
  float lr = 0.0f;
};

// B4: the controls and the step's LR term scaled by lr_gain.
template <int C, int NOISE>
struct SamplePolicy {
  static constexpr int kRows = C + 1;
  static constexpr bool kX0PerSample = false;
  SampleArgs a;
  float lr_gain;
  float* U;
  float* W;

  __device__ uint32_t key() const { return static_cast<uint32_t>(*a.seed); }
  template <class L>
  __device__ void produce_chunk(uint32_t key, int k0, int K, int T, int t0, int first,
                                int stride, float* stage) const {
    produce_each<L>(*this, key, k0, K, T, t0, first, stride, stage);
  }
  __device__ void make(uint32_t key, int k, int K, int T, int t, float* v) const {
    const bool pure = static_cast<float>(k) >= a.pure_thresh;
    const float lr_t = sample_controls<C, NOISE>(a, key, k, K, T, t, pure, lr_gain, U, W, v);
    v[C] = lr_t;
  }
  __device__ static void add(StagedSums& s, float running, const float* v) {
    s.acc = s.acc + running + v[C];
  }
  __device__ float finish(const StagedSums& s, float terminal, int T) const {
    return (s.acc + terminal) / static_cast<float>(T);
  }
};

// B3: the controls and the C LR terms, summed apart in (t, c) order.
template <int C, int NOISE>
struct SolvePolicy {
  static constexpr int kRows = 2 * C;
  static constexpr bool kX0PerSample = false;
  SampleArgs a;
  float lr_gain;
  float* U;

  __device__ uint32_t key() const { return static_cast<uint32_t>(*a.seed); }
  template <class L>
  __device__ void produce_chunk(uint32_t key, int k0, int K, int T, int t0, int first,
                                int stride, float* stage) const {
    produce_each<L>(*this, key, k0, K, T, t0, first, stride, stage);
  }
  __device__ void make(uint32_t key, int k, int K, int T, int t, float* v) const {
    const bool pure = static_cast<float>(k) >= a.pure_thresh;
    solve_controls<C, NOISE>(a, key, k, K, T, t, pure, U, v, v + C);
  }
  __device__ static void add(StagedSums& s, float running, const float* v) {
    s.acc = s.acc + running;
#pragma unroll
    for (int c = 0; c < C; ++c) s.lr = s.lr + v[C + c];
  }
  __device__ float finish(const StagedSums& s, float terminal, int T) const {
    return (s.acc + terminal + lr_gain * s.lr) / static_cast<float>(T);
  }
};

// The consumer's action in the combined kernels: each step's running cost
// added up by the policy's add (the cost sum, and B3's LR terms into the LR
// sum kept apart), then J = the policy's finish with the terminal cost,
// written to costs[k] with the sticky crash flag.
template <class Cost, class P>
struct CostSink {
  struct Args {
    float* costs;
    int* crash_out;
  };
  Args a;
  typename Cost::Params cp;
  int crash = 0;
  StagedSums sums;

  __device__ CostSink(const Args& args, const ModelArgs& m)
      : a(args), cp(Cost::load(m.cost_params, m.cost_map)) {}
  __device__ void step(int t, int /*k*/, const float* y, const float* v) {
    P::add(sums, Cost::running_cost(cp, y, v, t, &crash), v);
  }
  __device__ float finish(const P& p, int k, int T, const float* y) {
    const float J = p.finish(sums, Cost::terminal_cost(cp, y), T);
    a.costs[k] = J;
    a.crash_out[k] = crash;
    return J;
  }
};

// The ring of the staged kernels (the top of this file) for the model Dyn,
// the policy P (what the producers make) and the consumer's action Sink
// (what a consumer does with each step's outputs y and rows v: CostSink in
// the combined kernels, OutputSink in the split dynamics passes,
// split_staged.cuh). Each consumer constructs its Sink from `sink_args`
// and the model arguments, calls its step(t, k, y, v) after each step and,
// for a sample below K, its finish(p, k, T, y) after the last, whose value
// it returns (0 for a producer and past K); sets *valid_out for the
// epilogue. Every thread of the block calls it.
template <class Dyn, class Sink, class P>
__device__ inline float staged_ring(const P& p, const typename Sink::Args& sink_args,
                                    const float* x0, int K, int T, float dt,
                                    const ModelArgs& m, bool* valid_out) {
  constexpr int NS = kBlockSamples;
  constexpr int S = Dyn::S;
  constexpr int O = Dyn::O;
  constexpr int R = RecDim<Dyn>::value;
  using L = StageLayout<NS, P::kRows>;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int k0 = blockIdx.x * NS;

  extern __shared__ float stages[];  // two stages of L::kFloats
  __shared__ typename Dyn::Shared dyn_sh;
  stage_model<Dyn>(m, &dyn_sh);
  __syncthreads();

  float J = 0.0f;
  bool valid = false;
  if (threadIdx.x < NS) {  // a consumer: sample k0 + i
    const int i = threadIdx.x;
    const int k = k0 + i;
    valid = k < K;
    Sink sink(sink_args, m);
    float x[S];
    float y[O];
    float rec[R > 0 ? R : 1];
    init_rec<Dyn>(dyn_sh, rec);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      x[s] = !P::kX0PerSample ? x0[s] : (valid ? x0[static_cast<size_t>(k) * S + s] : 0.0f);
    }
#pragma unroll
    for (int o = 0; o < O; ++o) y[o] = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const float* st = stages + (ch & 1) * L::kFloats;
      named_sync(kBarFull + (ch & 1), kStagedThreads);
      if (valid) {
        const int t0 = ch * kChunk;
        const int n = min(kChunk, T - t0);
        for (int j = 0; j < n; ++j) {
          // keeps nvcc from hoisting the staged tables out of the loop (a
          // dynamics-only pass that hoisted and spilled its network weights
          // ran 16x slower)
          asm volatile("" ::: "memory");
          float v[P::kRows];
#pragma unroll
          for (int r = 0; r < P::kRows; ++r) v[r] = st[L::at(j, r, i)];
          const int t = t0 + j;
          step_model<Dyn>(dyn_sh, x, rec, v, static_cast<float>(t), dt, y);
          sink.step(t, k, y, v);
        }
      }
      // the producers wait for stage (ch & 1) only to fill chunk ch + 2
      if (ch + 2 < n_chunks) named_arrive(kBarEmpty + (ch & 1), kStagedThreads);
    }
    if (valid) J = sink.finish(p, k, T, y);
  } else {  // a producer warp
    const int w = (threadIdx.x - NS) >> 5;
    const uint32_t key = p.key();
    for (int ch = 0; ch < n_chunks; ++ch) {
      float* st = stages + (ch & 1) * L::kFloats;
      if (ch >= 2) named_sync(kBarEmpty + (ch & 1), kStagedThreads);
      p.template produce_chunk<L>(key, k0, K, T, ch * kChunk, w, kProducerWarps, st);
      named_arrive(kBarFull + (ch & 1), kStagedThreads);
    }
  }
  *valid_out = valid;
  return J;
}

// The ring of the combined kernels for the pair (Dyn, Cost) and the policy
// P: returns this thread's J (0 for a producer and past K), costs and crash
// flags written, and sets *valid_out for the epilogue.
template <class Dyn, class Cost, class P>
__device__ inline float staged_chain(const P& p, const float* x0, int K, int T, float dt,
                                     const ModelArgs& m, float* costs, int* crash_out,
                                     bool* valid_out) {
  return staged_ring<Dyn, CostSink<Cost, P>>(p, {costs, crash_out}, x0, K, T, dt, m,
                                             valid_out);
}

// Launch the staged kernel `kern` of the model Dyn, ROWS rows a step, over
// ceil(K / 64) blocks with its two stages; past 48 KB of shared memory with
// the static tables (the model's, the epilogue's rows), after the opt-in.
// Returns the launch error.
template <class Dyn, int ROWS, class Kern, class... Args>
cudaError_t launch_staged(Kern kern, int K, cudaStream_t s, Args... args) {
  const size_t smem = 2 * sizeof(float) * StageLayout<kBlockSamples, ROWS>::kFloats;
  const size_t static_bytes = sizeof(typename Dyn::Shared) + 3 * sizeof(float) * kBlockSamples;
  if (smem + static_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<(K + kBlockSamples - 1) / kBlockSamples, kStagedThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <class Dyn, class Cost, int NOISE, bool EPILOGUE>
__global__ void __launch_bounds__(kStagedThreads, 1)
fused_sample_rollout_staged_kernel(const float* __restrict__ x0, SampleArgs a, int K,
                                   int T, float dt, ModelArgs m, float lr_gain, float lam_w,
                                   float* __restrict__ costs, int* __restrict__ crash_out,
                                   float* U, float* W, float* __restrict__ carry) {
  bool valid;
  const float J = staged_chain<Dyn, Cost>(SamplePolicy<Dyn::C, NOISE>{a, lr_gain, U, W}, x0,
                                          K, T, dt, m, costs, crash_out, &valid);
  // every thread: the W rows of the block are visible after the first
  // barrier inside
  if (EPILOGUE) write_block_carry<kBlockSamples>(J, valid, lam_w, W, K, T * Dyn::C, carry);
}

template <class Dyn, class Cost, int NOISE>
__global__ void __launch_bounds__(kStagedThreads, 1)
fused_solve_staged_kernel(const float* __restrict__ x0, SampleArgs a, int K, int T, float dt,
                          ModelArgs m, float lr_gain, float lam_w, float* __restrict__ costs,
                          int* __restrict__ crash_out, float* U, float* __restrict__ carry) {
  bool valid;
  const float J = staged_chain<Dyn, Cost>(SolvePolicy<Dyn::C, NOISE>{a, lr_gain, U}, x0, K,
                                          T, dt, m, costs, crash_out, &valid);
  write_block_carry<kBlockSamples>(J, valid, lam_w, U, K, T * Dyn::C, carry);
}

// B4's staged form for the pair (Dyn, Cost), noise_kind already checked,
// its Smooth-MPPI epilogue inside. Returns the launch error.
template <class Dyn, class Cost>
cudaError_t launch_sample_staged(int noise_kind, bool epilogue, const float* x0,
                                 const SampleArgs& a, int K, int T, float dt, ModelArgs m,
                                 float lr_gain, float lam_w, float* costs, int* crash,
                                 float* U, float* W, float* carry, cudaStream_t s) {
  constexpr int kRows = Dyn::C + 1;
#define B4_STAGED_LAUNCH(NOISE, EPI)                                                      \
  launch_staged<Dyn, kRows>(fused_sample_rollout_staged_kernel<Dyn, Cost, NOISE, EPI>, K, \
                            s, x0, a, K, T, dt, m, lr_gain, lam_w, costs, crash, U, W,    \
                            carry)
  if (epilogue) return B4_STAGED_LAUNCH(kSmooth, true);
  if (noise_kind == kGaussian) return B4_STAGED_LAUNCH(kGaussian, false);
  if (noise_kind == kNLN) return B4_STAGED_LAUNCH(kNLN, false);
  return B4_STAGED_LAUNCH(kSmooth, false);
#undef B4_STAGED_LAUNCH
}

// B3's staged form for the pair (Dyn, Cost); noise_kind 0 Gaussian, 1 NLN,
// already checked. Returns the launch error.
template <class Dyn, class Cost>
cudaError_t launch_solve_staged(int noise_kind, const float* x0, const SampleArgs& a, int K,
                                int T, float dt, ModelArgs m, float lr_gain, float lam_w,
                                float* costs, int* crash, float* U, float* carry,
                                cudaStream_t s) {
  constexpr int kRows = 2 * Dyn::C;
  if (noise_kind == kGaussian) {
    return launch_staged<Dyn, kRows>(fused_solve_staged_kernel<Dyn, Cost, kGaussian>, K, s,
                                     x0, a, K, T, dt, m, lr_gain, lam_w, costs, crash, U,
                                     carry);
  }
  return launch_staged<Dyn, kRows>(fused_solve_staged_kernel<Dyn, Cost, kNLN>, K, s, x0, a,
                                   K, T, dt, m, lr_gain, lam_w, costs, crash, U, carry);
}

}  // namespace
