// The fused MPPI rollout kernel (B1) for Hopper, as a template over the
// (dynamics, cost) pair. Each pair has its own source, csrc/pair_<name>.cu,
// which includes this header and instantiates the C entry with
// ROLLOUT_ENTRY, so that nvcc builds the pairs in parallel, one library each.
//
// Replaces the TPU kernel mppi_generic_tpu/ops/pallas_rollout.py::_fused_call
// in its plain-costs mode (fused_rollout_costs), its exp-epilogue mode and
// pass 1 of its two-pass Tsallis epilogue (fused_weighted_rollout, :894-965),
// each with and without the in-loop Gaussian likelihood-ratio (LR) cost.
// The plain PyTorch version is in mppi_generic_tpu_torch/ops/fused_rollout.py
// (rollout_costs_plain, block_carries_plain, block_minima_plain).
//
// For every model without a network step the entries launch the staged
// form, rollout_costs_staged_kernel (RolloutPolicy below, on the ring of
// sample_staged.cuh): producer warps read each sample's chunk of 32 steps of
// U (and make the LR term) into shared memory, consumer threads walk the
// chain, every mode and epilogue as below. The network models (AutoRally's
// FNN, the racer LSTMs: HasWarpStep) launch the warp form,
// rollout_costs_warp_kernel (below), one warp a sample, and then the
// epilogue as a pass of its own over rows of 64 samples (the carry or the
// minima pass of block_pass.cuh). -DMPPI_ROLLOUT_ONE_THREAD builds the
// one-thread kernel for every model.
//
// rollout_costs_kernel<Dyn, Cost, EPI, WITH_LR, PER_SAMPLE_X0>: one thread
// per sample, the T-step loop inside the thread, the state in registers.
// With PER_SAMPLE_X0 sample k starts from row k of a (K, S) x0, which is how
// RMPPI evaluates its candidate nominal states in one launch (the TPU
// kernel's per_sample_x0 mode, pallas_rollout.py:646, :1028); those entries
// are in rollout_x0.cu. Per sample it writes costs[k] = (sum_t running + LR + terminal) / T and the sticky crash
// flag. With EPI == kEpiExp each block of kBlockSamples samples also reduces
// its samples into one carry row (m_b, d_b, num_b[T*C]):
//   s_k = -J_k / lambda (s = -1e30 past K, so the ragged tail adds nothing),
//   m_b = max s_k,  d_b = sum exp(s_k - m_b),  num_b = sum exp(s_k - m_b) U_k
// which is the TPU kernel's _init/_accum math done per block; the merge is
// flash_combine_kernel (csrc/flash_combine.cu). With EPI == kEpiMin (Tsallis
// pass 1) each block writes the minimum of its valid costs instead;
// tsallis_reduce.cu (pass 2) merges the minima into the global rho before
// any Tsallis weight exists. The TPU runs both passes in one launch because
// its grid runs in order; Hopper blocks do not, so the passes are two
// launches in stream order. Dyn::stage runs in every thread before any sample
// is skipped, so the barrier after it sees the whole block.
//
// What bounds it on this card: for the double integrator the data are small
// (U is K*T*C*4 bytes, 6.6 MB at K=8192, T=100, C=2: 2 us at 3.35 TB/s) and
// the arithmetic is less (about 50 operations per sample-step: under 1 us at
// 67 TFLOP/s fp32). What bounds the simple design is latency: each thread
// walks a dependent chain of T steps, and K=8192 threads in blocks of 64 fill
// the 132 SMs with only a few warps each. The design keeps everything on chip
// that the TPU kernel keeps in VMEM (state, running cost, LR tables in L1),
// and reads U from device memory once for the rollout and once more, from
// L2, for the epilogue. A pair whose step or cost is heavy (AutoRally's FNN
// at about 3,000 operations per sample-step, the bicycle's, the quadrotor's
// with its quaternion and polynomial atan2) is bound by its arithmetic; at
// K=1920 its 30 blocks of 64 fill 30 of the 132 SMs with two warps each, and
// each thread's chain is what the simple design waits on.
//
// Layout: U is the public (K, T, C) row-major tensor. The rollout thread of
// sample k reads its own contiguous T*C row; each line is reused for the
// next steps from L1. The epilogue maps threads to the (t, c) outputs and
// loops over the block's samples, so its reads of the same tensor are
// coalesced. The TPU kernel's channel-major (C, T, K_pad) transpose, its
// 128-lane tiles and its SMEM/VMEM/stream table modes are TPU mechanics and
// are not ported. Its split-cost mode (a dynamics-only loop, then a
// time-parallel cost pass: the reference's rolloutDynamicsKernel and
// rolloutCostKernel) is ported as two kernels of their own in
// csrc/split_kernels.cuh; only the VMEM scratch that holds the outputs
// between its two passes was a TPU mechanic (here a device buffer).
//
// Numerics: built without --use_fast_math and with --fmad=false; expf, logf
// and sqrtf; every operation in the order of the plain PyTorch version. Costs
// and crash flags then agree with the plain version bit for bit. Only the
// epilogue's sums are taken in another order than PyTorch's.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mppi_common.cuh"
#include "sample_staged.cuh"
#include "sample_warp.cuh"
#include "warp.cuh"
#include "warp_model.cuh"

namespace {

// kernel 1's epilogue modes (EPI_* in ops/fused_rollout.py)
constexpr int kEpiNone = 0, kEpiExp = 1, kEpiMin = 2;

struct LRArgs {
  const float* mean;   // (T, C) the sampling mean
  const float* sigma;  // (T, C) the sampling std-dev
  const float* coeff;  // (C,) control-cost coefficients
  float gain;          // 0.5 * lambda * (1 - alpha)
  float pure_thresh;   // (1 - p) * K: samples k >= it have mu = 0
};

// The LR term of a step with the controls u[C], scaled by the gain:
// gain sum_c coeff_c mu (mu - 2 u_c) / (s_c s_c), mu = 0 for a pure sample.
template <int C>
__device__ inline float rollout_lr_term(const LRArgs& lr, int t, bool pure, const float* u) {
  float lr_t = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float mu = pure ? 0.0f : lr.mean[t * C + c];
    const float sg = lr.sigma[t * C + c];
    lr_t = lr_t + lr.coeff[c] * mu * (mu - 2.0f * u[c]) / (sg * sg);
  }
  return lr.gain * lr_t;
}

// B1's inputs of sample k at step t, which depend on no state: its controls
// read from U into v[0..C-1] and, WITH_LR, the step's scaled LR term into
// v[C].
template <int C, bool WITH_LR>
__device__ inline void rollout_controls(const float* U, const LRArgs& lr, int k, int T, int t,
                                        float* v) {
  const float* row = U + (static_cast<size_t>(k) * T + t) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = row[c];
  if constexpr (WITH_LR) {
    v[C] = rollout_lr_term<C>(lr, t, static_cast<float>(k) >= lr.pure_thresh, v);
  }
}

// B1's staged form (sample_staged.cuh): the controls and, WITH_LR, the
// scaled LR term a step; cost = running + gain lr_t, acc = acc + cost. With
// COPY the producers copy the controls from U to the stage by cp.async,
// without a register (lane j's C floats of step t0 + j into the padded
// stage), and with LR each lane reads its own slots back for the LR term;
// else each lane loads and stores them (produce_each). A bulk copy
// (cp.async.bulk) needs 16-byte aligned runs at both ends: a sample's chunk
// would land sample-major, rows 32 C + 4 floats apart, and every consumer
// read would meet a 4-way bank conflict, so the stage keeps its padded
// step-major layout.
template <int C, bool WITH_LR, bool X0, bool COPY>
struct RolloutPolicy {
  static constexpr int kRows = WITH_LR ? C + 1 : C;
  static constexpr bool kX0PerSample = X0;
  const float* U;
  LRArgs lr;

  __device__ uint32_t key() const { return 0u; }
  __device__ void make(uint32_t, int k, int, int T, int t, float* v) const {
    rollout_controls<C, WITH_LR>(U, lr, k, T, t, v);
  }
  template <class L>
  __device__ void produce_chunk(uint32_t key, int k0, int K, int T, int t0, int first,
                                int stride, float* stage) const {
    if constexpr (!COPY) {
      produce_each<L>(*this, key, k0, K, T, t0, first, stride, stage);
    } else {
      const int j = threadIdx.x & 31;
      const int t = t0 + j;
      for (int i = first; i < L::kNS; i += stride) {
        const int k = k0 + i;
        if (k < K && t < T) {
          const float* row = U + (static_cast<size_t>(k) * T + t) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) cp_async_f32(stage + L::at(j, c, i), row + c);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      if constexpr (WITH_LR) {
        for (int i = first; i < L::kNS; i += stride) {
          const int k = k0 + i;
          if (k < K && t < T) {
            float u[C];
#pragma unroll
            for (int c = 0; c < C; ++c) u[c] = stage[L::at(j, c, i)];
            stage[L::at(j, C, i)] =
                rollout_lr_term<C>(lr, t, static_cast<float>(k) >= lr.pure_thresh, u);
          }
        }
      }
    }
  }
  __device__ static void add(StagedSums& s, float running, const float* v) {
    float cost = running;
    if constexpr (WITH_LR) cost = cost + v[C];
    s.acc = s.acc + cost;
  }
  __device__ float finish(const StagedSums& s, float terminal, int T) const {
    return (s.acc + terminal) / static_cast<float>(T);
  }
};

// Whether B1's staged producers copy the controls by cp.async (COPY above):
// A B B A on the H100 (scripts/torch_staged_copy_trial.py, PERF.md §6) the
// copy was the faster for the models with a short state, whose chain is
// short (the double integrator, the cartpole, Dubins), the plain loads for
// the quadrotor and the bicycle. -DMPPI_ROLLOUT_COPY=1 or =0 takes one for
// every model.
template <class Dyn>
struct RolloutCopies {
#ifdef MPPI_ROLLOUT_COPY
  static constexpr bool value = MPPI_ROLLOUT_COPY != 0;
#else
  static constexpr bool value = Dyn::S <= 4;
#endif
};

template <class Dyn, class Cost, int EPI, bool WITH_LR, bool PER_SAMPLE_X0>
__global__ void __launch_bounds__(kBlockSamples)
rollout_costs_kernel(const float* __restrict__ x0,
                     const float* __restrict__ U, int K, int T, float dt,
                     ModelArgs m, LRArgs lr, float lam_w,
                     float* __restrict__ costs, int* __restrict__ crash_out,
                     float* __restrict__ carry) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int R = RecDim<Dyn>::value;
  const int TC = T * C;
  const int k = blockIdx.x * kBlockSamples + threadIdx.x;
  const bool valid = k < K;

  // the model's parameters, staged by every thread before any returns
  __shared__ typename Dyn::Shared dyn_sh;
  stage_model<Dyn>(m, &dyn_sh);
  if (Dyn::kStaged) __syncthreads();

  float J = 0.0f;
  if (valid) {
    const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
    float x[S];
    float y[O];
    float rec[R > 0 ? R : 1];  // a recurrent model's carry (LSTM h, c)
    init_rec<Dyn>(dyn_sh, rec);
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = PER_SAMPLE_X0 ? x0[k * S + i] : x0[i];
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = 0.0f;
    int crash = 0;
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
      float u[WITH_LR ? C + 1 : C];
      rollout_controls<C, WITH_LR>(U, lr, k, T, t, u);
      step_model<Dyn>(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
      float cost = Cost::running_cost(cp, y, u, t, &crash);
      if constexpr (WITH_LR) cost = cost + u[C];
      acc = acc + cost;
    }
    J = (acc + Cost::terminal_cost(cp, y)) / static_cast<float>(T);
    costs[k] = J;
    crash_out[k] = crash;
  }

  if (EPI == kEpiExp) write_block_carry<kBlockSamples>(J, valid, lam_w, U, K, TC, carry);
  if (EPI == kEpiMin) write_block_min<kBlockSamples>(J, valid, carry);
}

template <class Dyn, class Cost, int EPI, bool WITH_LR, bool PER_SAMPLE_X0>
__global__ void __launch_bounds__(kStagedThreads, 1)
rollout_costs_staged_kernel(const float* __restrict__ x0, const float* __restrict__ U, int K,
                            int T, float dt, ModelArgs m, LRArgs lr, float lam_w,
                            float* __restrict__ costs, int* __restrict__ crash_out,
                            float* __restrict__ carry) {
  bool valid;
  const float J = staged_chain<Dyn, Cost>(
      RolloutPolicy<Dyn::C, WITH_LR, PER_SAMPLE_X0, RolloutCopies<Dyn>::value>{U, lr}, x0, K,
      T, dt, m, costs, crash_out, &valid);
  if (EPI == kEpiExp) write_block_carry<kBlockSamples>(J, valid, lam_w, U, K, T * Dyn::C, carry);
  if (EPI == kEpiMin) write_block_min<kBlockSamples>(J, valid, carry);
}

// B1's warp form for the network models, rollout_costs_warp_kernel<Dyn,
// Cost, EPI, WITH_LR, X0>: the one-thread kernel's chain on the blocks and
// lanes of B4's and B3's warp forms (sample_warp.cuh). A block holds the
// model's kWarpSamples samples, one warp each (AutoRally 4, the racers 8),
// the model's table staged once per block (stage_model_warp) and a
// recurrent model's carry started from its warm (h, c), one unit a lane
// (init_rec_warp); with X0 each lane reads sample k's row of x0. Nothing in
// B1's inputs depends on the state, so each chunk of 32 steps starts with a
// prologue spread over the lanes: lane j reads step t0 + j of its sample
// (t0 = 0, 32, 64, ...; a coalesced read of the chunk's 32 C floats of U)
// and, WITH_LR, makes that step's scaled LR term (rollout_controls); lanes
// past T make nothing. Step t takes the controls and the term by
// __shfl_sync from lane t - t0, runs the network step (Dyn::step_warp: lane
// o computes unit o of each layer) and the running cost on every lane, and
// adds cost = running + lr_t into acc, the one-thread kernel's order; lane 0
// writes costs[k] = (acc + terminal) / T and the sticky crash flag. Every
// value is computed once, by the same operations, so every output is the
// float of the one-thread kernel and of rollout_costs_plain. The epilogue
// rows stay rows of kBlockSamples = 64 samples, which a block of warps does
// not hold: the carry pass or the minima pass (block_pass.cuh) writes them
// after this launch from the costs (launch_rollout_warp).
//
// What bounds it on this card: operations (the network's multiply-adds,
// each a shared-memory load, a shuffle and a separate multiply and add
// under --fmad=false, and the cost on every lane). With X0 and a recurrent
// model (the racer LSTMs' RMPPI candidates) x starts from row k of x0 and
// (h, c) from the warm state for every sample, as the TPU kernel does
// (pallas_rollout.py:646-662, :1247-1249). The k >= K test is the same on every lane of a
// warp and comes after the staging barrier; no block barrier follows it, so
// a warp past K leaves whole.
template <class Dyn, class Cost, bool WITH_LR, bool X0>
__global__ void __launch_bounds__(32 * Dyn::kWarpSamples)
rollout_costs_warp_kernel(const float* __restrict__ x0, const float* __restrict__ U, int K,
                          int T, float dt, ModelArgs m, LRArgs lr,
                          float* __restrict__ costs, int* __restrict__ crash_out) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int RW = WarpRecDim<Dyn>::value;
  constexpr int V = WITH_LR ? C + 1 : C;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * Dyn::kWarpSamples + (threadIdx.x >> 5);

  __shared__ typename Dyn::Shared dyn_sh;
  stage_model_warp<Dyn>(m, &dyn_sh);
  __syncthreads();
  if (k >= K) return;  // the whole warp

  const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
  float x[S];
  float y[O];
  float rec[RW > 0 ? RW : 1];
  init_rec_warp<Dyn>(dyn_sh, rec);
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = X0 ? x0[k * S + i] : x0[i];
#pragma unroll
  for (int i = 0; i < O; ++i) y[i] = 0.0f;
  int crash = 0;
  float acc = 0.0f;
  float v_lane[V];  // this lane's step of the chunk: its controls and LR term
#pragma unroll
  for (int i = 0; i < V; ++i) v_lane[i] = 0.0f;
  for (int t = 0; t < T; ++t) {
    // a compiler barrier, as in split_dynamics_warp_kernel: the staged weights
    // are read from shared memory each step, not hoisted and spilled
    asm volatile("" ::: "memory");
    const int j = t & 31;
    if (j == 0 && t + lane < T) rollout_controls<C, WITH_LR>(U, lr, k, T, t + lane, v_lane);
    float u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = __shfl_sync(kFullMask, v_lane[c], j);
    Dyn::step_warp(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
    float cost = Cost::running_cost(cp, y, u, t, &crash);
    if constexpr (WITH_LR) cost = cost + __shfl_sync(kFullMask, v_lane[C], j);
    acc = acc + cost;
  }
  if (lane == 0) {
    costs[k] = (acc + Cost::terminal_cost(cp, y)) / static_cast<float>(T);
    crash_out[k] = crash;
  }
}

// B1's warp form for the pair (Dyn, Cost) in the mode EPI: the warp kernel,
// then with EPI exp the carry pass over U (launch_block_carry) or with EPI
// min the minima pass (launch_block_min; block_pass.cuh). Returns the first
// launch error.
template <class Dyn, class Cost, int EPI, bool X0>
cudaError_t launch_rollout_warp(bool with_lr, const float* x0, const float* U, int K, int T,
                                float dt, ModelArgs m, LRArgs lr, float lam_w, float* costs,
                                int* crash, float* carry, cudaStream_t s) {
  constexpr int NW = Dyn::kWarpSamples;
  const int nb = (K + NW - 1) / NW;
  if (with_lr) {
    rollout_costs_warp_kernel<Dyn, Cost, true, X0><<<nb, 32 * NW, 0, s>>>(x0, U, K, T, dt, m, lr,
                                                                          costs, crash);
  } else {
    rollout_costs_warp_kernel<Dyn, Cost, false, X0><<<nb, 32 * NW, 0, s>>>(x0, U, K, T, dt, m,
                                                                           lr, costs, crash);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (EPI == kEpiExp) {
    return launch_block_carry<kBlockSamples>(costs, U, K, T * Dyn::C, lam_w, carry, s);
  } else if constexpr (EPI == kEpiMin) {
    return launch_block_min<kBlockSamples>(costs, K, carry, s);
  }
  return err;
}

// The form of B1 a model's entries launch: 1 the warp form
// (rollout_costs_warp_kernel and its epilogue pass) for a model with it
// (HasWarpStep, warp_model.cuh), else 2 the staged form
// (rollout_costs_staged_kernel); with -DMPPI_ROLLOUT_ONE_THREAD, 0 the
// one-thread kernel for every model.
template <class Dyn>
constexpr int rollout_form() {
#ifdef MPPI_ROLLOUT_ONE_THREAD
  return 0;
#else
  return HasWarpStep<Dyn>::value ? 1 : 2;
#endif
}

template <class Dyn, class Cost, int EPI, bool X0>
cudaError_t launch_rollout_lr(bool with_lr, const float* x0, const float* U, int K, int T,
                              float dt, ModelArgs m, LRArgs lr, float lam_w, float* costs,
                              int* crash, float* carry, cudaStream_t stream) {
  constexpr int C = Dyn::C;
  if constexpr (rollout_form<Dyn>() == 2) {
    if (with_lr) {
      return launch_staged<Dyn, C + 1>(rollout_costs_staged_kernel<Dyn, Cost, EPI, true, X0>,
                                       K, stream, x0, U, K, T, dt, m, lr, lam_w, costs, crash,
                                       carry);
    }
    return launch_staged<Dyn, C>(rollout_costs_staged_kernel<Dyn, Cost, EPI, false, X0>, K,
                                 stream, x0, U, K, T, dt, m, lr, lam_w, costs, crash, carry);
  } else if constexpr (rollout_form<Dyn>() == 1) {
    return launch_rollout_warp<Dyn, Cost, EPI, X0>(with_lr, x0, U, K, T, dt, m, lr, lam_w,
                                                   costs, crash, carry, stream);
  } else {
    const int nb = (K + kBlockSamples - 1) / kBlockSamples;
    if (with_lr) {
      rollout_costs_kernel<Dyn, Cost, EPI, true, X0>
          <<<nb, kBlockSamples, 0, stream>>>(x0, U, K, T, dt, m, lr, lam_w, costs, crash,
                                             carry);
    } else {
      rollout_costs_kernel<Dyn, Cost, EPI, false, X0>
          <<<nb, kBlockSamples, 0, stream>>>(x0, U, K, T, dt, m, lr, lam_w, costs, crash,
                                             carry);
    }
    return cudaGetLastError();
  }
}

// Kernel 1 for the pair (Dyn, Cost) in the mode the flags select, in the
// form rollout_form<Dyn>() names. An entry is built for one x0 layout, X0:
// one state for all samples (the pairs' sources) or one per sample (RMPPI's
// candidate evaluation, rollout_x0.cu); the other layout is refused
// (cudaErrorInvalidValue). Instantiating only one layout per entry halves a
// pair's kernels, and so its share of the build.
template <class Dyn, class Cost, bool X0>
int rollout_entry(int device, const float* x0, const float* U, int K, int T,
                  float dt, ModelArgs m, LRArgs lr, int with_lr, int epilogue,
                  int per_sample_x0, float lam_w, float* costs, int* crash,
                  float* carry, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool lr_on = with_lr != 0;
  if ((per_sample_x0 != 0) != X0) return static_cast<int>(cudaErrorInvalidValue);
  if (epilogue == kEpiExp) {
    return static_cast<int>(launch_rollout_lr<Dyn, Cost, kEpiExp, X0>(
        lr_on, x0, U, K, T, dt, m, lr, lam_w, costs, crash, carry, s));
  }
  if (epilogue == kEpiMin) {
    return static_cast<int>(launch_rollout_lr<Dyn, Cost, kEpiMin, X0>(
        lr_on, x0, U, K, T, dt, m, lr, lam_w, costs, crash, carry, s));
  }
  if (epilogue == kEpiNone) {
    return static_cast<int>(launch_rollout_lr<Dyn, Cost, kEpiNone, X0>(
        lr_on, x0, U, K, T, dt, m, lr, lam_w, costs, crash, carry, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The C entry of kernel 1 for one (dynamics, cost) pair, to be expanded
// inside extern "C". Every pointer is memory of CUDA device `device`, and
// `stream` one of its streams; dyn_params and cost_map may be null for a
// pair that reads none (dyn_map is null for every pair but the racer
// models'), lr_* when with_lr == 0. epilogue: 0 none (carry may
// be null), 1 the exp carry rows (nb, 2 + T*C), 2 the Tsallis block minima
// (nb,). x0 is (K, S) when per_sample_x0 != 0, which only an entry built
// with X0 true takes, else (S,), which only one built with X0 false takes.
// Returns the CUDA error of the launch (0 when it was accepted; of the
// first launch that failed). Beside it, NAME_form() says which form it
// launches: 1 the warp form (rollout_costs_warp_kernel, then with epilogue 1
// the carry pass, with epilogue 2 the minima pass: block_pass_form()), 2 the
// staged form (rollout_costs_staged_kernel), 0 the one-thread kernel
// (rollout_costs_kernel).
#define ROLLOUT_ENTRY(NAME, DYN, COST, X0)                                    \
  int NAME(int device, const float* x0, const float* U, int K, int T,        \
           float dt, const float* dyn_params, const float* cost_params,      \
           const float* cost_map, const float* dyn_map,                      \
           const float* lr_mean, const float* lr_sigma,                      \
           const float* lr_coeff, float lr_gain, float pure_thresh,          \
           int with_lr, int epilogue, int per_sample_x0, float lam_w,        \
           float* costs, int* crash, float* carry, void* stream) {           \
    return rollout_entry<DYN, COST, X0>(                                     \
        device, x0, U, K, T, dt,                                             \
        ModelArgs{dyn_params, cost_params, cost_map, dyn_map},               \
        LRArgs{lr_mean, lr_sigma, lr_coeff, lr_gain, pure_thresh}, with_lr,  \
        epilogue, per_sample_x0, lam_w, costs, crash, carry, stream);        \
  }                                                                          \
  int NAME##_form() { return rollout_form<DYN>(); }
