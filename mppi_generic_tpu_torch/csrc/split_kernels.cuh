// The split form of the rollout (B1) and fused-solve (B3) kernels for Hopper:
// a sequential dynamics-only pass, then a time-parallel cost pass, then the
// epilogue of B1's mode. Each (dynamics, cost) pair with a split entry has its
// own source, csrc/split_<name>.cu, which includes this header and
// instantiates the C entries with SPLIT_ENTRY, so that nvcc builds the pairs
// in parallel with their other sources.
//
// Replaces the split-cost mode of the TPU kernels
// mppi_generic_tpu/ops/pallas_rollout.py::_fused_call (run_tile, :663-800) and
// mppi_generic_tpu/ops/pallas_solve.py::_fused_solve_call (:274-332), which are
// the in-kernel analog of the reference's rolloutDynamicsKernel and
// time-tiled rolloutCostKernel (mppi_common.cu:148-362). The TPU kernels keep
// the outputs in a VMEM scratch inside one launch; here they go to a device
// buffer Y (T, O, K) between two launches (8-13 MB at the bench shapes, which
// the H100's 50 MB L2 holds). The plain PyTorch versions are
// split_rollout_plain (mppi_generic_tpu_torch/ops/fused_rollout.py) and
// fused_solve_split_plain (ops/fused_solve.py).
//
// split_dynamics_kernel<Dyn, X0> (B1's dynamics pass): one thread per sample,
// the T-step loop of rollout_costs_kernel without the cost: read u from U,
// step, write y to Y[t, :, k] (a warp's stores are coalesced). With X0 true
// (PER_SAMPLE_X0 of rollout_kernel.cuh) sample k starts from row k of a
// (K, S) x0: RMPPI's candidate nominal states in one launch, the TPU
// kernel's per_sample_x0 mode in its split form (pallas_rollout.py:646).
//
// split_solve_dynamics_kernel<Dyn, NOISE> (B3's dynamics pass): the loop of
// fused_solve_kernel without the cost: draw, carve out and clamp u (written
// to U), add the LR term lrc mu (mu - 2 u) to the sample's sum (written to
// lr_out[k]), step, write y.
//
// These two one-thread passes are the earlier form, which only a build with
// -DMPPI_SPLIT_ONE_THREAD launches. A model whose step is a network
// (kWarpStep: AutoRally's FNN, the racer LSTMs) takes the warp form of both
// dynamics passes, split_dynamics_warp_kernel and
// split_solve_dynamics_warp_kernel (split_warp.cuh: one warp per sample, one
// network unit per lane); a model with a long analytic step (kLaneGroup: the
// bicycle) takes the lane-group form of B1's dynamics pass,
// split_dynamics_lanes_kernel (split_lanes.cuh: a group of lanes per sample,
// each evaluating one operand set of the step's independent functions);
// every other pass takes the staged form, split_dynamics_staged_kernel and
// split_solve_dynamics_staged_kernel (split_staged.cuh: producer warps make
// each 32-step chunk's controls into shared memory, a consumer thread a
// sample steps and stores Y). The entries below pick the form at compile
// time, so a pair's library holds one.
//
// The cost pass of both, split_cost_cluster_kernel<Cost, O, C, EPI, WITH_LR>:
// a thread-block cluster of kCostCluster CTAs takes a block of kBlockSamples
// samples; the horizon is cut into kCostChunks chunks of ceil(T /
// kCostChunks) steps, and each CTA owns a run of kCostChunks / kCostCluster
// whole chunks (one: clusters of 8 beat 4 and 2 at every shape a path
// launches, A B B A on the H100, PERF.md section 6).
// A CTA walks its steps in windows of kCostWindow: it stages the window's
// controls of its samples into shared memory by cp.async (a sample's are
// contiguous in U; the next window's copies fly while this one is used),
// then its threads over (step, sample) compute every step's values at once
// (neighbouring threads take neighbouring samples of Y, so the loads are
// coalesced): Cost::running_cost plus lr_gain times the step's LR term in
// B1's LR modes (rollout_costs_kernel's step value). A sticky-crash cost
// (the AutoRally costs, kStickyCrash; the JAX Cost.time_parallel_crash) is
// evaluated twice a step, at crash 0 and at crash 1; the first call's crash
// output is the step's trigger. Then one thread per (sample, chunk) adds the
// window's values of its chunk in step order into two sums: the chunk's
// values with the crash-1 value from its first trigger on, and the crash-1
// values of every step, the chunk's sum if a trigger came before it. Rank 0
// of the cluster reads every chunk's sums and flag from its neighbours'
// shared memory (distributed shared memory) and adds them in chunk order,
// each taking its second sum once an earlier chunk has fired: the TPU
// kernels' dual evaluation and prefix OR (pallas_rollout.py:698-728) with
// the same crash flags as the sequential loop. J = (sum + terminal(y_{T-1}))
// / T, B3's J = (sum + terminal + lr_gain lr) / T. The block's J then feed
// the epilogue of B1's mode: the carry row (m_b, d_b, num_b[T*C]) over U
// (kEpiExp; flash_combine.cu merges the rows), its m_b, d_b and 64 weights
// on rank 0 and its columns spread over the cluster, each CTA taking its
// own steps' columns with the weights read from rank 0, each column summed
// in sample order; or the block minimum (kEpiMin, Tsallis pass 1;
// tsallis_reduce.cu takes the minima), so the merge and the Tsallis
// reduction are unchanged. The caller names the form of each launch
// (fused_rollout.split_cost_form, the rule that A B B A on the H100 set,
// PERF.md section 6); the other form is the earlier one:
// split_cost_kernel, one block of kCostThreads a 64-sample block, a thread
// per (sample, chunk) walking its steps one after the other, thread 0
// making the carry's scalars and the block's threads all its columns;
// -DMPPI_COST_ONE_BLOCK builds it alone, for A B B A. The sums and the order
// of every addition are the same in both forms.
//
// What bounds it on this card: the dynamics pass is rollout_costs_kernel's
// chain without the cost, so a pair whose cost is a large share of the step
// shortens the chain that one thread per sample walks; AutoRally's network
// is about nine tenths of its step, the double integrator's Euler step less
// than its circle cost. The cost pass runs its K*T evaluations on eight
// times the combined kernel's threads. What the split adds is Y's round
// trip, written once and read once, and a second launch. The cost pass's
// earlier form ran ceil(K / 64) blocks, 30 on 132 SMs at K = 1920, each
// thread walking ceil(T / 8) steps with two map costs a step; the cluster
// form runs kCostCluster times the CTAs, each step's values at once.
//
// Numerics: built without --use_fast_math and with --fmad=false; the
// dynamics step and the cost are the combined kernels' device functions;
// the plain versions sum each chunk and then the chunks in the kernel's
// order, so costs, crash flags, U and block minima agree with them bit for
// bit. Only the carry's sums are taken in another order by the plain
// version (block_carries_plain); both forms of the pass take them alike.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "mppi_common.cuh"
#include "philox.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"
#include "split_lanes.cuh"
#include "split_staged.cuh"
#include "split_warp.cuh"

namespace {

// the cost pass: each block takes kBlockSamples samples and cuts the horizon
// into kCostChunks chunks, one thread per (sample, chunk)
constexpr int kCostChunks = 8;
constexpr int kCostThreads = kBlockSamples * kCostChunks;

// the cluster form: CTAs a 64-sample block, steps of a window, threads a CTA
constexpr int kCostCluster = 8;
static_assert(kCostChunks % kCostCluster == 0, "each CTA owns whole chunks");
constexpr int kCostWindow = 16;
constexpr int kClusterThreads = 512;
// the cost pass's forms: 3 the cluster form, 0 the one-block form (the
// earlier design, which -DMPPI_COST_ONE_BLOCK builds alone)
#ifdef MPPI_COST_ONE_BLOCK
constexpr int kCostForm = 0;
#else
constexpr int kCostForm = 3;
#endif

template <class Dyn, bool X0>
__global__ void __launch_bounds__(kBlockSamples)
split_dynamics_kernel(const float* __restrict__ x0, const float* __restrict__ U,
                      int K, int T, float dt, ModelArgs m,
                      float* __restrict__ Y) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int R = RecDim<Dyn>::value;
  const int k = blockIdx.x * kBlockSamples + threadIdx.x;

  // the model's parameters, staged by every thread before any returns
  __shared__ typename Dyn::Shared dyn_sh;
  stage_model<Dyn>(m, &dyn_sh);
  if (Dyn::kStaged) __syncthreads();
  if (k >= K) return;

  float x[S];
  float y[O];
  float rec[R > 0 ? R : 1];  // a recurrent model's carry (LSTM h, c)
  init_rec<Dyn>(dyn_sh, rec);
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = X0 ? x0[static_cast<size_t>(k) * S + i] : x0[i];
  const float* u_row = U + static_cast<size_t>(k) * T * C;
  for (int t = 0; t < T; ++t) {
    // a compiler barrier: without the cost in the loop, nvcc hoists the
    // staged weights' loads out of it and spills them (AutoRally's 1,412
    // floats: a 6 KB stack a thread, and a pass 16x slower on an H100)
    asm volatile("" ::: "memory");
    float u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = u_row[t * C + c];
    step_model<Dyn>(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
#pragma unroll
    for (int o = 0; o < O; ++o) Y[(static_cast<size_t>(t) * O + o) * K + k] = y[o];
  }
}

template <class Dyn, int NOISE>
__global__ void __launch_bounds__(kBlockSamples)
split_solve_dynamics_kernel(const float* __restrict__ x0, SampleArgs a, int K,
                            int T, float dt, ModelArgs m,
                            float* __restrict__ U, float* __restrict__ Y,
                            float* __restrict__ lr_out) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int R = RecDim<Dyn>::value;
  const int k = blockIdx.x * kBlockSamples + threadIdx.x;

  __shared__ typename Dyn::Shared dyn_sh;
  stage_model<Dyn>(m, &dyn_sh);
  if (Dyn::kStaged) __syncthreads();
  if (k >= K) return;

  const uint32_t seed = static_cast<uint32_t>(*a.seed);
  float x[S];
  float y[O];
  float rec[R > 0 ? R : 1];
  init_rec<Dyn>(dyn_sh, rec);
#pragma unroll
  for (int i = 0; i < S; ++i) x[i] = x0[i];
  float lr = 0.0f;
  const bool pure = static_cast<float>(k) >= a.pure_thresh;
  float* u_row = U + static_cast<size_t>(k) * T * C;
  for (int t = 0; t < T; ++t) {
    asm volatile("" ::: "memory");  // as in split_dynamics_kernel
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
      u_row[t * C + c] = v;
      lr = lr + a.lr_tab[t * C + c] * mu * (mu - 2.0f * v);
    }
    step_model<Dyn>(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
#pragma unroll
    for (int o = 0; o < O; ++o) Y[(static_cast<size_t>(t) * O + o) * K + k] = y[o];
  }
  lr_out[k] = lr;
}

// The carry row of this block from its samples' J in shared memory (J_s,
// n_valid of them), the math of write_block_carry: thread 0 takes m_b and,
// after the weights, d_b in sample order; the threads then map to the TC
// outputs of num_b.
__device__ inline void split_block_carry(const float* J_s, int n_valid,
                                         float lam_w, const float* X, int TC,
                                         float* carry) {
  __shared__ float w_s[kBlockSamples];
  __shared__ float m_s;
  const int tid = threadIdx.x;
  if (tid == 0) {
    float m_b = -J_s[0] / lam_w;
    for (int i = 1; i < kBlockSamples; ++i) {
      m_b = fmaxf(m_b, i < n_valid ? -J_s[i] / lam_w : kMasked);
    }
    m_s = m_b;
  }
  __syncthreads();
  if (tid < kBlockSamples) {
    const float s = tid < n_valid ? -J_s[tid] / lam_w : kMasked;
    w_s[tid] = expf(s - m_s);  // exactly 0 for the masked tail
  }
  __syncthreads();
  float* row = carry + static_cast<size_t>(blockIdx.x) * (2 + TC);
  if (tid == 0) {
    float d_b = 0.0f;
    for (int i = 0; i < kBlockSamples; ++i) d_b = d_b + w_s[i];
    row[0] = m_s;
    row[1] = d_b;
  }
  const float* Xb = X + static_cast<size_t>(blockIdx.x) * kBlockSamples * TC;
  for (int j = tid; j < TC; j += kCostThreads) {
    float acc = 0.0f;
    for (int i = 0; i < n_valid; ++i) {
      acc = acc + w_s[i] * Xb[static_cast<size_t>(i) * TC + j];
    }
    row[2 + j] = acc;
  }
}

template <class Cost, int O, int C, int EPI, bool WITH_LR>
__global__ void __launch_bounds__(kCostThreads)
split_cost_kernel(const float* __restrict__ Y, const float* __restrict__ U,
                  int K, int T, const float* cost_params, const float* cost_map,
                  LRArgs lr, const float* __restrict__ lr_sum,
                  float lr_sum_gain, float lam_w, float* __restrict__ costs,
                  int* __restrict__ crash_out, float* __restrict__ out) {
  constexpr bool kSticky = StickyCrash<Cost>::value;
  __shared__ float sel_s[kCostChunks][kBlockSamples];
  __shared__ float all1_s[kCostChunks][kBlockSamples];
  __shared__ int any_s[kCostChunks][kBlockSamples];
  __shared__ float J_s[kBlockSamples];
  const int i = threadIdx.x % kBlockSamples;  // the sample in the block
  const int ch = threadIdx.x / kBlockSamples;  // its chunk of steps
  const int base = blockIdx.x * kBlockSamples;
  const int k = base + i;
  const int Tc = (T + kCostChunks - 1) / kCostChunks;
  const int t0 = min(T, ch * Tc);
  const int t1 = min(T, t0 + Tc);
  const typename Cost::Params cp = Cost::load(cost_params, cost_map);
  float sel = 0.0f;   // the chunk's sum, crash-1 values from its first trigger
  float all1 = 0.0f;  // the chunk's sum of crash-1 values (an earlier trigger)
  bool fired = false;
  if (k < K) {
    const float* u_row = U + static_cast<size_t>(k) * T * C;
    const bool pure = WITH_LR && static_cast<float>(k) >= lr.pure_thresh;
    for (int t = t0; t < t1; ++t) {
      float y[O];
      float u[C];
#pragma unroll
      for (int o = 0; o < O; ++o) y[o] = Y[(static_cast<size_t>(t) * O + o) * K + k];
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = u_row[t * C + c];
      float lr_term = 0.0f;
      if (WITH_LR) {
        float lr_t = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float mu = pure ? 0.0f : lr.mean[t * C + c];
          const float sg = lr.sigma[t * C + c];
          lr_t = lr_t + lr.coeff[c] * mu * (mu - 2.0f * u[c]) / (sg * sg);
        }
        lr_term = lr.gain * lr_t;
      }
      int cr = 0;
      float v = Cost::running_cost(cp, y, u, t, &cr);
      if (kSticky) {
        int one = 1;
        const float v1 = Cost::running_cost(cp, y, u, t, &one);
        fired = fired || cr != 0;
        if (fired) v = v1;
        all1 = all1 + (WITH_LR ? v1 + lr_term : v1);
      }
      if (WITH_LR) v = v + lr_term;
      sel = sel + v;
    }
  }
  sel_s[ch][i] = sel;
  all1_s[ch][i] = all1;
  any_s[ch][i] = fired ? 1 : 0;
  __syncthreads();
  if (ch == 0 && k < K) {
    // the chunks in order: a chunk after a trigger takes its crash-1 sum
    float acc = 0.0f;
    bool crashed = false;
    for (int c = 0; c < kCostChunks; ++c) {
      acc = acc + (crashed ? all1_s[c][i] : sel_s[c][i]);
      crashed = crashed || any_s[c][i] != 0;
    }
    float y_last[O];
#pragma unroll
    for (int o = 0; o < O; ++o) {
      y_last[o] = Y[(static_cast<size_t>(T - 1) * O + o) * K + k];
    }
    const float term = Cost::terminal_cost(cp, y_last);
    const float J = lr_sum != nullptr
                        ? (acc + term + lr_sum_gain * lr_sum[k]) / static_cast<float>(T)
                        : (acc + term) / static_cast<float>(T);
    costs[k] = J;
    crash_out[k] = crashed ? 1 : 0;
    J_s[i] = J;
  }
  __syncthreads();
  const int n_valid = min(kBlockSamples, K - base);
  if (EPI == kEpiExp) split_block_carry(J_s, n_valid, lam_w, U, T * C, out);
  if (EPI == kEpiMin && threadIdx.x == 0) {
    // the minimum of the block's valid costs, kMinPad past K, NaN if one is
    float mn = J_s[0];
    for (int s = 1; s < kBlockSamples; ++s) {
      mn = nan_min(mn, s < n_valid ? J_s[s] : kMinPad);
    }
    out[blockIdx.x] = mn;
  }
}

// The cluster form of the cost pass (see the note atop this file). Every
// addition is the earlier form's, in its order: the step values are those
// of its thread loop, each chunk is summed in step order by one thread, the
// chunks in chunk order by rank 0, the carry's scalars by one thread and
// each carry column in sample order.
template <class Cost, int O, int C, int EPI, bool WITH_LR>
__global__ void __cluster_dims__(kCostCluster, 1, 1) __launch_bounds__(kClusterThreads)
split_cost_cluster_kernel(const float* __restrict__ Y, const float* __restrict__ U,
                          int K, int T, const float* cost_params,
                          const float* cost_map, LRArgs lr,
                          const float* __restrict__ lr_sum, float lr_sum_gain,
                          float lam_w, float* __restrict__ costs,
                          int* __restrict__ crash_out, float* __restrict__ out) {
  namespace cg = cooperative_groups;
  constexpr bool kSticky = StickyCrash<Cost>::value;
  constexpr int kURow = kCostWindow * C + 1;  // a sample's staged controls, padded
  constexpr int kWarps = kClusterThreads / 32;
  __shared__ float u_s[2][kBlockSamples][kURow];
  __shared__ float v0_s[kCostWindow][kBlockSamples];
  __shared__ float v1_s[kSticky ? kCostWindow : 1][kBlockSamples];
  __shared__ unsigned char trig_s[kSticky ? kCostWindow : 1][kBlockSamples];
  constexpr int per = kCostChunks / kCostCluster;  // the chunks a CTA owns
  __shared__ float sel_s[per][kBlockSamples];
  __shared__ float all1_s[per][kBlockSamples];
  __shared__ int any_s[per][kBlockSamples];
  __shared__ float J_s[kBlockSamples];
  __shared__ float w_s[kBlockSamples];  // rank 0's carry weights (a copy elsewhere)
  __shared__ float m_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int blk = blockIdx.x / kCostCluster;  // the 64-sample block
  const int base = blk * kBlockSamples;
  const int n_valid = min(kBlockSamples, K - base);
  const int Tc = (T + kCostChunks - 1) / kCostChunks;
  const int c_lo = rank * per;  // this CTA's first chunk
  const int t_lo = min(T, c_lo * Tc);
  const int t_hi = min(T, (c_lo + per) * Tc);
  const typename Cost::Params cp = Cost::load(cost_params, cost_map);
  // the (sample, chunk) this thread sums, if it is one of the summing threads
  const int si = tid % kBlockSamples;
  const int sc = tid / kBlockSamples;
  const bool summer = sc < per && si < n_valid;
  const int s_t0 = min(T, (c_lo + sc) * Tc);
  const int s_t1 = min(T, s_t0 + Tc);
  float sel = 0.0f;   // the chunk's sum, crash-1 values from its first trigger
  float all1 = 0.0f;  // the chunk's sum of crash-1 values (an earlier trigger)
  bool fired = false;

  // the controls of steps t0w .. t0w + n - 1 of the block's valid samples,
  // a warp a sample, into u_s[buf]; one cp.async group
  auto stage = [&](int buf, int t0w, int n) {
    const int run = n * C;
    for (int i = tid / 32; i < n_valid; i += kWarps) {
      const float* src = U + (static_cast<size_t>(base + i) * T + t0w) * C;
      for (int e = tid % 32; e < run; e += 32) cp_async_f32(&u_s[buf][i][e], src + e);
    }
    cp_async_commit();
  };

  if (t_lo < t_hi) stage(0, t_lo, min(kCostWindow, t_hi - t_lo));
  int buf = 0;
  for (int tw0 = t_lo; tw0 < t_hi; tw0 += kCostWindow, buf ^= 1) {
    const int n = min(kCostWindow, t_hi - tw0);
    const int next = tw0 + kCostWindow;
    if (next < t_hi) {
      stage(buf ^ 1, next, min(kCostWindow, t_hi - next));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the window's controls are in; the last sums are read
    for (int e = tid; e < n * kBlockSamples; e += kClusterThreads) {
      const int i = e % kBlockSamples;
      const int tl = e / kBlockSamples;
      if (i >= n_valid) continue;
      const int k = base + i;
      const int t = tw0 + tl;
      float y[O];
      float u[C];
#pragma unroll
      for (int o = 0; o < O; ++o) y[o] = Y[(static_cast<size_t>(t) * O + o) * K + k];
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = u_s[buf][i][tl * C + c];
      float lr_term = 0.0f;
      if (WITH_LR) {
        const bool pure = static_cast<float>(k) >= lr.pure_thresh;
        float lr_t = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float mu = pure ? 0.0f : lr.mean[t * C + c];
          const float sg = lr.sigma[t * C + c];
          lr_t = lr_t + lr.coeff[c] * mu * (mu - 2.0f * u[c]) / (sg * sg);
        }
        lr_term = lr.gain * lr_t;
      }
      int cr = 0;
      const float v = Cost::running_cost(cp, y, u, t, &cr);
      if constexpr (kSticky) {
        int one = 1;
        const float v1 = Cost::running_cost(cp, y, u, t, &one);
        v1_s[tl][i] = WITH_LR ? v1 + lr_term : v1;
        trig_s[tl][i] = cr != 0 ? 1 : 0;
      }
      v0_s[tl][i] = WITH_LR ? v + lr_term : v;
    }
    __syncthreads();
    if (summer) {
      const int te = min(s_t1, tw0 + n);
      for (int t = max(s_t0, tw0); t < te; ++t) {
        const int tl = t - tw0;
        if constexpr (kSticky) {
          fired = fired || trig_s[tl][si] != 0;
          all1 = all1 + v1_s[tl][si];
          sel = sel + (fired ? v1_s[tl][si] : v0_s[tl][si]);
        } else {
          sel = sel + v0_s[tl][si];
        }
      }
    }
  }
  if (summer) {
    sel_s[sc][si] = sel;
    all1_s[sc][si] = all1;
    any_s[sc][si] = fired ? 1 : 0;
  }
  cluster.sync();  // every CTA's chunk sums are in its shared memory
  if (rank == 0 && tid < n_valid) {
    // the chunks in order: a chunk after a trigger takes its crash-1 sum
    float acc = 0.0f;
    bool crashed = false;
    for (int c = 0; c < kCostChunks; ++c) {
      const int q = c / per;
      const int lc = c % per;
      const float a1 = *cluster.map_shared_rank(&all1_s[lc][tid], q);
      const float s0 = *cluster.map_shared_rank(&sel_s[lc][tid], q);
      acc = acc + (crashed ? a1 : s0);
      crashed = crashed || *cluster.map_shared_rank(&any_s[lc][tid], q) != 0;
    }
    const int k = base + tid;
    float y_last[O];
#pragma unroll
    for (int o = 0; o < O; ++o) {
      y_last[o] = Y[(static_cast<size_t>(T - 1) * O + o) * K + k];
    }
    const float term = Cost::terminal_cost(cp, y_last);
    const float J = lr_sum != nullptr
                        ? (acc + term + lr_sum_gain * lr_sum[k]) / static_cast<float>(T)
                        : (acc + term) / static_cast<float>(T);
    costs[k] = J;
    crash_out[k] = crashed ? 1 : 0;
    J_s[tid] = J;
  }
  if (EPI == kEpiExp) {
    const int TC = T * C;
    float* row = out + static_cast<size_t>(blk) * (2 + TC);
    if (rank == 0) {
      __syncthreads();  // J_s
      if (tid == 0) {
        float m_b = -J_s[0] / lam_w;
        for (int i = 1; i < kBlockSamples; ++i) {
          m_b = fmaxf(m_b, i < n_valid ? -J_s[i] / lam_w : kMasked);
        }
        m_s = m_b;
      }
      __syncthreads();
      if (tid < kBlockSamples) {
        const float s = tid < n_valid ? -J_s[tid] / lam_w : kMasked;
        w_s[tid] = expf(s - m_s);  // exactly 0 for the masked tail
      }
      __syncthreads();
      if (tid == 0) {
        float d_b = 0.0f;
        for (int i = 0; i < kBlockSamples; ++i) d_b = d_b + w_s[i];
        row[0] = m_s;
        row[1] = d_b;
      }
    }
    cluster.sync();  // rank 0's weights are written and its reads are done
    float w_i = 0.0f;
    if (rank != 0 && tid < kBlockSamples) w_i = *cluster.map_shared_rank(&w_s[tid], 0);
    cluster.sync();  // every CTA holds the weights: rank 0 may finish
    if (rank != 0 && tid < kBlockSamples) w_s[tid] = w_i;
    __syncthreads();
    // this CTA's steps' columns, each summed in sample order
    const float* Xb = U + static_cast<size_t>(base) * TC;
    for (int j = t_lo * C + tid; j < t_hi * C; j += kClusterThreads) {
      float acc = 0.0f;
      for (int i = 0; i < n_valid; ++i) {
        acc = acc + w_s[i] * Xb[static_cast<size_t>(i) * TC + j];
      }
      row[2 + j] = acc;
    }
  } else {
    if (EPI == kEpiMin && rank == 0) {
      __syncthreads();  // J_s
      if (tid == 0) {
        // the minimum of the block's valid costs, kMinPad past K, NaN if one is
        float mn = J_s[0];
        for (int s = 1; s < kBlockSamples; ++s) {
          mn = nan_min(mn, s < n_valid ? J_s[s] : kMinPad);
        }
        out[blk] = mn;
      }
    }
    cluster.sync();  // the others' sums stay until rank 0 has read them
  }
}

// The form of B1's split dynamics pass for the model Dyn: 1 the warp form, 5
// the lane-group form, 2 the staged form, 0 the one-thread kernel (every
// model under -DMPPI_SPLIT_ONE_THREAD).
template <class Dyn>
constexpr int split_dynamics_form() {
  return kSplitWarp<Dyn> ? 1 : kSplitLanes<Dyn> ? 5 : kSplitStaged<Dyn> ? 2 : 0;
}

// The form of B3's split dynamics pass for the model Dyn: 1 the warp form, 2
// the staged form, 0 the one-thread kernel.
template <class Dyn>
constexpr int split_solve_dynamics_form() {
  return kSplitWarp<Dyn> ? 1 : kSplitStaged<Dyn> ? 2 : 0;
}

template <class Dyn, bool X0>
int split_dynamics_entry(int device, const float* x0, const float* U, int K,
                         int T, float dt, ModelArgs m, float* Y, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kSplitWarp<Dyn>) {
    constexpr int W = Dyn::kWarpSamples;
    const int nb = (K + W - 1) / W;
    split_dynamics_warp_kernel<Dyn, X0><<<nb, 32 * W, 0, s>>>(x0, U, K, T, dt, m, Y);
  } else if constexpr (kSplitLanes<Dyn>) {
    const int nb = (K + kLaneSamples - 1) / kLaneSamples;
    split_dynamics_lanes_kernel<Dyn, X0><<<nb, kLaneSamples * Dyn::kLaneGroup, 0, s>>>(
        x0, U, K, T, dt, m, Y);
  } else if constexpr (kSplitStaged<Dyn>) {
    return static_cast<int>(launch_split_dynamics_staged<Dyn, X0>(x0, U, K, T, dt, m, Y, s));
  } else {
    const int nb = (K + kBlockSamples - 1) / kBlockSamples;
    split_dynamics_kernel<Dyn, X0><<<nb, kBlockSamples, 0, s>>>(x0, U, K, T, dt, m, Y);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Dyn>
int split_solve_dynamics_entry(int device, int noise_kind, const float* x0,
                               const SampleArgs& a, int K, int T, float dt,
                               ModelArgs m, float* U, float* Y, float* lr_out,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise_kind != kGaussian && noise_kind != kNLN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (kSplitWarp<Dyn>) {
    constexpr int W = Dyn::kWarpSamples;
    const int nb = (K + W - 1) / W;
    if (noise_kind == kGaussian) {
      split_solve_dynamics_warp_kernel<Dyn, kGaussian><<<nb, 32 * W, 0, s>>>(
          x0, a, K, T, dt, m, U, Y, lr_out);
    } else {
      split_solve_dynamics_warp_kernel<Dyn, kNLN><<<nb, 32 * W, 0, s>>>(
          x0, a, K, T, dt, m, U, Y, lr_out);
    }
  } else if constexpr (kSplitStaged<Dyn>) {
    return static_cast<int>(launch_split_solve_dynamics_staged<Dyn>(noise_kind, x0, a, K, T,
                                                                     dt, m, U, Y, lr_out, s));
  } else {
    const int nb = (K + kBlockSamples - 1) / kBlockSamples;
    if (noise_kind == kGaussian) {
      split_solve_dynamics_kernel<Dyn, kGaussian><<<nb, kBlockSamples, 0, s>>>(
          x0, a, K, T, dt, m, U, Y, lr_out);
    } else {
      split_solve_dynamics_kernel<Dyn, kNLN><<<nb, kBlockSamples, 0, s>>>(
          x0, a, K, T, dt, m, U, Y, lr_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Cost, int O, int C, int EPI, bool WITH_LR>
void launch_split_cost_form(int form, int nb, cudaStream_t s, const float* Y,
                            const float* U, int K, int T, const float* cost_params,
                            const float* cost_map, LRArgs lr, const float* lr_sum,
                            float lr_sum_gain, float lam_w, float* costs, int* crash,
                            float* out) {
  if constexpr (kCostForm != 0) {
    if (form != 0) {
      split_cost_cluster_kernel<Cost, O, C, EPI, WITH_LR>
          <<<nb * kCostCluster, kClusterThreads, 0, s>>>(
              Y, U, K, T, cost_params, cost_map, lr, lr_sum, lr_sum_gain, lam_w,
              costs, crash, out);
      return;
    }
  }
  split_cost_kernel<Cost, O, C, EPI, WITH_LR><<<nb, kCostThreads, 0, s>>>(
      Y, U, K, T, cost_params, cost_map, lr, lr_sum, lr_sum_gain, lam_w, costs,
      crash, out);
}

template <class Cost, int O, int C, int EPI>
void launch_split_cost(bool with_lr, int form, int nb, cudaStream_t s,
                       const float* Y, const float* U, int K, int T,
                       const float* cost_params, const float* cost_map, LRArgs lr,
                       const float* lr_sum, float lr_sum_gain, float lam_w,
                       float* costs, int* crash, float* out) {
  if (with_lr) {
    launch_split_cost_form<Cost, O, C, EPI, true>(form, nb, s, Y, U, K, T,
                                                  cost_params, cost_map, lr, lr_sum,
                                                  lr_sum_gain, lam_w, costs, crash, out);
  } else {
    launch_split_cost_form<Cost, O, C, EPI, false>(form, nb, s, Y, U, K, T,
                                                   cost_params, cost_map, lr, lr_sum,
                                                   lr_sum_gain, lam_w, costs, crash, out);
  }
}

template <class Dyn, class Cost>
int split_cost_entry(int device, const float* Y, const float* U, int K, int T,
                     const float* cost_params, const float* cost_map, LRArgs lr,
                     int with_lr, const float* lr_sum, float lr_sum_gain,
                     int epilogue, float lam_w, float* costs, int* crash,
                     float* out, int form, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  // B1's per-step LR term and B3's per-sample LR sum are not taken together;
  // the form is the one-block form or the build's own
  if ((with_lr != 0 && lr_sum != nullptr) || (form != 0 && form != kCostForm)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = (K + kBlockSamples - 1) / kBlockSamples;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool lr_on = with_lr != 0;
  constexpr int O = Dyn::O;
  constexpr int C = Dyn::C;
#define SPLIT_COST_LAUNCH(EPI)                                                 \
  launch_split_cost<Cost, O, C, EPI>(lr_on, form, nb, s, Y, U, K, T,            \
                                     cost_params, cost_map, lr, lr_sum,         \
                                     lr_sum_gain, lam_w, costs, crash, out)
  if (epilogue == kEpiExp) {
    SPLIT_COST_LAUNCH(kEpiExp);
  } else if (epilogue == kEpiMin) {
    SPLIT_COST_LAUNCH(kEpiMin);
  } else if (epilogue == kEpiNone) {
    SPLIT_COST_LAUNCH(kEpiNone);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPLIT_COST_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entries of the split form for one (dynamics, cost) pair, to be
// expanded inside extern "C": split_dynamics_<PAIR> (B1's dynamics pass: Y
// (T, O, K) from x0 (S,) and U (K, T, C)), split_solve_dynamics_<PAIR> (B3's:
// noise_kind 0 Gaussian, 1 NLN; writes U, Y and the per-sample LR sums
// lr_out (K,)) and split_cost_<PAIR> (the cost pass: costs, crash and, by
// epilogue, nothing (0), the exp carry rows (1, (nb, 2 + T*C) over U) or the
// Tsallis block minima (2, (nb,)); with_lr adds B1's per-step LR term, a
// non-null lr_sum B3's per-sample sum times lr_sum_gain). SPLIT_ENTRY
// expands all three; SPLIT_DYNAMICS_X0_ENTRY expands
// split_dynamics_x0_<PAIR>, B1's dynamics pass from one x0 per sample (x0
// (K, S)), and SPLIT_COST_ENTRY the cost pass alone (a pair whose only split
// use is RMPPI's candidates). Every pointer is memory of CUDA device
// `device`, `stream` one of its streams. Each returns the CUDA error of its
// launch (0 when it was accepted), or cudaErrorInvalidValue for a mode it
// does not have. Beside each dynamics entry, <entry>_form() says which form
// of the pass it launches: 1 the warp form (split_warp.cuh), 5 the lane-group
// form (split_lanes.cuh, B1's pass only), 2 the staged form
// (split_staged.cuh), 0 the one-thread kernel. Each cost entry launches the
// form `form` names: 3 the cluster form, 0 the one-block form; <entry>_form()
// says which the build has besides the one-block form (3, or 0 under
// -DMPPI_COST_ONE_BLOCK).
#define SPLIT_DYNAMICS_ENTRY_(NAME, DYN, X0)                                  \
  int NAME(int device, const float* x0, const float* U, int K, int T,        \
           float dt, const float* dyn_params, const float* cost_params,      \
           const float* cost_map, const float* dyn_map, float* Y,            \
           void* stream) {                                                   \
    return split_dynamics_entry<DYN, X0>(                                    \
        device, x0, U, K, T, dt,                                             \
        ModelArgs{dyn_params, cost_params, cost_map, dyn_map}, Y, stream);   \
  }                                                                          \
  int NAME##_form() { return split_dynamics_form<DYN>(); }
#define SPLIT_DYNAMICS_X0_ENTRY(PAIR, DYN) \
  SPLIT_DYNAMICS_ENTRY_(split_dynamics_x0_##PAIR, DYN, true)
#define SPLIT_COST_ENTRY(PAIR, DYN, COST)                                      \
  int split_cost_##PAIR(int device, const float* Y, const float* U, int K,    \
                        int T, const float* cost_params,                      \
                        const float* cost_map, const float* lr_mean,          \
                        const float* lr_sigma, const float* lr_coeff,         \
                        float lr_gain, float pure_thresh, int with_lr,        \
                        const float* lr_sum, float lr_sum_gain, int epilogue, \
                        float lam_w, float* costs, int* crash, float* out,    \
                        int form, void* stream) {                             \
    return split_cost_entry<DYN, COST>(                                       \
        device, Y, U, K, T, cost_params, cost_map,                            \
        LRArgs{lr_mean, lr_sigma, lr_coeff, lr_gain, pure_thresh}, with_lr,   \
        lr_sum, lr_sum_gain, epilogue, lam_w, costs, crash, out, form,        \
        stream);                                                              \
  }                                                                           \
  int split_cost_##PAIR##_form() { return kCostForm; }
#define SPLIT_ENTRY(PAIR, DYN, COST)                                           \
  SPLIT_DYNAMICS_ENTRY_(split_dynamics_##PAIR, DYN, false)                    \
  int split_solve_dynamics_##PAIR(                                            \
      int device, int noise_kind, const float* x0, const float* mean,         \
      const float* sigma, const float* aux, const float* lrc,                 \
      const float* cons, const int* seed, const float* zinj, int K, int T,    \
      int stride, float pure_thresh, float dt, const float* dyn_params,       \
      const float* cost_params, const float* cost_map, const float* dyn_map,  \
      float* U, float* Y, float* lr_out, void* stream) {                      \
    const SampleArgs a{mean, sigma, aux, lrc, cons, seed, zinj,               \
                       stride, pure_thresh, 0.0f};                             \
    return split_solve_dynamics_entry<DYN>(                                   \
        device, noise_kind, x0, a, K, T, dt,                                  \
        ModelArgs{dyn_params, cost_params, cost_map, dyn_map}, U, Y, lr_out,  \
        stream);                                                              \
  }                                                                           \
  int split_solve_dynamics_##PAIR##_form() {                                  \
    return split_solve_dynamics_form<DYN>();                                  \
  }                                                                           \
  SPLIT_COST_ENTRY(PAIR, DYN, COST)
