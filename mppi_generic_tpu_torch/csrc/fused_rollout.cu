// Fused MPPI rollout + flash (online-softmax) normExp epilogue for Hopper.
//
// Replaces the TPU kernel mppi_generic_tpu/ops/pallas_rollout.py::_fused_call
// in its plain-costs mode (fused_rollout_costs), its exp-epilogue mode and
// pass 1 of its two-pass Tsallis epilogue (fused_weighted_rollout, :894-965),
// each with and without the in-loop Gaussian likelihood-ratio (LR) cost.
// The plain PyTorch versions of both kernels are in
// mppi_generic_tpu_torch/ops/fused_rollout.py; the wrappers there launch
// these kernels through the C functions at the end of this file.
//
// Kernel 1, rollout_costs_kernel<Dyn, Cost, EPI, WITH_LR, PER_SAMPLE_X0>:
// one thread per sample, the T-step loop inside the thread, the state in
// registers. With PER_SAMPLE_X0 sample k starts from row k of a (K, S) x0,
// which is how RMPPI evaluates its candidate nominal states in one launch
// (the TPU kernel's per_sample_x0 mode, pallas_rollout.py:646, :1028).
// Per sample it writes costs[k] = (sum_t running + LR + terminal) / T and the
// sticky crash flag. With EPI == kEpiExp each block of kBlock samples also
// reduces its samples into one carry row (m_b, d_b, num_b[T*C]):
//   s_k = -J_k / lambda (s = -1e30 past K, so the ragged tail adds nothing),
//   m_b = max s_k,  d_b = sum exp(s_k - m_b),  num_b = sum exp(s_k - m_b) U_k
// which is the TPU kernel's _init/_accum math done per block. With
// EPI == kEpiMin (Tsallis pass 1) each block writes the minimum of its valid
// costs instead; tsallis_reduce.cu (pass 2) merges the minima into the
// global rho before any Tsallis weight exists. The TPU runs both passes in
// one launch because its grid runs in order; Hopper blocks do not, so the
// passes are two launches in stream order.
//
// Pairs (one C entry each, at the end of this file): DoubleIntegrator +
// DoubleIntegratorCircleCost; AutorallyNN + ARCost (the standard and the
// robust AutoRally cost), whose step runs the FNN (fnn.cuh, B10) from weights
// staged in shared memory and whose cost reads the track costmap
// (map_texture.cuh, B9) from global memory; and BicycleSlip + the AutoRally
// cost on the bicycle's output layout (ARCostT<0, 1, 2, 8, 5, 6>).
// Dyn::stage runs in every thread before any sample is skipped, so the
// barrier after it sees the whole block.
//
// Kernel 2, flash_combine_kernel: one block merges the carries of all blocks
// in a fixed order, with the rescaling of pallas_solve.flash_combine:
//   m = max m_b, d = sum d_b exp(m_b - m), num = sum num_b exp(m_b - m)
// and writes new_mean = num / d (T, C), baseline = -lambda * m and eta = d
// (and num itself where asked). It also merges the Tsallis rows, whose m_b
// are 0: every scale is exp(0) = 1 and the merge is a plain ordered sum.
// The TPU carries the sums from one grid step to the next; Hopper blocks run
// in no order, so the merge is a second pass. It uses no atomics: the result
// is the same from run to run.
//
// What bounds it on this card: the data are small (U is K*T*C*4 bytes, 6.6 MB
// at K=8192, T=100, C=2: 2 us at 3.35 TB/s) and the arithmetic is less (about
// 50 operations per sample-step: under 1 us at 67 TFLOP/s fp32). What bounds
// the simple design is latency: each thread walks a dependent chain of T
// steps, and K=8192 threads in blocks of 64 fill the 132 SMs with only a few
// warps each. The design keeps everything on chip that the TPU kernel keeps
// in VMEM (state, running cost, LR tables in L1), and reads U from device
// memory once for the rollout and once more, from L2, for the epilogue.
// The AutoRally pair does about 3,000 operations per sample-step (the FNN's
// 1,344 multiply-adds, 64 tanhf, sinf/cosf twice, two map queries), so there
// the arithmetic bounds the function; at K=1920 its 30 blocks of 64 fill 30
// of the 132 SMs with two warps each, and each thread's 150-step chain is
// what the simple design waits on. The bicycle pair does about 500
// operations per sample-step (four tanhf, tanf, two sinf/cosf pairs, two map
// queries) on the same 30 blocks at K=1920; the same latency bounds it.
//
// Layout: U is the public (K, T, C) row-major tensor. The rollout thread of
// sample k reads its own contiguous T*C row: neighbouring threads are 800 B
// apart, so a warp's load touches 32 lines, but each line is reused for the
// next 16 steps from L1. The epilogue maps threads to the (t, c) outputs and
// loops over the block's samples, so its reads of the same (K, T, C) tensor
// are coalesced. The TPU kernel's channel-major (C, T, K_pad) transpose, its
// 128-lane tiles, its SMEM/VMEM/stream table modes and its split-cost scratch
// are TPU mechanics and are not ported.
//
// Numerics: built without --use_fast_math and with --fmad=false; expf, logf
// and sqrtf; every operation in the order of the plain PyTorch version. Costs
// and crash flags then agree with the plain version bit for bit, and a sample
// that grazes the crash annulus is classified the same way by both. Only the
// epilogue's sums are taken in another order than PyTorch's.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "ar_standard_cost.cuh"
#include "autorally_nn.cuh"
#include "bicycle_slip.cuh"
#include "double_integrator.cuh"
#include "double_integrator_circle_cost.cuh"
#include "mppi_common.cuh"

namespace {

constexpr int kBlock = 64;  // samples (threads) per block of kernel 1
constexpr int kCombineThreads = 256;
// kernel 1's epilogue modes (EPI_* in ops/fused_rollout.py)
constexpr int kEpiNone = 0, kEpiExp = 1, kEpiMin = 2;

struct LRArgs {
  const float* mean;   // (T, C) the sampling mean
  const float* sigma;  // (T, C) the sampling std-dev
  const float* coeff;  // (C,) control-cost coefficients
  float gain;          // 0.5 * lambda * (1 - alpha)
  float pure_thresh;   // (1 - p) * K: samples k >= it have mu = 0
};

template <class Dyn, class Cost, int EPI, bool WITH_LR, bool PER_SAMPLE_X0>
__global__ void __launch_bounds__(kBlock)
rollout_costs_kernel(const float* __restrict__ x0,
                     const float* __restrict__ U, int K, int T, float dt,
                     ModelArgs m, LRArgs lr, float lam_w,
                     float* __restrict__ costs, int* __restrict__ crash_out,
                     float* __restrict__ carry) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  const int TC = T * C;
  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < K;

  // the model's parameters, staged by every thread before any returns
  __shared__ typename Dyn::Shared dyn_sh;
  Dyn::stage(m.dyn_params, &dyn_sh);
  if (Dyn::kStaged) __syncthreads();

  float J = 0.0f;
  if (valid) {
    const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
    float x[S];
    float y[O];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = PER_SAMPLE_X0 ? x0[k * S + i] : x0[i];
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = 0.0f;
    int crash = 0;
    float acc = 0.0f;
    const bool pure = WITH_LR && static_cast<float>(k) >= lr.pure_thresh;
    const float* u_row = U + static_cast<size_t>(k) * TC;
    for (int t = 0; t < T; ++t) {
      float u[C];
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = u_row[t * C + c];
      Dyn::step(dyn_sh, x, u, static_cast<float>(t), dt, y);
      float cost = Cost::running_cost(cp, y, u, t, &crash);
      if (WITH_LR) {
        float lr_t = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float mu = pure ? 0.0f : lr.mean[t * C + c];
          const float sg = lr.sigma[t * C + c];
          lr_t = lr_t + lr.coeff[c] * mu * (mu - 2.0f * u[c]) / (sg * sg);
        }
        cost = cost + lr.gain * lr_t;
      }
      acc = acc + cost;
    }
    J = (acc + Cost::terminal_cost(cp, y)) / static_cast<float>(T);
    costs[k] = J;
    crash_out[k] = crash;
  }

  if (EPI == kEpiExp) write_block_carry<kBlock>(J, valid, lam_w, U, K, TC, carry);
  if (EPI == kEpiMin) write_block_min<kBlock>(J, valid, carry);
}

__global__ void __launch_bounds__(kCombineThreads)
flash_combine_kernel(const float* __restrict__ carry, int nb, int TC,
                     float lam, float* __restrict__ new_mean,
                     float* __restrict__ scal, float* __restrict__ num) {
  __shared__ float red[kCombineThreads];
  const int tid = threadIdx.x;
  const size_t ld = static_cast<size_t>(2 + TC);

  float m = kMasked;
  for (int b = tid; b < nb; b += kCombineThreads) m = fmaxf(m, carry[b * ld]);
  const float m_g = block_max<kCombineThreads>(m, red);

  float d = 0.0f;
  for (int b = tid; b < nb; b += kCombineThreads) {
    d = d + carry[b * ld + 1] * expf(carry[b * ld] - m_g);
  }
  const float d_g = block_sum<kCombineThreads>(d, red);

  for (int j = tid; j < TC; j += kCombineThreads) {
    float a = 0.0f;
    for (int b = 0; b < nb; ++b) {
      a = a + carry[b * ld + 2 + j] * expf(carry[b * ld] - m_g);
    }
    new_mean[j] = a / d_g;
    if (num != nullptr) num[j] = a;
  }
  if (tid == 0) {
    scal[0] = -lam * m_g;
    scal[1] = d_g;
  }
}

template <class Dyn, class Cost, int EPI, bool WITH_LR>
void launch_rollout(bool per_sample_x0, const float* x0, const float* U,
                    int K, int T, float dt, ModelArgs m, LRArgs lr,
                    float lam_w, float* costs, int* crash, float* carry,
                    cudaStream_t stream) {
  const int nb = (K + kBlock - 1) / kBlock;
  if (per_sample_x0) {
    rollout_costs_kernel<Dyn, Cost, EPI, WITH_LR, true>
        <<<nb, kBlock, 0, stream>>>(x0, U, K, T, dt, m, lr, lam_w, costs,
                                    crash, carry);
  } else {
    rollout_costs_kernel<Dyn, Cost, EPI, WITH_LR, false>
        <<<nb, kBlock, 0, stream>>>(x0, U, K, T, dt, m, lr, lam_w, costs,
                                    crash, carry);
  }
}

template <class Dyn, class Cost, int EPI>
void launch_rollout_lr(bool with_lr, bool per_sample_x0, const float* x0,
                       const float* U, int K, int T, float dt, ModelArgs m,
                       LRArgs lr, float lam_w, float* costs, int* crash,
                       float* carry, cudaStream_t stream) {
  if (with_lr) {
    launch_rollout<Dyn, Cost, EPI, true>(per_sample_x0, x0, U, K, T, dt, m, lr,
                                         lam_w, costs, crash, carry, stream);
  } else {
    launch_rollout<Dyn, Cost, EPI, false>(per_sample_x0, x0, U, K, T, dt, m, lr,
                                          lam_w, costs, crash, carry, stream);
  }
}

// Kernel 1 for the pair (Dyn, Cost) in the mode the flags select.
template <class Dyn, class Cost>
int rollout_entry(int device, const float* x0, const float* U, int K, int T,
                  float dt, ModelArgs m, LRArgs lr, int with_lr, int epilogue,
                  int per_sample_x0, float lam_w, float* costs, int* crash,
                  float* carry, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool lr_on = with_lr != 0;
  const bool ps = per_sample_x0 != 0;
  if (epilogue == kEpiExp) {
    launch_rollout_lr<Dyn, Cost, kEpiExp>(lr_on, ps, x0, U, K, T, dt, m, lr,
                                          lam_w, costs, crash, carry, s);
  } else if (epilogue == kEpiMin) {
    launch_rollout_lr<Dyn, Cost, kEpiMin>(lr_on, ps, x0, U, K, T, dt, m, lr,
                                          lam_w, costs, crash, carry, s);
  } else if (epilogue == kEpiNone) {
    launch_rollout_lr<Dyn, Cost, kEpiNone>(lr_on, ps, x0, U, K, T, dt, m, lr,
                                           lam_w, costs, crash, carry, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Samples per block of the rollout kernel: the epilogue writes one carry row
// of 2 + T*C floats for each block of this many samples.
int fused_rollout_block_size() { return kBlock; }

// Kernel 1 for one (dynamics, cost) pair. Every pointer is memory of CUDA
// device `device`, and `stream` one of its streams; dyn_params and cost_map
// may be null for a pair that reads none, lr_* when with_lr == 0. epilogue:
// 0 none (carry may be null), 1 the exp carry rows (nb, 2 + T*C), 2 the
// Tsallis block minima (nb,). x0 is (K, S) when per_sample_x0 != 0, else
// (S,). Returns the CUDA error of the launch (0 when it was accepted).
#define ROLLOUT_ENTRY(NAME, DYN, COST)                                        \
  int NAME(int device, const float* x0, const float* U, int K, int T,        \
           float dt, const float* dyn_params, const float* cost_params,      \
           const float* cost_map, const float* lr_mean,                      \
           const float* lr_sigma, const float* lr_coeff, float lr_gain,      \
           float pure_thresh, int with_lr, int epilogue, int per_sample_x0,  \
           float lam_w, float* costs, int* crash, float* carry,              \
           void* stream) {                                                   \
    return rollout_entry<DYN, COST>(                                         \
        device, x0, U, K, T, dt, ModelArgs{dyn_params, cost_params, cost_map}, \
        LRArgs{lr_mean, lr_sigma, lr_coeff, lr_gain, pure_thresh}, with_lr,  \
        epilogue, per_sample_x0, lam_w, costs, crash, carry, stream);        \
  }

// DoubleIntegrator + DoubleIntegratorCircleCost
ROLLOUT_ENTRY(rollout_costs_di_circle, DoubleIntegrator, DoubleIntegratorCircleCost)
// AutorallyNN (6-32-32-4) + ARStandardCost / ARRobustCost
ROLLOUT_ENTRY(rollout_costs_ar_nn, AutorallyNN, ARCost)
// BicycleSlip + ARStandardCost / ARRobustCost, output_indices (0, 1, 2, 8, 5, 6)
ROLLOUT_ENTRY(rollout_costs_bicycle_ar, BicycleSlip, ARCostBicycle)
#undef ROLLOUT_ENTRY

// Kernel 2: merges nb carry rows of 2 + TC floats into new_mean (TC,) and
// scal = [baseline, eta], and into num (TC,), the merged sum, unless num is
// null; on CUDA device `device`. Returns the CUDA error of the launch (0
// when it was accepted).
int flash_combine(int device, const float* carry, int nb, int TC, float lam,
                  float* new_mean, float* scal, float* num, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  flash_combine_kernel<<<1, kCombineThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      carry, nb, TC, lam, new_mean, scal, num);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
