// Fused MPPI rollout + flash (online-softmax) normExp epilogue for Hopper.
//
// Replaces the TPU kernel mppi_generic_tpu/ops/pallas_rollout.py::_fused_call
// in its plain-costs mode (fused_rollout_costs) and its exp-epilogue mode
// (fused_weighted_rollout), both with and without the in-loop Gaussian
// likelihood-ratio (LR) cost. The plain PyTorch versions of both kernels are
// in mppi_generic_tpu_torch/ops/fused_rollout.py; the wrappers there launch
// these kernels through the C functions at the end of this file.
//
// Kernel 1, rollout_costs_kernel<Dyn, Cost, EPILOGUE, WITH_LR>: one thread
// per sample, the T-step loop inside the thread, the state in registers.
// Per sample it writes costs[k] = (sum_t running + LR + terminal) / T and the
// sticky crash flag. With EPILOGUE each block of kBlock samples also reduces
// its samples into one carry row (m_b, d_b, num_b[T*C]):
//   s_k = -J_k / lambda (s = -1e30 past K, so the ragged tail adds nothing),
//   m_b = max s_k,  d_b = sum exp(s_k - m_b),  num_b = sum exp(s_k - m_b) U_k
// which is the TPU kernel's _init/_accum math done per block.
//
// Kernel 2, flash_combine_kernel: one block merges the carries of all blocks
// in a fixed order, with the rescaling of pallas_solve.flash_combine:
//   m = max m_b, d = sum d_b exp(m_b - m), num = sum num_b exp(m_b - m)
// and writes new_mean = num / d (T, C), baseline = -lambda * m and eta = d.
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

#include "double_integrator.cuh"
#include "double_integrator_circle_cost.cuh"

namespace {

constexpr int kBlock = 64;  // samples (threads) per block of kernel 1
constexpr int kCombineThreads = 256;
constexpr float kMasked = -1e30f;

struct LRArgs {
  const float* mean;   // (T, C) the sampling mean
  const float* sigma;  // (T, C) the sampling std-dev
  const float* coeff;  // (C,) control-cost coefficients
  float gain;          // 0.5 * lambda * (1 - alpha)
  float pure_thresh;   // (1 - p) * K: samples k >= it have mu = 0
};

template <int N>
__device__ inline float block_max(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] = fmaxf(red[tid], red[tid + off]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

template <int N>
__device__ inline float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] = red[tid] + red[tid + off];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

template <class Dyn, class Cost, bool EPILOGUE, bool WITH_LR>
__global__ void __launch_bounds__(kBlock)
rollout_costs_kernel(const float* __restrict__ x0,
                     const float* __restrict__ U, int K, int T, float dt,
                     const float* __restrict__ cost_params, LRArgs lr,
                     float lam_w, float* __restrict__ costs,
                     int* __restrict__ crash_out, float* __restrict__ carry) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  const int TC = T * C;
  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < K;

  float J = 0.0f;
  if (valid) {
    const typename Cost::Params cp = Cost::load(cost_params);
    float x[S];
    float y[O];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x0[i];
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
      Dyn::step(x, u, static_cast<float>(t), dt, y);
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

  if (EPILOGUE) {
    __shared__ float red[kBlock];
    __shared__ float w_s[kBlock];
    const float s = valid ? (-J) / lam_w : kMasked;
    const float m_b = block_max<kBlock>(s, red);
    const float w = expf(s - m_b);  // exactly 0 for the masked tail
    w_s[threadIdx.x] = w;
    const float d_b = block_sum<kBlock>(w, red);  // syncs: w_s is visible
    const int base = blockIdx.x * kBlock;
    const int n_valid = min(kBlock, K - base);
    const float* Ub = U + static_cast<size_t>(base) * TC;
    float* row = carry + static_cast<size_t>(blockIdx.x) * (2 + TC);
    for (int j = threadIdx.x; j < TC; j += kBlock) {
      float a = 0.0f;
      for (int i = 0; i < n_valid; ++i) {
        a = a + w_s[i] * Ub[static_cast<size_t>(i) * TC + j];
      }
      row[2 + j] = a;
    }
    if (threadIdx.x == 0) {
      row[0] = m_b;
      row[1] = d_b;
    }
  }
}

__global__ void __launch_bounds__(kCombineThreads)
flash_combine_kernel(const float* __restrict__ carry, int nb, int TC,
                     float lam, float* __restrict__ new_mean,
                     float* __restrict__ scal) {
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
  }
  if (tid == 0) {
    scal[0] = -lam * m_g;
    scal[1] = d_g;
  }
}

template <class Dyn, class Cost, bool EPILOGUE, bool WITH_LR>
void launch_rollout(const float* x0, const float* U, int K, int T, float dt,
                    const float* cost_params, LRArgs lr, float lam_w,
                    float* costs, int* crash, float* carry,
                    cudaStream_t stream) {
  const int nb = (K + kBlock - 1) / kBlock;
  rollout_costs_kernel<Dyn, Cost, EPILOGUE, WITH_LR>
      <<<nb, kBlock, 0, stream>>>(x0, U, K, T, dt, cost_params, lr, lam_w,
                                  costs, crash, carry);
}

}  // namespace

extern "C" {

// Samples per block of the rollout kernel: the epilogue writes one carry row
// of 2 + T*C floats for each block of this many samples.
int fused_rollout_block_size() { return kBlock; }

// Kernel 1 for DoubleIntegrator + DoubleIntegratorCircleCost. Every pointer
// is memory of CUDA device `device`, and `stream` one of its streams; lr_*
// may be null when with_lr == 0, carry when epilogue == 0. Returns the CUDA
// error of the launch (0 when it was accepted).
int rollout_costs_di_circle(int device, const float* x0, const float* U,
                            int K, int T, float dt, const float* cost_params,
                            const float* lr_mean, const float* lr_sigma,
                            const float* lr_coeff, float lr_gain,
                            float pure_thresh, int with_lr, int epilogue,
                            float lam_w, float* costs, int* crash,
                            float* carry, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  using D = DoubleIntegrator;
  using Q = DoubleIntegratorCircleCost;
  const LRArgs lr{lr_mean, lr_sigma, lr_coeff, lr_gain, pure_thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epilogue && with_lr) {
    launch_rollout<D, Q, true, true>(x0, U, K, T, dt, cost_params, lr, lam_w,
                                     costs, crash, carry, s);
  } else if (epilogue) {
    launch_rollout<D, Q, true, false>(x0, U, K, T, dt, cost_params, lr, lam_w,
                                      costs, crash, carry, s);
  } else if (with_lr) {
    launch_rollout<D, Q, false, true>(x0, U, K, T, dt, cost_params, lr, lam_w,
                                      costs, crash, carry, s);
  } else {
    launch_rollout<D, Q, false, false>(x0, U, K, T, dt, cost_params, lr,
                                       lam_w, costs, crash, carry, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2: merges nb carry rows of 2 + TC floats into new_mean (TC,) and
// scal = [baseline, eta], on CUDA device `device`. Returns the CUDA error of
// the launch (0 when it was accepted).
int flash_combine(int device, const float* carry, int nb, int TC, float lam,
                  float* new_mean, float* scal, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  flash_combine_kernel<<<1, kCombineThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      carry, nb, TC, lam, new_mean, scal);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
