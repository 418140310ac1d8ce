// Tsallis weights against the global minimum cost, and their weighted sum of
// the samples: pass 2 of the rollout kernel's Tsallis epilogue.
//
// Replaces the TPU kernel mppi_generic_tpu/ops/pallas_rollout.py::
// _tsallis_reduce_call (:1342, call :1391), and pass 2 of _fused_call's
// two-pass Tsallis epilogue (:937-965). The plain PyTorch version is
// tsallis_rows_plain in mppi_generic_tpu_torch/ops/fused_rollout.py; the
// wrapper tsallis_block_rows launches this kernel through the C function at
// the end of this file.
//
// tsallis_reduce_kernel: one block per kBlock samples.
//   1. rho = the minimum of rho_src[0 .. n_rho): the rollout kernel's block
//      minima (pass 1, rollout_costs_kernel<..., kEpiMin, ...>), or one given
//      rho (tsallis_reduce, for a rho merged across devices). Every block
//      reduces the same values, so every block finds the same rho; a NaN
//      gives a NaN rho, as jnp.min. The TPU's pass 1 carries the running
//      minimum across its ordered grid; Hopper blocks run in no order, so the
//      minimum must be complete before this launch: stream order guarantees
//      it, and no block of this kernel reads a minimum the rollout kernel has
//      not written.
//   2. per sample k < K_valid: dj = J_k - rho, b = max(1 - dj / gamma, 1e-30),
//      w_k = dj < gamma ? expf(logf(b) * pw) : 0 with pw = 1 / (r - 1) formed
//      once in float32 by the wrapper (the TPU kernel multiplies by it; the
//      eager ops/weights.tsallis_weights divides by r - 1); w_k = 0 past
//      K_valid.
//   3. the block's row (0, sum w, sum w U[T*C]), summed left to right over the
//      block's samples; threads map to the (t, c) columns, so the reads of the
//      (K, T, C) tensor are coalesced. The 0 in front makes the row a flash
//      carry with m_b = 0, which flash_combine_kernel (flash_combine.cu)
//      merges as a plain ordered sum: no atomics, the same result every run.
//
// What bounds it on this card: the bytes. It reads U once (K*T*C*4 bytes, 6.6
// MB at K=8192, T=100, C=2: 2 us at 3.35 TB/s) and does 2 operations per
// element; 128 blocks at K=8192 fill 128 of the 132 SMs with 8 warps each.
//
// Numerics: built without --use_fast_math and with --fmad=false; logf, expf,
// true divisions; the plain version repeats the operations in order, so the
// rows agree with it bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mppi_common.cuh"

namespace {

constexpr int kBlock = 64;     // samples per block: one row each
constexpr int kThreads = 256;  // threads per block: the (t, c) columns

__global__ void __launch_bounds__(kThreads)
tsallis_reduce_kernel(const float* __restrict__ U,
                      const float* __restrict__ costs,
                      const float* __restrict__ rho_src, int n_rho,
                      int K_valid, int K, int TC, float gamma, float pw,
                      float* __restrict__ rows, float* __restrict__ rho_out) {
  __shared__ float red[kThreads];
  __shared__ float w_s[kBlock];
  const int tid = threadIdx.x;

  float m = INFINITY;
  for (int i = tid; i < n_rho; i += kThreads) m = nan_min(m, rho_src[i]);
  const float rho = block_min_nan<kThreads>(m, red);

  const int base = blockIdx.x * kBlock;
  if (tid < kBlock) {
    const int k = base + tid;
    float w = 0.0f;
    if (k < K_valid) {
      const float dj = costs[k] - rho;
      const float b = fmaxf(1.0f - dj / gamma, static_cast<float>(1e-30));
      w = dj < gamma ? expf(logf(b) * pw) : 0.0f;
    }
    w_s[tid] = w;
  }
  __syncthreads();

  const int n_valid = max(0, min(kBlock, K_valid - base));
  const float* Ub = U + static_cast<size_t>(base) * TC;
  float* row = rows + static_cast<size_t>(blockIdx.x) * (2 + TC);
  for (int j = tid; j <= TC; j += kThreads) {
    float a = 0.0f;
    if (j == 0) {
      for (int i = 0; i < n_valid; ++i) a = a + w_s[i];
    } else {
      for (int i = 0; i < n_valid; ++i) {
        a = a + w_s[i] * Ub[static_cast<size_t>(i) * TC + (j - 1)];
      }
    }
    row[1 + j] = a;
  }
  if (tid == 0) {
    row[0] = 0.0f;
    if (blockIdx.x == 0) rho_out[0] = rho;
  }
}

}  // namespace

extern "C" {

// Samples per block: one row of 2 + T*C floats for each block of this many.
int tsallis_reduce_block_size() { return kBlock; }

// The Tsallis rows of the K (K, T, C) samples U with costs (K,), against the
// minimum of rho_src (n_rho floats), samples k >= K_valid weighing 0: rows
// (ceil(K / kBlock), 2 + TC), rho_out the minimum. Every pointer is memory of
// CUDA device `device`, and `stream` one of its streams. Returns the CUDA
// error of the launch (0 when it was accepted).
int tsallis_reduce(int device, const float* U, const float* costs,
                   const float* rho_src, int n_rho, int K_valid, int K, int TC,
                   float gamma, float pw, float* rows, float* rho_out,
                   void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int nb = (K + kBlock - 1) / kBlock;
  tsallis_reduce_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      U, costs, rho_src, n_rho, K_valid, K, TC, gamma, pw, rows, rho_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
