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
// The function, per block of kBlock samples (one row each):
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
//   3. the block's row (0, sum w, sum w U[T*C]), each column summed left to
//      right over the block's valid samples. The 0 in front makes the row a
//      flash carry with m_b = 0, which the merge (flash_combine.cu) takes as
//      a plain ordered sum: no atomics, the same result every run.
//
// What bounds it on this card: the bytes. It reads U once (K*T*C*4 bytes, 6.6
// MB at K=8192, T=100, C=2: 2 us at 3.35 TB/s) and does 2 operations per
// element. So the design keeps many loads in flight and little in the way:
// tsallis_reduce_tiled_kernel spreads each 64-sample block over a grid of
// (sample block, column tile), 128 x 4 blocks of 256 threads at K = 8192,
// T*C = 200. A block first issues its whole slab of U (the block's valid
// samples x its tile's columns) into shared memory by cp.async, in 16-byte
// pieces where T*C and U's address allow it (4-byte pieces otherwise), all
// in flight at once; while they travel it reads its 64 costs and the minima,
// reduces rho by warp shuffles and one barrier and makes the 64 weights;
// then each thread sums one column of the slab from shared memory, and tile
// 0 also sums w. What is left is latency: a chain of two overlapped reads,
// the weights and a 64-add sum per block, about 1.9x the bytes' bound at
// K = 8192 (PERF.md). The one-block kernel (tsallis_reduce_kernel, one block
// of 256 threads per 64 samples, rho by block_min_nan's tree, each thread
// walking its columns through global memory, one load behind each add) is
// built instead with -DMPPI_TSALLIS_ONE_BLOCK, for A B B A. The minimum is
// the same in any order and every sum is taken in the same order, so their
// rows and rho are equal bit for bit.
//
// Numerics: built without --use_fast_math and with --fmad=false; logf, expf,
// true divisions; the plain version repeats the operations in order, so the
// rows agree with it bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mppi_common.cuh"
#include "warp.cuh"

namespace {

constexpr int kBlock = 64;        // samples per block: one row each
constexpr int kThreads = 256;     // threads per block
constexpr int kTileCols = 64;     // the most columns of a tile (one a thread)

#ifdef MPPI_TSALLIS_ONE_BLOCK
constexpr int kTsallisForm = 0;
#else
constexpr int kTsallisForm = 4;
#endif

// w_k of one valid sample's cost against rho: step 2 above
__device__ inline float tsallis_weight(float cost, float rho, float gamma, float pw) {
  const float dj = cost - rho;
  const float b = fmaxf(1.0f - dj / gamma, static_cast<float>(1e-30));
  return dj < gamma ? expf(logf(b) * pw) : 0.0f;
}

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
    w_s[tid] = k < K_valid ? tsallis_weight(costs[k], rho, gamma, pw) : 0.0f;
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

// Block (b, tile): the columns [tile * W, min(T*C, (tile + 1) * W)) of sample
// block b's row, W <= kTileCols a multiple of 4; tile 0 also writes sum w, the
// row's 0 and (block 0) rho. VEC: the slab arrives in 16-byte pieces (T*C a
// multiple of 4 and U on 16 bytes), else in 4-byte pieces.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
tsallis_reduce_tiled_kernel(const float* __restrict__ U,
                            const float* __restrict__ costs,
                            const float* __restrict__ rho_src, int n_rho,
                            int K_valid, int K, int TC, int W, float gamma, float pw,
                            float* __restrict__ rows, float* __restrict__ rho_out) {
  __shared__ __align__(16) float slab[kBlock * kTileCols];  // [i][c], pitch W
  __shared__ float red[kThreads / 32];
  __shared__ float w_s[kBlock];
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kBlock;
  const int c0 = blockIdx.y * W;
  const int ncol = min(W, TC - c0);
  const int n_valid = max(0, min(kBlock, K_valid - base));
  const float* Ub = U + static_cast<size_t>(base) * TC + c0;

  // the slab, all of it in flight before rho and the weights are made
  if (VEC) {
    const int pieces = ncol / 4;
    for (int e = tid; e < n_valid * pieces; e += kThreads) {
      const int i = e / pieces;
      const int q = e - i * pieces;
      cp_async_16(&slab[i * W + 4 * q], Ub + static_cast<size_t>(i) * TC + 4 * q);
    }
  } else {
    for (int e = tid; e < n_valid * ncol; e += kThreads) {
      const int i = e / ncol;
      const int c = e - i * ncol;
      cp_async_f32(&slab[i * W + c], Ub + static_cast<size_t>(i) * TC + c);
    }
  }
  cp_async_commit();

  // the cost read before rho, so that the two reads overlap; rho by warp
  // shuffles, then the warps' minima in order (one barrier, not
  // block_min_nan's eight): the same minimum, a NaN kept whatever the order
  const int k = base + tid;
  const float cost = tid < kBlock && k < K_valid ? costs[k] : 0.0f;
  float m = INFINITY;
  for (int i = tid; i < n_rho; i += kThreads) m = nan_min(m, rho_src[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_min(m, __shfl_xor_sync(kFullMask, m, off));
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  float rho = red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) rho = nan_min(rho, red[i]);
  if (tid < kBlock) w_s[tid] = k < K_valid ? tsallis_weight(cost, rho, gamma, pw) : 0.0f;
  cp_async_wait<0>();
  __syncthreads();  // the slab and w_s

  float* row = rows + static_cast<size_t>(blockIdx.x) * (2 + TC);
  if (tid < ncol) {
    float a = 0.0f;
#pragma unroll 8
    for (int i = 0; i < n_valid; ++i) a = a + w_s[i] * slab[i * W + tid];
    row[2 + c0 + tid] = a;
  } else if (blockIdx.y == 0 && tid == kThreads - 1) {
    float a = 0.0f;
    for (int i = 0; i < n_valid; ++i) a = a + w_s[i];
    row[0] = 0.0f;
    row[1] = a;
    if (blockIdx.x == 0) rho_out[0] = rho;
  }
}

}  // namespace

extern "C" {

// Samples per block: one row of 2 + T*C floats for each block of this many.
int tsallis_reduce_block_size() { return kBlock; }

// The form this build launches: 4 the tiled kernel
// (tsallis_reduce_tiled_kernel), 0 the one-block kernel
// (tsallis_reduce_kernel, -DMPPI_TSALLIS_ONE_BLOCK).
int tsallis_reduce_form() { return kTsallisForm; }

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (K + kBlock - 1) / kBlock;
  if (kTsallisForm == 0) {
    tsallis_reduce_kernel<<<nb, kThreads, 0, s>>>(U, costs, rho_src, n_rho, K_valid, K, TC,
                                                  gamma, pw, rows, rho_out);
  } else {
    // the fewest tiles of at most kTileCols columns, their width rounded up
    // to 16 bytes: 4 tiles of 52 columns at T*C = 200, 5 of 60 at 300
    const int tiles = (TC + kTileCols - 1) / kTileCols;
    const int W = ((TC + tiles - 1) / tiles + 3) / 4 * 4;
    const dim3 grid(nb, (TC + W - 1) / W);
    if (TC % 4 == 0 && reinterpret_cast<uintptr_t>(U) % 16 == 0) {
      tsallis_reduce_tiled_kernel<true><<<grid, kThreads, 0, s>>>(
          U, costs, rho_src, n_rho, K_valid, K, TC, W, gamma, pw, rows, rho_out);
    } else {
      tsallis_reduce_tiled_kernel<false><<<grid, kThreads, 0, s>>>(
          U, costs, rho_src, n_rho, K_valid, K, TC, W, gamma, pw, rows, rho_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
