// The merge of the flash (online-softmax) carry rows, the one kernel of the
// rollout and sampling paths that no (dynamics, cost) pair enters.
//
// flash_combine_tiled_kernel replaces the carry of the TPU kernels' normExp
// epilogue across grid steps (mppi_generic_tpu/ops/pallas_rollout.py
// _accum, :1005, and pallas_solve.flash_combine, :461-477). It merges the
// carry rows of all blocks of the rollout (rollout_kernel.cuh) or sampling
// kernels (sample_kernels.cuh) in a fixed order:
//   m = max m_b, d = sum d_b exp(m_b - m), num = sum num_b exp(m_b - m)
// and writes new_mean = num / d (T, C), baseline = -lambda * m and eta = d
// (and num itself where asked). It also merges the Tsallis rows of
// tsallis_reduce.cu, whose m_b are 0: every scale is exp(0) = 1 and the merge
// is a plain ordered sum. The TPU carries the sums from one grid step to the
// next; Hopper blocks run in no order, so the merge is a second pass. It uses
// no atomics: the result is the same from run to run. The plain PyTorch
// version is flash_combine_plain in mppi_generic_tpu_torch/ops/fused_rollout.py.
//
// What bounds it: latency. The function reads nb (2 + T*C) floats and writes
// T*C (+ 2): 103 KB at the flagship's nb = 128, T*C = 200 (0.03 us at
// 3.35 TB/s), against a launch of a few microseconds. So the design shortens
// the chain of dependent steps. The columns are spread over blocks of
// kCombineCols; each block copies its slab of the rows into shared memory by
// cp.async (4-byte copies: a row is 2 + T*C floats, so its columns need not
// sit on 16 bytes), all in flight at once, while it takes m and d by the
// same 256-lane trees as the one-block kernel; each row's scale
// exp(m_b - m) is computed once into shared memory. A column's sum then
// walks the rows in order from shared memory. Every block takes the same m
// and d and every column the same products in the same order, so the
// outputs equal the one-block kernel's bit for bit (--fmad=false keeps each
// product rounded on its own). -DMPPI_COMBINE_ONE_BLOCK builds that kernel
// instead (flash_combine_kernel: one block, each thread walking its columns
// over all rows in global memory, nb exp a column), for A B B A.
//
// Beside the merge, this library launches the carry and minima passes of
// block_pass.cuh on their own (block_carry_pass, block_min_pass): the warp
// forms launch them after their kernel, these entries on costs and X already
// on the device, so that a pass is checked and timed alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "block_pass.cuh"
#include "mppi_common.cuh"

namespace {

constexpr int kCombineThreads = 256;
constexpr int kCombineCols = 32;   // columns of a block of the tiled merge
constexpr int kCombineRows = 128;  // rows of a slab staged at once

#ifdef MPPI_COMBINE_ONE_BLOCK
constexpr int kCombineForm = 0;
#else
constexpr int kCombineForm = 4;
#endif

// m_g = max m_b and d_g = sum d_b exp(m_b - m_g), each thread taking the
// rows tid, tid + 256, ... in order, then the 256-lane trees
__device__ inline void merge_scalars(const float* __restrict__ carry, int nb,
                                     size_t ld, float* red, float* m_out,
                                     float* d_out) {
  const int tid = threadIdx.x;
  float m = kMasked;
  for (int b = tid; b < nb; b += kCombineThreads) m = fmaxf(m, carry[b * ld]);
  const float m_g = block_max<kCombineThreads>(m, red);
  float d = 0.0f;
  for (int b = tid; b < nb; b += kCombineThreads) {
    d = d + carry[b * ld + 1] * expf(carry[b * ld] - m_g);
  }
  *m_out = m_g;
  *d_out = block_sum<kCombineThreads>(d, red);
}

__global__ void __launch_bounds__(kCombineThreads)
flash_combine_kernel(const float* __restrict__ carry, int nb, int TC,
                     float lam, float* __restrict__ new_mean,
                     float* __restrict__ scal, float* __restrict__ num) {
  __shared__ float red[kCombineThreads];
  const int tid = threadIdx.x;
  const size_t ld = static_cast<size_t>(2 + TC);
  float m_g, d_g;
  merge_scalars(carry, nb, ld, red, &m_g, &d_g);
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

// rows b0 .. b0 + rows - 1, columns j0 .. j0 + ncol - 1 of the carry into
// tile[r][c] by cp.async, committed as one group
__device__ inline void stage_slab(const float* carry, size_t ld, int b0,
                                  int rows, int j0, int ncol,
                                  float (*tile)[kCombineCols]) {
  for (int e = threadIdx.x; e < rows * kCombineCols; e += kCombineThreads) {
    const int r = e / kCombineCols;
    const int c = e % kCombineCols;
    if (c < ncol) cp_async_f32(&tile[r][c], carry + (b0 + r) * ld + 2 + j0 + c);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kCombineThreads)
flash_combine_tiled_kernel(const float* __restrict__ carry, int nb, int TC,
                           float lam, float* __restrict__ new_mean,
                           float* __restrict__ scal, float* __restrict__ num) {
  __shared__ float red[kCombineThreads];
  __shared__ float tile[kCombineRows][kCombineCols];
  __shared__ float scale[kCombineRows];
  const int tid = threadIdx.x;
  const size_t ld = static_cast<size_t>(2 + TC);
  const int j0 = blockIdx.x * kCombineCols;
  const int ncol = min(kCombineCols, TC - j0);
  // the first slab's copies fly while the trees take m_g and d_g
  stage_slab(carry, ld, 0, min(nb, kCombineRows), j0, ncol, tile);
  float m_g, d_g;
  merge_scalars(carry, nb, ld, red, &m_g, &d_g);
  float a = 0.0f;  // column j0 + tid's sum, rows in order
  for (int b0 = 0; b0 < nb; b0 += kCombineRows) {
    const int rows = min(kCombineRows, nb - b0);
    if (b0 > 0) {
      __syncthreads();  // the last slab's tile and scales are read
      stage_slab(carry, ld, b0, rows, j0, ncol, tile);
    }
    for (int r = tid; r < rows; r += kCombineThreads) {
      scale[r] = expf(carry[(b0 + r) * ld] - m_g);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (tid < ncol) {
      for (int r = 0; r < rows; ++r) a = a + tile[r][tid] * scale[r];
    }
  }
  if (tid < ncol) {
    new_mean[j0 + tid] = a / d_g;
    if (num != nullptr) num[j0 + tid] = a;
  }
  if (blockIdx.x == 0 && tid == 0) {
    scal[0] = -lam * m_g;
    scal[1] = d_g;
  }
}

}  // namespace

extern "C" {

// Samples per block of the rollout and sampling kernels: their epilogues
// write one carry row of 2 + T*C floats for each block of this many.
int kernel_block_size() { return kBlockSamples; }

// The form of the merge this build launches: 4 the tiled kernel
// (flash_combine_tiled_kernel), 0 the one-block kernel (flash_combine_kernel).
int flash_combine_form() { return kCombineForm; }

// Merges nb carry rows of 2 + TC floats into new_mean (TC,) and scal =
// [baseline, eta], and into num (TC,), the merged sum, unless num is null;
// on CUDA device `device`. Returns the CUDA error of the launch (0 when it
// was accepted).
int flash_combine(int device, const float* carry, int nb, int TC, float lam,
                  float* new_mean, float* scal, float* num, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kCombineForm == 0) {
    flash_combine_kernel<<<1, kCombineThreads, 0, s>>>(carry, nb, TC, lam,
                                                       new_mean, scal, num);
  } else {
    const int blocks = (TC + kCombineCols - 1) / kCombineCols;
    flash_combine_tiled_kernel<<<blocks, kCombineThreads, 0, s>>>(
        carry, nb, TC, lam, new_mean, scal, num);
  }
  return static_cast<int>(cudaGetLastError());
}

// The carry rows (ceil(K / 64), 2 + TC) of the costs (K,) over X (K, TC),
// the pass the warp forms launch after their kernel, launched alone in this
// build's form (block_pass_form()). Returns the CUDA error of the launch.
int block_carry_pass(int device, const float* costs, const float* X, int K, int TC,
                     float lam_w, float* carry, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return static_cast<int>(launch_block_carry<kBlockSamples>(
      costs, X, K, TC, lam_w, carry, static_cast<cudaStream_t>(stream)));
}

// The minimum of each 64-sample group's valid costs into out
// (ceil(K / 64),), the Tsallis pass 1 the warp form of B1 launches after its
// kernel, launched alone in this build's form. Returns the CUDA error of the
// launch.
int block_min_pass(int device, const float* costs, int K, float* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return static_cast<int>(
      launch_block_min<kBlockSamples>(costs, K, out, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
