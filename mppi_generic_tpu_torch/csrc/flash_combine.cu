// The merge of the flash (online-softmax) carry rows, the one kernel of the
// rollout and sampling paths that no (dynamics, cost) pair enters.
//
// flash_combine_kernel replaces the carry of the TPU kernels' normExp
// epilogue across grid steps (mppi_generic_tpu/ops/pallas_rollout.py
// _accum, :1005, and pallas_solve.flash_combine, :461-477). One block merges
// the carry rows of all blocks of the rollout (rollout_kernel.cuh) or
// sampling kernels (sample_kernels.cuh) in a fixed order:
//   m = max m_b, d = sum d_b exp(m_b - m), num = sum num_b exp(m_b - m)
// and writes new_mean = num / d (T, C), baseline = -lambda * m and eta = d
// (and num itself where asked). It also merges the Tsallis rows of
// tsallis_reduce.cu, whose m_b are 0: every scale is exp(0) = 1 and the merge
// is a plain ordered sum. The TPU carries the sums from one grid step to the
// next; Hopper blocks run in no order, so the merge is a second pass. It uses
// no atomics: the result is the same from run to run. The plain PyTorch
// version is flash_combine_plain in mppi_generic_tpu_torch/ops/fused_rollout.py.
//
// What bounds it: latency. The function reads nb (2 + T*C) floats (0.8 MB at
// K=8192, T=100: 0.03 us at 3.35 TB/s); one block of 256 threads walks the
// rows in order.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mppi_common.cuh"

namespace {

constexpr int kCombineThreads = 256;

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

}  // namespace

extern "C" {

// Samples per block of the rollout and sampling kernels: their epilogues
// write one carry row of 2 + T*C floats for each block of this many.
int kernel_block_size() { return kBlockSamples; }

// Merges nb carry rows of 2 + TC floats into new_mean (TC,) and scal =
// [baseline, eta], and into num (TC,), the merged sum, unless num is null;
// on CUDA device `device`. Returns the CUDA error of the launch (0 when it
// was accepted).
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
