// The passes after the warp forms of B4, B3 and B1 for the network models
// (sample_warp.cuh, rollout_kernel.cuh): the carry rows of 64-sample groups
// and, for Tsallis pass 1, the groups' minimum costs. The warp kernels hold
// kWarpSamples samples a block (4 or 8), not the 64 of a carry row, so each
// writes its costs (and U or W) and a second launch reduces the groups.
//
// Replaces, after the warp forms, the epilogues of the TPU kernels
// mppi_generic_tpu/ops/pallas_rollout.py::_fused_sample_call (the W
// epilogue, :1646-1650), pallas_solve.py::_fused_solve_call (its carry rows,
// :355-388), pallas_rollout.py::_fused_call (_accum, :1005; the Tsallis
// block minima, :894-965). The plain PyTorch versions are
// block_carries_ordered and block_minima_plain in
// mppi_generic_tpu_torch/ops/fused_rollout.py.
//
// block_carry_tiled_kernel<kTile, VEC>: one block of 64 threads per (64-sample
// group, tile of kTile columns of X): 30 x 10 = 300 blocks at K = 1920,
// T*C = 300 and kTile = kCarryTile = 32. Each block
//   1. waits for the kernel before it (griddepcontrol.wait: the launch is a
//      programmatic dependent of it, so the block is scheduled while that
//      kernel's last blocks drain, and its index math runs ahead);
//   2. issues its whole slab of X (the group's valid rows x the tile's
//      columns) into shared memory by cp.async, in 16-byte pieces where
//      every row starts on 16 bytes (T*C a multiple of 4, X on 16 bytes),
//      else in 4-byte pieces, one commit, so every byte is in flight at once;
//   3. while it travels, reads the 64 costs, s = -J / lam (kMasked past K),
//      and on warp 0 takes m_b = max s and d_b = sum exp(s - m_b) by
//      block_max's and block_sum's trees: the off = 32 step (thread t with
//      thread t + 32's value through shared memory), then off = 16 ... 1 by
//      __shfl_down_sync on the same pairs with the same operation, so m_b
//      and d_b are the floats of those trees; w = expf(s - m_b);
//   4. sums each column of the slab over the group's valid samples left to
//      right, a = a + w_i X_ij, the float of write_block_carry.
// Tiles past 65535 loop (a block then takes tiles y, y + gridDim.y, ...).
//
// block_min_warp_kernel: one warp per 64-sample group (kMinWarps groups a
// block). Lane l holds costs l and l + 32 (kMinPad past K), takes nan_min of
// the pair (block_min_nan's off = 32 step), then nan_min with
// __shfl_down_sync at 16 ... 1: the same pairs in the same order, so the same
// minimum and the same NaN. It waits for the kernel before it as the carry
// pass does.
//
// What bounds them on this card: the carry pass reads the costs and X once
// (2.3 MB at 1920 x 300: 0.7 us at 3.35 TB/s, the bound); X was just
// written by the warp kernel and sits in L2. What kept the one-block
// block_carry_kernel at about 0.2 TB/s was latency: 150 blocks of 64
// threads, 14 barriers for m_b and d_b, then each thread walking its column
// through global memory, a few loads a warp in flight. Here each block has
// its whole slab in flight while it reduces m_b and d_b, two barriers, and
// the column sums read shared memory. The minima pass reads K costs (7.7 KB
// at 1920): it is a launch, and the design removes the shared-memory tree's
// six barriers. -DMPPI_PASS_UNSTAGED builds the earlier kernels instead
// (block_carry_kernel, block_min_kernel: write_block_carry and
// write_block_min over blocks of 64 threads, launched with <<<>>>), for
// A B B A; both give the same floats.
//
// Numerics: built without --use_fast_math and with --fmad=false; expf and
// a true division, as write_block_carry.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mppi_common.cuh"
#include "warp.cuh"

namespace {

#ifdef MPPI_PASS_UNSTAGED
constexpr int kBlockPassForm = 0;
#else
constexpr int kBlockPassForm = 4;
#endif

constexpr int kCarryTile = 32;  // columns of a carry pass block: PERF.md §6's sweep
constexpr int kMinWarps = 4;    // 64-sample groups a block of the minima pass

// The carry rows of kBlock samples over X from the costs, as the one-thread
// kernel's epilogue writes them, spread over a grid of (sample block, column
// tile): each block writes the kBlock columns of its tile (write_block_carry's
// tiles), the same floats as one block writing every column. The earlier
// form, built with -DMPPI_PASS_UNSTAGED.
template <int kBlock>
__global__ void __launch_bounds__(kBlock)
block_carry_kernel(const float* __restrict__ costs, const float* X, int K, int TC,
                   float lam_w, float* __restrict__ carry) {
  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < K;
  write_block_carry<kBlock>(valid ? costs[k] : 0.0f, valid, lam_w, X, K, TC, carry,
                            blockIdx.y, gridDim.y);
}

// The minimum of the valid costs of kBlock-sample block b into out[b]
// (write_block_min). The earlier form, built with -DMPPI_PASS_UNSTAGED.
template <int kBlock>
__global__ void __launch_bounds__(kBlock)
block_min_kernel(const float* __restrict__ costs, int K, float* __restrict__ out) {
  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < K;
  write_block_min<kBlock>(valid ? costs[k] : 0.0f, valid, out);
}

// Waits until the grid this launch depends on (the kernel before it in the
// stream) has completed and its writes are visible; returns at once when
// there is none.
__device__ inline void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Columns [c0, c0 + ncol) of the first n rows of the group's X block Xb (row
// pitch TC) into slab (pitch kTile), all in flight as one cp.async group.
template <int kTile, bool VEC>
__device__ inline void stage_carry_slab(const float* Xb, int TC, int c0, int ncol, int n,
                                        float* slab) {
  const int tid = threadIdx.x;
  if (VEC) {
    const int pieces = ncol >> 2;
    for (int e = tid; e < n * pieces; e += kBlockSamples) {
      const int i = e / pieces;
      const int q = e - i * pieces;
      cp_async_16(&slab[i * kTile + 4 * q], Xb + static_cast<size_t>(i) * TC + c0 + 4 * q);
    }
  } else {
    for (int e = tid; e < n * ncol; e += kBlockSamples) {
      const int i = e / ncol;
      const int c = e - i * ncol;
      cp_async_f32(&slab[i * kTile + c], Xb + static_cast<size_t>(i) * TC + c0 + c);
    }
  }
  cp_async_commit();
}

// The carry pass: block (b, y) writes the columns of tiles y, y + gridDim.y,
// ... of group b's row (m_b and d_b with tile 0). VEC: 16-byte copies (T*C a
// multiple of 4 and X on 16 bytes).
template <int kTile, bool VEC>
__global__ void __launch_bounds__(kBlockSamples)
block_carry_tiled_kernel(const float* __restrict__ costs, const float* __restrict__ X, int K,
                         int TC, float lam_w, float* __restrict__ carry) {
  static_assert(kTile % 4 == 0 && kTile <= kBlockSamples, "a column a thread, 16-byte pieces");
  __shared__ __align__(16) float slab[kBlockSamples * kTile];  // [i][c], pitch kTile
  __shared__ float s_hi[32];  // s of the group's samples 32 ... 63
  __shared__ float w_s[kBlockSamples];
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kBlockSamples;
  const int n_valid = min(kBlockSamples, K - base);
  const int n_tiles = (TC + kTile - 1) / kTile;
  const float* Xb = X + static_cast<size_t>(base) * TC;
  float* row = carry + static_cast<size_t>(blockIdx.x) * (2 + TC);
  int tile = blockIdx.y;
  wait_for_prior_grid();  // costs and X are the previous launch's
  stage_carry_slab<kTile, VEC>(Xb, TC, tile * kTile, min(kTile, TC - tile * kTile), n_valid,
                               slab);

  const int k = base + tid;
  const float s = k < K ? (-costs[k]) / lam_w : kMasked;
  if (tid >= 32) s_hi[tid - 32] = s;
  __syncthreads();
  if (tid < 32) {
    const float s_up = s_hi[tid];
    float m = fmaxf(s, s_up);  // block_max's off = 32 step
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_down_sync(kFullMask, m, off));
    const float m_b = __shfl_sync(kFullMask, m, 0);
    const float w_lo = expf(s - m_b);  // exactly 0 for the masked tail
    const float w_up = expf(s_up - m_b);
    w_s[tid] = w_lo;
    w_s[tid + 32] = w_up;
    float d = w_lo + w_up;  // block_sum's off = 32 step
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d = d + __shfl_down_sync(kFullMask, d, off);
    if (blockIdx.y == 0 && tid == 0) {
      row[0] = m_b;
      row[1] = d;
    }
  }
  for (;;) {
    const int c0 = tile * kTile;
    cp_async_wait<0>();
    __syncthreads();  // the slab and w_s
    if (tid < min(kTile, TC - c0)) {
      float a = 0.0f;
#pragma unroll 8
      for (int i = 0; i < n_valid; ++i) a = a + w_s[i] * slab[i * kTile + tid];
      row[2 + c0 + tid] = a;
    }
    tile += gridDim.y;
    if (tile >= n_tiles) break;
    __syncthreads();  // every column of the slab is read
    stage_carry_slab<kTile, VEC>(Xb, TC, tile * kTile, min(kTile, TC - tile * kTile), n_valid,
                                 slab);
  }
}

// The minima pass: warp w of block b reduces kBlock-sample group
// b * kMinWarps + w into out[group]. A template, as block_min_kernel.
template <int kBlock>
__global__ void __launch_bounds__(32 * kMinWarps)
block_min_warp_kernel(const float* __restrict__ costs, int K, int nb,
                      float* __restrict__ out) {
  static_assert(kBlock == 64, "two costs a lane");
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kMinWarps + (threadIdx.x >> 5);
  wait_for_prior_grid();  // the costs are the previous launch's
  if (b >= nb) return;  // the whole warp
  const int k = b * kBlock + lane;
  const float lo = k < K ? costs[k] : kMinPad;
  const float hi = k + 32 < K ? costs[k + 32] : kMinPad;
  float m = nan_min(lo, hi);  // block_min_nan's off = 32 step
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_min(m, __shfl_down_sync(kFullMask, m, off));
  if (lane == 0) out[b] = m;
}

// kernel<<<grid, block, 0, s>>>(args...) as a programmatic dependent of the
// kernel before it in s: it may be scheduled before that kernel has
// finished, and waits for it in wait_for_prior_grid. Returns the launch
// error.
template <class... Params, class... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t s,
                             Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The carry pass after a warp kernel, in this build's form: the tiled pass
// (kCarryTile columns a block) or, with -DMPPI_PASS_UNSTAGED,
// block_carry_kernel over (kBlock-sample block, kBlock-column tile). Returns
// its launch error. A template, as the kernels, so that only the sources
// that launch it build it.
template <int kBlock>
cudaError_t launch_block_carry(const float* costs, const float* X, int K, int TC, float lam_w,
                               float* carry, cudaStream_t s) {
  static_assert(kBlock == kBlockSamples, "carry rows of 64 samples");
  if constexpr (kBlockPassForm == 0) {
    const int tiles = (TC + kBlock - 1) / kBlock;
    const dim3 grid((K + kBlock - 1) / kBlock, tiles < 65535 ? tiles : 65535);
    block_carry_kernel<kBlock><<<grid, kBlock, 0, s>>>(costs, X, K, TC, lam_w, carry);
    return cudaGetLastError();
  } else {
    const int tiles = (TC + kCarryTile - 1) / kCarryTile;
    const dim3 grid((K + kBlock - 1) / kBlock, tiles < 65535 ? tiles : 65535);
    if (TC % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0) {
      return launch_dependent(block_carry_tiled_kernel<kCarryTile, true>, grid, dim3(kBlock), s,
                              costs, X, K, TC, lam_w, carry);
    }
    return launch_dependent(block_carry_tiled_kernel<kCarryTile, false>, grid, dim3(kBlock), s,
                            costs, X, K, TC, lam_w, carry);
  }
}

// The minima pass after a warp kernel (Tsallis pass 1), in this build's
// form: block_min_warp_kernel or, with -DMPPI_PASS_UNSTAGED,
// block_min_kernel. Returns its launch error.
template <int kBlock>
cudaError_t launch_block_min(const float* costs, int K, float* out, cudaStream_t s) {
  static_assert(kBlock == kBlockSamples, "minima of 64 samples");
  const int nb = (K + kBlock - 1) / kBlock;
  if constexpr (kBlockPassForm == 0) {
    block_min_kernel<kBlock><<<nb, kBlock, 0, s>>>(costs, K, out);
    return cudaGetLastError();
  } else {
    return launch_dependent(block_min_warp_kernel<kBlock>, dim3((nb + kMinWarps - 1) / kMinWarps),
                            dim3(32 * kMinWarps), s, costs, K, nb, out);
  }
}

}  // namespace

extern "C" {

// The form of the passes after the warp kernels that this build launches:
// 4 the tiled carry pass and the warp minima pass (block_carry_tiled_kernel,
// block_min_warp_kernel), 0 the earlier block_carry_kernel and
// block_min_kernel (-DMPPI_PASS_UNSTAGED).
int block_pass_form() { return kBlockPassForm; }

}  // extern "C"
