// Device helpers shared by the MPPI kernels: the model arguments, the
// constraint clamp, asynchronous copies to shared memory, block reductions,
// the per-block flash (online-softmax) carry row and the per-block minimum of
// the Tsallis epilogue.
#pragma once

#include <math.h>
#include <stddef.h>

#include <type_traits>

// samples (threads) per block of the rollout and sampling kernels: one
// epilogue row per block of this many (BLOCK in ops/fused_rollout.py)
constexpr int kBlockSamples = 64;
constexpr float kMasked = -1e30f;  // s of a sample past K: adds nothing
// J of a sample past K in the Tsallis minimum (the TPU kernel's 1e30)
constexpr float kMinPad = static_cast<float>(1e30);

// What a (dynamics, cost) pair reads besides the samples: the dynamics'
// parameter table (staged into shared memory by Dyn::stage; null for a model
// without one), the cost's packed parameters, the cost's map data (null for
// a cost without one) and the dynamics' map data (the racer models'
// elevation map; null for every other model).
struct ModelArgs {
  const float* dyn_params;
  const float* cost_params;
  const float* cost_map;
  const float* dyn_map;
};

// The model interface of the rollout and sampling kernels. Every Dyn has S,
// C, O, kStaged, Shared, stage(params, sh) and step(sh, x, u, t, dt, y). A
// recurrent model (an LSTM in the step, B10) also has R, the floats of its
// per-thread carry (each LSTM's h and c), init_rec(sh, rec), which fills the
// carry from the staged warm state before the horizon loop, and the step
// step(sh, x, rec, u, t, dt, y); a model that reads a map of its own has
// kDynMap and stage(params, dyn_map, sh). The traits below pick the form, so
// the stateless models' code is what it was.
template <class D, class = void>
struct RecDim {
  static constexpr int value = 0;
};
template <class D>
struct RecDim<D, std::void_t<decltype(D::R)>> {
  static constexpr int value = D::R;
};

template <class D, class = void>
struct ReadsDynMap : std::false_type {};
template <class D>
struct ReadsDynMap<D, std::void_t<decltype(D::kDynMap)>> : std::true_type {};

// A cost whose crash flag is sticky-prefix (its value depends on the flag
// only through the current step's flag) declares kStickyCrash = true. Every
// other cost's value ignores the flag, so its steps may be taken apart from
// each other (the split cost pass, split_kernels.cuh; B8's staged form,
// rmppi_staged.cuh).
template <class Cost, class = void>
struct StickyCrash : std::false_type {};
template <class Cost>
struct StickyCrash<Cost, std::void_t<decltype(Cost::kStickyCrash)>>
    : std::integral_constant<bool, Cost::kStickyCrash> {};

template <class Dyn>
__device__ inline void stage_model(const ModelArgs& m, typename Dyn::Shared* sh) {
  if constexpr (ReadsDynMap<Dyn>::value) {
    Dyn::stage(m.dyn_params, m.dyn_map, sh);
  } else {
    Dyn::stage(m.dyn_params, sh);
  }
}

template <class Dyn>
__device__ inline void init_rec(const typename Dyn::Shared& sh, float* rec) {
  if constexpr (RecDim<Dyn>::value > 0) Dyn::init_rec(sh, rec);
}

template <class Dyn>
__device__ inline void step_model(const typename Dyn::Shared& sh, float* x,
                                  float* rec, const float* u, float t, float dt,
                                  float* y) {
  if constexpr (RecDim<Dyn>::value > 0) {
    Dyn::step(sh, x, rec, u, t, dt, y);
  } else {
    Dyn::step(sh, x, u, t, dt, y);
  }
}

// enforceConstraints for one channel (dynamics.cuh:250-264, the TPU kernels'
// _clamp_channel, pallas_rollout.py:481-488): deadband snap and shrink, then
// clamp. cons is the (4, C) table [lo; hi; deadband; zero control].
__device__ inline float clamp_channel(float u, const float* cons, int C,
                                      int c) {
  const float lo = cons[c];
  const float hi = cons[C + c];
  const float db = cons[2 * C + c];
  const float zc = cons[3 * C + c];
  const float shrunk = u - db * (u < 0.0f ? -1.0f : 1.0f);
  const float v = fabsf(u) < db ? zc : shrunk;
  return fminf(fmaxf(v, lo), hi);
}

// An asynchronous copy of one float from device to shared memory
// (cp.async: the data goes to shared memory without a register, so no
// later barrier waits for it), the commit of this thread's copies as a
// group, and the wait until at most N of its groups are in flight.
__device__ inline void cp_async_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The same for 16 bytes (four floats; both addresses on 16 bytes), cached in
// L2 only.
__device__ inline void cp_async_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ inline float block_max(float v, float* red) {
  const int tid = threadIdx.x;
  if (tid < N) red[tid] = v;
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

// min(a, b) that returns NaN when either is NaN, as jnp.min and torch.amin
// do (fminf would drop the NaN)
__device__ inline float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

template <int N>
__device__ inline float block_min_nan(float v, float* red) {
  const int tid = threadIdx.x;
  if (tid < N) red[tid] = v;
  __syncthreads();
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] = nan_min(red[tid], red[tid + off]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

template <int N>
__device__ inline float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  if (tid < N) red[tid] = v;
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

// The carry row (m_b, d_b, num_b[TC]) of this block of kBlock samples, the
// TPU kernels' _init/_accum math done per block:
//   s_k = -J_k / lam_w (kMasked past K), m_b = max s_k,
//   d_b = sum exp(s_k - m_b), num_b = sum exp(s_k - m_b) X_k
// X is the (K, TC) row-major tensor the weighted sum runs over (U, or
// Smooth-MPPI's W). Rows this block wrote in the same launch are read after
// the block's barriers, so X must not be read through the read-only cache:
// callers that write X pass a pointer without __restrict__. Threads map to
// the TC outputs, so the reads are coalesced. A block may write only the
// column tiles tile, tile + n_tiles, ... of blockDim.x outputs (m_b and d_b
// with tile 0): each output is the same sum in the same order either way.
// Every thread of the block calls it; threads kBlock and up (B4's producer
// warps, sample_staged.cuh) hold no sample and only share the columns.
template <int kBlock>
__device__ inline void write_block_carry(float J, bool valid, float lam_w,
                                         const float* X, int K, int TC,
                                         float* carry, int tile = 0, int n_tiles = 1) {
  __shared__ float red[kBlock];
  __shared__ float w_s[kBlock];
  const float s = valid ? (-J) / lam_w : kMasked;
  const float m_b = block_max<kBlock>(s, red);
  const float w = expf(s - m_b);  // exactly 0 for the masked tail
  if (threadIdx.x < kBlock) w_s[threadIdx.x] = w;
  const float d_b = block_sum<kBlock>(w, red);  // syncs: w_s is visible
  const int base = blockIdx.x * kBlock;
  const int n_valid = min(kBlock, K - base);
  const float* Xb = X + static_cast<size_t>(base) * TC;
  float* row = carry + static_cast<size_t>(blockIdx.x) * (2 + TC);
  const int nt = blockDim.x;
  for (int j = tile * nt + threadIdx.x; j < TC; j += n_tiles * nt) {
    float a = 0.0f;
    for (int i = 0; i < n_valid; ++i) {
      a = a + w_s[i] * Xb[static_cast<size_t>(i) * TC + j];
    }
    row[2 + j] = a;
  }
  if (tile == 0 && threadIdx.x == 0) {
    row[0] = m_b;
    row[1] = d_b;
  }
}

// Pass 1 of the Tsallis epilogue: out[blockIdx.x] = the minimum of this
// block's valid costs (kMinPad past K; NaN if one is NaN), the TPU kernel's
// min(where(valid, J, 1e30)) per block.
template <int kBlock>
__device__ inline void write_block_min(float J, bool valid, float* out) {
  __shared__ float red[kBlock];
  const float m = block_min_nan<kBlock>(valid ? J : kMinPad, red);
  if (threadIdx.x == 0) out[blockIdx.x] = m;
}
