// The fused sampling + rollout kernels (B3, B4) for Hopper: the noise is drawn inside the
// kernel, so the (K, T, C) samples are made, clamped, rolled out and weighted
// in one launch.
//
// Kernel B3, fused_solve_kernel<Dyn, Cost, NOISE>, replaces the TPU kernel
// mppi_generic_tpu/ops/pallas_solve.py::_fused_solve_call (entry
// fused_solve_iteration, :480): one whole MPPI iteration for the Gaussian and
// the NLN (log-MPPI) sampler. Per sample k and step t:
//   z      = the Philox normal (philox.cuh); NLN: z * expf(aux * z2), where
//            aux is the sampler's raw std-dev and z2 the second stream
//   noise  = sigma * z,  pure = float(k) >= pure_thresh
//   u      = noise if pure else mean + noise; mean where k == 0 or t < stride
//   u      = clamp(u)  (deadband snap and shrink, then the range)
//   mu     = 0 if pure else mean
//   lr    += lrc * mu * (mu - 2 u),  lrc = coeff / sigma^2 (from the host side)
// then the dynamics step and the running cost; the LR sum is kept apart and
// added at the end, J = (acc + terminal + lr_gain * lr) / T (pallas_solve.py:
// 176-240, :349). Each thread writes its clamped U row, and each block then
// reduces its samples into one flash carry row (m_b, d_b, num_b[T*C]) over U,
// which flash_combine_kernel (flash_combine.cu) merges into the new mean,
// baseline = -lambda m and eta: the TPU kernel's per-grid-step _init/_accum
// (:355-388), done per block and merged without atomics.
//
// Kernel B4, fused_sample_rollout_kernel<Dyn, Cost, NOISE, EPILOGUE>,
// replaces mppi_generic_tpu/ops/pallas_rollout.py::_fused_sample_call (entry
// fused_sample_rollout_costs, :2457) for the Gaussian, NLN and Smooth-MPPI
// samplers, in its own operation order (:1776-1828, :1978): the LR cost of a
// step, lr_t = sum_c coeff_c mu (mu - 2 u_c) / (s_c s_c), is scaled by lr_gain
// and added to the running sum every step, J = (acc + terminal) / T. Smooth-
// MPPI carves out in derivative space: w = noise, or dm + noise, or dm where
// pinned; u = mean + w dt_smooth, then clamp; W is emitted unclamped. It
// emits costs, crash flags, U and (Smooth) W; with EPILOGUE (Smooth only,
// :1646-1650) each block reduces its samples into a carry row over W. A
// network model (HasWarpStep) runs B4's warp form instead, one warp per
// sample (sample_warp.cuh), and every other model its staged form, producer
// warps drawing each chunk of steps into shared memory for consumer threads
// (sample_staged.cuh); all take a step's controls from sample_controls
// (sample_draw.cuh). The one-thread B4 kernel below is built only with
// -DMPPI_SAMPLE_ONE_THREAD, to time the forms in one call. B3 takes the
// same forms from solve_controls: a network model's runs the warp form
// (fused_solve_warp_kernel, sample_warp.cuh, then the carry pass of
// block_pass.cuh for the carry rows), every other model's the staged form
// (fused_solve_staged_kernel, sample_staged.cuh: the stage carries each
// step's controls and C LR terms); the one-thread B3 below is built only
// with -DMPPI_SOLVE_ONE_THREAD, for every model.
//
// What bounds them on this card: operations, not bytes. Per sample-step they
// run a ten-round Philox (about 90 integer operations), the Box-Muller logf,
// sqrtf, cosf and sinf, the carve-outs, the clamp, the LR term, the step and
// the cost; they read only the (T, C) tables and write costs, the carries and
// U only where it is asked for. What bounds the simple design is latency: one
// thread per sample walks a dependent chain of T steps, and K=8192 threads in
// blocks of kBlockSamples fill the 132 SMs with two warps each. Because Philox is
// counter-based, each thread draws its own normals in the horizon loop, so
// the TPU kernel's (C, T, K) sample scratch (kept only because its PRNG is
// tile-sequential) is not needed; its time-vectorised generation pass,
// lane-replicated tables, 128-lane tiles and channel-major layout are TPU
// mechanics and are not ported.
//
// Both are templates over the (dynamics, cost) pair: each pair's source,
// csrc/pair_<name>.cu, includes this header and instantiates its C entries
// with SOLVE_ENTRY and SAMPLE_ENTRY, so that nvcc builds the pairs in
// parallel, one library each. A model's parameters are staged in shared
// memory before any sample is skipped (Dyn::stage); a cost that reads a map
// queries it through map_texture.cuh (B9). With a heavy pair (AutoRally's
// FNN, about 3,000 operations per sample-step) the arithmetic of the step
// outweighs the draw.
//
// Injected normals: with zinj set, the kernels read z (and z2) from a
// (n_z, K, T, C) tensor instead of drawing them, as the TPU kernels' test
// hook does; the controllers use it to hold the fused solve against the
// eager one on the same draw.
//
// Numerics: built without --use_fast_math and with --fmad=false; every
// operation in the order of the plain PyTorch versions (ops/fused_solve.py
// fused_solve_plain, ops/fused_rollout.py sample_rollout_plain). Only the
// carry sums are taken in another order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mppi_common.cuh"
#include "philox.cuh"
#include "sample_draw.cuh"
#include "sample_staged.cuh"
#include "sample_warp.cuh"

namespace {

template <class Dyn, class Cost, int NOISE>
__global__ void __launch_bounds__(kBlockSamples)
fused_solve_kernel(const float* __restrict__ x0, SampleArgs a, int K, int T,
                   float dt, ModelArgs m, float lr_gain, float lam_w,
                   float* __restrict__ costs, int* __restrict__ crash_out,
                   float* U, float* __restrict__ carry) {
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
    const uint32_t seed = static_cast<uint32_t>(*a.seed);
    const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
    float x[S];
    float y[O];
    float rec[R > 0 ? R : 1];  // a recurrent model's carry (LSTM h, c)
    init_rec<Dyn>(dyn_sh, rec);
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x0[i];
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = 0.0f;
    int crash = 0;
    float acc = 0.0f;
    float lr = 0.0f;
    const bool pure = static_cast<float>(k) >= a.pure_thresh;
    for (int t = 0; t < T; ++t) {
      float u[C];
      float terms[C];
      solve_controls<C, NOISE>(a, seed, k, K, T, t, pure, U, u, terms);
#pragma unroll
      for (int c = 0; c < C; ++c) lr = lr + terms[c];
      step_model<Dyn>(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
      acc = acc + Cost::running_cost(cp, y, u, t, &crash);
    }
    J = (acc + Cost::terminal_cost(cp, y) + lr_gain * lr) /
        static_cast<float>(T);
    costs[k] = J;
    crash_out[k] = crash;
  }
  write_block_carry<kBlockSamples>(J, valid, lam_w, U, K, TC, carry);
}

template <class Dyn, class Cost, int NOISE, bool EPILOGUE>
__global__ void __launch_bounds__(kBlockSamples)
fused_sample_rollout_kernel(const float* __restrict__ x0, SampleArgs a, int K,
                            int T, float dt, ModelArgs m, float lr_gain,
                            float lam_w, float* __restrict__ costs,
                            int* __restrict__ crash_out, float* U, float* W,
                            float* __restrict__ carry) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int R = RecDim<Dyn>::value;
  const int TC = T * C;
  const int k = blockIdx.x * kBlockSamples + threadIdx.x;
  const bool valid = k < K;

  __shared__ typename Dyn::Shared dyn_sh;
  stage_model<Dyn>(m, &dyn_sh);
  if (Dyn::kStaged) __syncthreads();

  float J = 0.0f;
  if (valid) {
    const uint32_t seed = static_cast<uint32_t>(*a.seed);
    const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
    float x[S];
    float y[O];
    float rec[R > 0 ? R : 1];
    init_rec<Dyn>(dyn_sh, rec);
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x0[i];
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = 0.0f;
    int crash = 0;
    float acc = 0.0f;
    const bool pure = static_cast<float>(k) >= a.pure_thresh;
    for (int t = 0; t < T; ++t) {
      float u[C];
      const float lr_t =
          sample_controls<C, NOISE>(a, seed, k, K, T, t, pure, lr_gain, U, W, u);
      step_model<Dyn>(dyn_sh, x, rec, u, static_cast<float>(t), dt, y);
      acc = acc + Cost::running_cost(cp, y, u, t, &crash) + lr_t;
    }
    J = (acc + Cost::terminal_cost(cp, y)) / static_cast<float>(T);
    costs[k] = J;
    crash_out[k] = crash;
  }
  if (EPILOGUE) write_block_carry<kBlockSamples>(J, valid, lam_w, W, K, TC, carry);
}

// The form of B3 a model's entry launches: 1 the warp form
// (fused_solve_warp_kernel and the carry pass, sample_warp.cuh) for a model
// with it (HasWarpStep, warp_model.cuh), else 2 the staged form
// (fused_solve_staged_kernel, sample_staged.cuh); with
// -DMPPI_SOLVE_ONE_THREAD, 0 the one-thread kernel for every model.
template <class Dyn>
constexpr int solve_form() {
#ifdef MPPI_SOLVE_ONE_THREAD
  return 0;
#else
  return HasWarpStep<Dyn>::value ? 1 : 2;
#endif
}

// B3 for the pair (Dyn, Cost) in the form solve_form<Dyn>() names;
// noise_kind 0 is the Gaussian sampler, 1 NLN.
template <class Dyn, class Cost>
int fused_solve_entry(int device, int noise_kind, const float* x0,
                      const SampleArgs& a, int K, int T, float dt, ModelArgs m,
                      float lr_gain, float lam_w, float* costs, int* crash,
                      float* U, float* carry, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (noise_kind != kGaussian && noise_kind != kNLN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (solve_form<Dyn>() == 2) {
    return static_cast<int>(launch_solve_staged<Dyn, Cost>(
        noise_kind, x0, a, K, T, dt, m, lr_gain, lam_w, costs, crash, U, carry, s));
  } else if constexpr (solve_form<Dyn>() == 1) {
    return static_cast<int>(launch_solve_warp<Dyn, Cost>(
        noise_kind, x0, a, K, T, dt, m, lr_gain, lam_w, costs, crash, U, carry, s));
  } else {
    const int nb = (K + kBlockSamples - 1) / kBlockSamples;
    if (noise_kind == kGaussian) {
      fused_solve_kernel<Dyn, Cost, kGaussian><<<nb, kBlockSamples, 0, s>>>(
          x0, a, K, T, dt, m, lr_gain, lam_w, costs, crash, U, carry);
    } else {
      fused_solve_kernel<Dyn, Cost, kNLN><<<nb, kBlockSamples, 0, s>>>(
          x0, a, K, T, dt, m, lr_gain, lam_w, costs, crash, U, carry);
    }
    return static_cast<int>(cudaGetLastError());
  }
}

// The form of B4 a model's entry launches: 1 the warp form, 2 the staged
// form, 0 the one-thread kernel.
template <class Dyn>
constexpr int sample_form() {
#ifdef MPPI_SAMPLE_ONE_THREAD
  return HasWarpStep<Dyn>::value ? 1 : 0;
#else
  return HasWarpStep<Dyn>::value ? 1 : 2;
#endif
}

// B4 for the pair (Dyn, Cost); noise_kind 0 Gaussian, 1 NLN, 2 Smooth-MPPI
// (aux is then the derivative mean). With epilogue != 0 (Smooth only) W and
// the carry rows over W are written. A model with the warp form
// (HasWarpStep, warp_model.cuh) runs it (sample_warp.cuh: the warp kernel,
// then the carry pass with the epilogue); every other model the staged form
// (sample_staged.cuh), or with -DMPPI_SAMPLE_ONE_THREAD the one-thread
// kernel, their epilogue inside.
template <class Dyn, class Cost>
int fused_sample_entry(int device, int noise_kind, int epilogue,
                       const float* x0, const SampleArgs& a, int K, int T,
                       float dt, ModelArgs m, float lr_gain, float lam_w,
                       float* costs, int* crash, float* U, float* W,
                       float* carry, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (noise_kind != kGaussian && noise_kind != kNLN && noise_kind != kSmooth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (epilogue && (noise_kind != kSmooth || W == nullptr || carry == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (HasWarpStep<Dyn>::value) {
    return static_cast<int>(launch_sample_warp<Dyn, Cost>(
        noise_kind, epilogue != 0, x0, a, K, T, dt, m, lr_gain, lam_w, costs, crash, U,
        W, carry, s));
  } else if constexpr (sample_form<Dyn>() != 0) {
    return static_cast<int>(launch_sample_staged<Dyn, Cost>(
        noise_kind, epilogue != 0, x0, a, K, T, dt, m, lr_gain, lam_w, costs, crash, U,
        W, carry, s));
  } else {
    const int nb = (K + kBlockSamples - 1) / kBlockSamples;
#define B4_LAUNCH(NOISE, EPI)                                              \
  fused_sample_rollout_kernel<Dyn, Cost, NOISE, EPI>                       \
      <<<nb, kBlockSamples, 0, s>>>(x0, a, K, T, dt, m, lr_gain, lam_w,    \
                                    costs, crash, U, W, carry)
    if (epilogue) {
      B4_LAUNCH(kSmooth, true);
    } else if (noise_kind == kGaussian) {
      B4_LAUNCH(kGaussian, false);
    } else if (noise_kind == kNLN) {
      B4_LAUNCH(kNLN, false);
    } else {
      B4_LAUNCH(kSmooth, false);
    }
#undef B4_LAUNCH
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// The C entry of B3 for one (dynamics, cost) pair, to be expanded inside
// extern "C"; noise_kind 0 is the Gaussian sampler, 1 NLN. Every pointer is
// memory of CUDA device `device`, `stream` one of its streams; zinj may be
// null, and dyn_params, cost_map and dyn_map for a pair that reads none.
// U (K, T, C) and carry (ceil(K / kBlockSamples), 2 + T*C) are written.
// Returns the CUDA error of the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a noise kind this kernel does not draw. Beside
// it, NAME_form() says which form it launches: 1 the warp form
// (fused_solve_warp_kernel, then the carry pass), 2 the staged form
// (fused_solve_staged_kernel), 0 the one-thread kernel (fused_solve_kernel).
#define SOLVE_ENTRY(NAME, DYN, COST)                                          \
  int NAME(int device, int noise_kind, const float* x0, const float* mean,   \
           const float* sigma, const float* aux, const float* lrc,           \
           const float* cons, const int* seed, const float* zinj, int K,     \
           int T, int stride, float pure_thresh, float dt, float lr_gain,    \
           float lam_w, const float* dyn_params, const float* cost_params,   \
           const float* cost_map, const float* dyn_map, float* costs,        \
           int* crash, float* U, float* carry, void* stream) {               \
    const SampleArgs a{mean, sigma, aux, lrc, cons, seed, zinj,              \
                       stride, pure_thresh, 0.0f};                            \
    return fused_solve_entry<DYN, COST>(                                     \
        device, noise_kind, x0, a, K, T, dt,                                 \
        ModelArgs{dyn_params, cost_params, cost_map, dyn_map}, lr_gain,      \
        lam_w, costs, crash, U, carry, stream);                              \
  }                                                                          \
  int NAME##_form() { return solve_form<DYN>(); }

// The C entry of B4 for one (dynamics, cost) pair, to be expanded inside
// extern "C"; noise_kind 0 Gaussian, 1 NLN, 2 Smooth-MPPI (aux is then the
// derivative mean). U and W may be null (not emitted); with epilogue != 0
// (Smooth only) W must be given and the carry rows over W are written.
// Returns the CUDA error of the launch, or cudaErrorInvalidValue for a mode
// this kernel does not have. Beside it, NAME_form() says which form it
// launches: 1 the warp form (fused_sample_rollout_warp_kernel, and with the
// epilogue the carry pass), 2 the staged form
// (fused_sample_rollout_staged_kernel), 0 the one-thread kernel
// (fused_sample_rollout_kernel).
#define SAMPLE_ENTRY(NAME, DYN, COST)                                         \
  int NAME(int device, int noise_kind, int epilogue, const float* x0,        \
           const float* mean, const float* sigma, const float* aux,          \
           const float* coeff, const float* cons, const int* seed,           \
           const float* zinj, int K, int T, int stride, float pure_thresh,   \
           float dt_smooth, float dt, float lr_gain, float lam_w,            \
           const float* dyn_params, const float* cost_params,                \
           const float* cost_map, const float* dyn_map, float* costs,        \
           int* crash, float* U, float* W, float* carry, void* stream) {     \
    const SampleArgs a{mean, sigma, aux, coeff, cons, seed, zinj,            \
                       stride, pure_thresh, dt_smooth};                       \
    return fused_sample_entry<DYN, COST>(                                    \
        device, noise_kind, epilogue, x0, a, K, T, dt,                       \
        ModelArgs{dyn_params, cost_params, cost_map, dyn_map}, lr_gain,      \
        lam_w, costs, crash, U, W, carry, stream);                           \
  }                                                                          \
  int NAME##_form() { return sample_form<DYN>(); }
