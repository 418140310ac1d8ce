// The staged form of the split form's two dynamics passes for the models
// without a network step: the producer ring of the staged fused kernels
// (staged_ring, sample_staged.cuh), with a consumer that stores each step's
// outputs instead of adding up its cost.
//
// Replaces, for every model without the warp form (the double integrator,
// the cartpole, the quadrotor, Dubins; the bicycle in B3's pass, whose B1
// pass takes the lane-group form, split_lanes.cuh), the one-thread passes of
// split_kernels.cuh, the dynamics-only loops of the split mode of the TPU
// kernels mppi_generic_tpu/ops/pallas_rollout.py::_fused_call (run_tile,
// :663-696) and mppi_generic_tpu/ops/pallas_solve.py::_fused_solve_call
// (:274-290). There each of a block's 64 threads made its own step's
// inputs inside its chain of T steps: B3's ten-round Philox, the
// Box-Muller logf, sqrtf, cosf and sinf, the carve-outs, the clamp and a
// store of its U row, T C floats from its neighbour's (32 sectors a warp's
// store); B1's read of its own U row, as far from its neighbour's.
//
// split_solve_dynamics_staged_kernel<Dyn, NOISE> (B3's pass): the producers
// run SolvePolicy (sample_staged.cuh) unchanged: lane j draws, carves out
// and clamps step t0 + j of a sample (solve_controls, sample_draw.cuh), so a
// warp's U stores are contiguous, and stages the controls and the C LR
// terms lrc mu (mu - 2 u), 2 C rows a step. Each consumer steps, writes
// Y[(t O + o) K + k] (its 64 neighbours write the 64 neighbouring floats)
// and adds the LR terms one by one into its sum in (t, c) order, the
// one-thread pass's order; then lr_out[k]. No cost, no epilogue.
//
// split_dynamics_staged_kernel<Dyn, X0> (B1's pass): the producers run
// RolloutPolicy without LR (rollout_kernel.cuh; by cp.async where the pair's
// staged B1 copies, RolloutCopies), lane j's C floats of step t0 + j; the
// consumers step and write Y. With X0 consumer k starts from row k of a
// (K, S) x0 (RMPPI's candidate nominal states).
//
// What bounds it on this card: B3's pass is bound by operations (the draw
// and the step; the bytes of U and Y take a few microseconds at 8192 x
// 100), B1's by bytes for the double integrator and Dubins and by the
// consumers' chain for the cartpole and the quadrotor. The design takes the
// state-free work and the scattered U traffic off the chain of states: the
// chain is the step alone, and every global access of a warp is a
// contiguous run.
//
// Numerics: every value is made once, by the same operations as in the
// one-thread pass; the step is the combined kernels' device function. So Y,
// U and the LR sums are the one-thread pass's floats and those of the plain
// versions (split_outputs_plain, fused_solve_split_plain's samples).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "mppi_common.cuh"
#include "rollout_kernel.cuh"
#include "sample_draw.cuh"
#include "sample_staged.cuh"
#include "warp_model.cuh"

namespace {

// The split passes take the staged form for every model without the warp
// form (B1's pass: also without the lane-group form, which the entries
// pick first). A build with MPPI_SPLIT_ONE_THREAD defined gives every model
// the one-thread passes (chip_smoke.py times the forms so); the port never
// loads such a build.
#ifdef MPPI_SPLIT_ONE_THREAD
template <class D>
constexpr bool kSplitStaged = false;
#else
template <class D>
constexpr bool kSplitStaged = !HasWarpStep<D>::value;
#endif

// The consumer's action in the split dynamics passes: the step's outputs to
// Y[t, :, k]; with LR_TERMS (B3) the C LR terms of the step's rows C ..
// 2 C - 1 added one by one into the sample's sum, lr_out[k] at the end.
template <int O, int C, bool LR_TERMS>
struct OutputSink {
  struct Args {
    float* Y;
    float* lr_out;
    int K;
  };
  Args a;
  float lr = 0.0f;

  __device__ OutputSink(const Args& args, const ModelArgs& /*m*/) : a(args) {}
  __device__ void step(int t, int k, const float* y, const float* v) {
#pragma unroll
    for (int o = 0; o < O; ++o) a.Y[(static_cast<size_t>(t) * O + o) * a.K + k] = y[o];
    if constexpr (LR_TERMS) {
#pragma unroll
      for (int c = 0; c < C; ++c) lr = lr + v[C + c];
    }
  }
  template <class P>
  __device__ float finish(const P& /*p*/, int k, int /*T*/, const float* /*y*/) {
    if constexpr (LR_TERMS) a.lr_out[k] = lr;
    return 0.0f;
  }
};

template <class Dyn, bool X0>
__global__ void __launch_bounds__(kStagedThreads, 1)
split_dynamics_staged_kernel(const float* __restrict__ x0, const float* __restrict__ U, int K,
                             int T, float dt, ModelArgs m, float* __restrict__ Y) {
  bool valid;
  staged_ring<Dyn, OutputSink<Dyn::O, Dyn::C, false>>(
      RolloutPolicy<Dyn::C, false, X0, RolloutCopies<Dyn>::value>{U, LRArgs{}}, {Y, nullptr, K},
      x0, K, T, dt, m, &valid);
}

template <class Dyn, int NOISE>
__global__ void __launch_bounds__(kStagedThreads, 1)
split_solve_dynamics_staged_kernel(const float* __restrict__ x0, SampleArgs a, int K, int T,
                                   float dt, ModelArgs m, float* U, float* __restrict__ Y,
                                   float* __restrict__ lr_out) {
  bool valid;
  staged_ring<Dyn, OutputSink<Dyn::O, Dyn::C, true>>(SolvePolicy<Dyn::C, NOISE>{a, 0.0f, U},
                                                     {Y, lr_out, K}, x0, K, T, dt, m, &valid);
}

// B1's staged split pass for the model Dyn: Y (T, O, K) from U. Returns the
// launch error.
template <class Dyn, bool X0>
cudaError_t launch_split_dynamics_staged(const float* x0, const float* U, int K, int T,
                                         float dt, ModelArgs m, float* Y, cudaStream_t s) {
  return launch_staged<Dyn, Dyn::C>(split_dynamics_staged_kernel<Dyn, X0>, K, s, x0, U, K, T,
                                    dt, m, Y);
}

// B3's staged split pass for the model Dyn, noise_kind 0 Gaussian or 1 NLN
// (already checked): U, Y and the LR sums. Returns the launch error.
template <class Dyn>
cudaError_t launch_split_solve_dynamics_staged(int noise_kind, const float* x0,
                                               const SampleArgs& a, int K, int T, float dt,
                                               ModelArgs m, float* U, float* Y, float* lr_out,
                                               cudaStream_t s) {
  constexpr int kRows = 2 * Dyn::C;
  if (noise_kind == kGaussian) {
    return launch_staged<Dyn, kRows>(split_solve_dynamics_staged_kernel<Dyn, kGaussian>, K, s,
                                     x0, a, K, T, dt, m, U, Y, lr_out);
  }
  return launch_staged<Dyn, kRows>(split_solve_dynamics_staged_kernel<Dyn, kNLN>, K, s, x0, a,
                                   K, T, dt, m, U, Y, lr_out);
}

}  // namespace
