// RMPPI augmented rollout (nominal + real system with DDP feedback, B8) for
// Hopper, as a template over the (dynamics, cost) pair. rmppi_rollout.cu
// instantiates the entries: the double integrator's (circle and robust
// costs) and AutoRally's.
//
// Replaces the TPU kernel mppi_generic_tpu/ops/pallas_rollout.py::
// _fused_rmppi_call (entry fused_rmppi_rollout, :2352-2454), the
// reference's rolloutRMPPIDynamicsKernel + rolloutRMPPICostKernel
// (core/rmppi_kernels.cu:359-665). The plain PyTorch version is
// rmppi_rollout_plain in mppi_generic_tpu_torch/ops/fused_rollout.py; its
// wrapper fused_rmppi_rollout launches this kernel through the C entries
// (RMPPI_ENTRY).
//
// rmppi_rollout_kernel<Dyn, Cost>: one thread per sample, the T-step loop
// inside the thread, both states in registers. A network model runs the
// warp form of rmppi_warp.cuh, the others the staged form of
// rmppi_staged.cuh, which takes any cost but a StickyCrash one and models
// whose two stages fit the shared memory (rmppi_form); the bicycle (the
// AutoRally cost's sticky crash) and the quadrotor (its stages past 227 KB)
// launch this kernel, and -DMPPI_RMPPI_ONE_THREAD builds it for every model
// without the warp form, to time the forms against each other. Every thread
// first stages the model's parameters into shared memory (Dyn::Shared,
// stage_model in mppi_common.cuh, before any sample past K returns), and
// both systems step on the same staged copy. Per step, from the raw sample u_raw:
//   u_nom  = clamp(u_raw)
//   u_fb   = K[t] (x_real - x_nom)
//   u_real = clamp(u_raw + u_fb), written out as U_real (K, T, C)
//   fb     = 0.5 lambda (1 - alpha) sum_c coeff_c u_fb_c^2 / sigma_tc^2
// then both systems step and take their running costs, each with its own
// sticky crash counter. Outputs per sample s_nom = (sum c_nom + term_nom) / T,
// j_real = (sum c_real + term_real) / T, s_fb = (sum (c_real + fb) +
// term_real) / T and the real system's crash flag (the nominal one is not an
// output, as in the TPU kernel). "clamp" is the dynamics' enforceConstraints
// (_clamp_channel, pallas_rollout.py:481-488): deadband snap and shrink, then
// the range. The cost reads its parameters and its map (Cost::load), so the
// AutoRally costs query their track map here as in B1.
//
// What bounds it on this card: for the double integrator, bytes, not
// operations. At K=2560, T=50, C=2 it reads U (1.02 MB) and writes U_real
// (1.02 MB), about 0.6 us at 3.35 TB/s; the arithmetic (about 150 operations
// per sample-step) is about 0.3 us at 67 TFLOP/s. For AutoRally, operations:
// two network steps and two map costs per sample-step (about 6,800
// operations), 3.6 us at K=1920, T=150. What bounds the simple design is
// latency: each thread walks a dependent chain of T steps, and K samples in
// blocks of 64 are 30-40 blocks, which leave most of the 132 SMs idle. The
// gain and sigma tables (T*C*(S+1) floats) are read by every thread at the
// same address, which L1 broadcasts. A recurrent model's carry is not
// ported here (static_assert).
//
// The TPU kernel's SMEM/VMEM/streamed table modes, its sublane-stacked
// gain tables, its 128-lane tiles and its channel-major U are TPU mechanics
// and are not ported: U and U_real stay the public (K, T, C) tensors.
//
// Numerics: built without --use_fast_math and with --fmad=false; every
// operation in the order of the plain version, so the outputs agree with it
// bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mppi_common.cuh"
#include "rmppi_staged.cuh"
#include "rmppi_warp.cuh"
#include "warp_model.cuh"

namespace {

// The feedback tables are kernel parameters of their own, __restrict__: a
// struct of pointers would lose the qualifier, and with it the read-only
// loads of the tables that every thread reads at the same address.
template <class Dyn, class Cost>
__global__ void __launch_bounds__(kBlockSamples)
rmppi_rollout_kernel(const float* __restrict__ x0_nom,
                     const float* __restrict__ x0_real,
                     const float* __restrict__ U, int K, int T, float dt,
                     ModelArgs m, const float* __restrict__ cons,
                     const float* __restrict__ gains,
                     const float* __restrict__ sigma,
                     const float* __restrict__ coeff, float fb_gain,
                     float* __restrict__ s_nom_out,
                     float* __restrict__ j_real_out,
                     float* __restrict__ s_fb_out, int* __restrict__ crash_out,
                     float* __restrict__ U_real) {
  static_assert(RecDim<Dyn>::value == 0, "B8's recurrent carry is not ported");
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  const int k = blockIdx.x * kBlockSamples + threadIdx.x;

  // the model's parameters, staged by every thread before any returns
  __shared__ typename Dyn::Shared dyn_sh;
  stage_model<Dyn>(m, &dyn_sh);
  if (Dyn::kStaged) __syncthreads();
  if (k >= K) return;

  const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
  float x_nom[S], x_real[S], y_nom[O], y_real[O];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    x_nom[i] = x0_nom[i];
    x_real[i] = x0_real[i];
  }
#pragma unroll
  for (int i = 0; i < O; ++i) {
    y_nom[i] = 0.0f;
    y_real[i] = 0.0f;
  }
  int crash_n = 0;
  int crash_r = 0;
  float s_nom = 0.0f;
  float j_real = 0.0f;
  float s_fb = 0.0f;
  const size_t row = static_cast<size_t>(k) * T * C;
  for (int t = 0; t < T; ++t) {
    float u_raw[C], u_nom[C], u_real[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      u_raw[c] = U[row + t * C + c];
      u_nom[c] = clamp_channel(u_raw[c], cons, C, c);
    }
    float dx[S];
#pragma unroll
    for (int s = 0; s < S; ++s) dx[s] = x_real[s] - x_nom[s];
    float fb = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* g = gains + (t * C + c) * S;
      float u_fb = g[0] * dx[0];
#pragma unroll
      for (int s = 1; s < S; ++s) u_fb = u_fb + g[s] * dx[s];
      const float sg = sigma[t * C + c];
      fb = fb + coeff[c] * u_fb * u_fb / (sg * sg);
      u_real[c] = clamp_channel(u_raw[c] + u_fb, cons, C, c);
      U_real[row + t * C + c] = u_real[c];
    }
    fb = fb_gain * fb;
    Dyn::step(dyn_sh, x_nom, u_nom, static_cast<float>(t), dt, y_nom);
    Dyn::step(dyn_sh, x_real, u_real, static_cast<float>(t), dt, y_real);
    const float c_nom = Cost::running_cost(cp, y_nom, u_nom, t, &crash_n);
    const float c_real = Cost::running_cost(cp, y_real, u_real, t, &crash_r);
    s_nom = s_nom + c_nom;
    j_real = j_real + c_real;
    s_fb = s_fb + c_real + fb;
  }
  const float term_n = Cost::terminal_cost(cp, y_nom);
  const float term_r = Cost::terminal_cost(cp, y_real);
  const float Tf = static_cast<float>(T);
  s_nom_out[k] = (s_nom + term_n) / Tf;
  j_real_out[k] = (j_real + term_r) / Tf;
  s_fb_out[k] = (s_fb + term_r) / Tf;
  crash_out[k] = crash_r;
}

// B8's form for the models without the warp form whose cost is not
// StickyCrash (mppi_common.cuh): the staged form (rmppi_staged.cuh), or the
// one-thread kernel above in a build with
// MPPI_RMPPI_ONE_THREAD defined (chip_smoke.py builds rmppi_rollout.cu so to
// time the two forms against each other; the port never loads such a build).
#ifdef MPPI_RMPPI_ONE_THREAD
constexpr int kRmppiForm = 0;
#else
constexpr int kRmppiForm = 2;
#endif

// Whether the staged form's two stages (RmppiStage: a record a step and
// sample of both states and both controls) fit the 227 KB of shared memory
// a block of this card may opt in to. The quadrotor's 13 states and 4
// controls take 321 KB: its B8 runs the one-thread kernel.
template <class Dyn>
constexpr bool rmppi_stages_fit() {
  return 2 * sizeof(float) * RmppiStage<kRmppiSamples, Dyn::S, Dyn::C>::kFloats <=
         227 * 1024;
}

// The form the pair's entry launches: 1 the warp form, 2 the staged form,
// 0 the one-thread kernel (a StickyCrash cost, or stages too large).
template <class Dyn, class Cost>
constexpr int rmppi_form() {
  return HasWarpStep<Dyn>::value                                ? 1
         : StickyCrash<Cost>::value || !rmppi_stages_fit<Dyn>() ? 0
                                                                 : kRmppiForm;
}

// B8 for the pair (Dyn, Cost): the warp form (rmppi_warp.cuh) for a model
// that has it (HasWarpStep, warp_model.cuh), else the staged form or the
// one-thread kernel (rmppi_form).
template <class Dyn, class Cost>
int rmppi_entry(int device, const float* x0_nom, const float* x0_real,
                const float* U, int K, int T, float dt, ModelArgs m,
                const float* cons, const float* gains, const float* sigma,
                const float* coeff, float fb_gain, float* s_nom, float* j_real,
                float* s_fb, int* crash, float* U_real, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (HasWarpStep<Dyn>::value) {
    constexpr int NW = Dyn::kWarpSamples;
    rmppi_rollout_warp_kernel<Dyn, Cost><<<(K + NW - 1) / NW, 32 * NW, 0, s>>>(
        x0_nom, x0_real, U, K, T, dt, m, cons, gains, sigma, coeff, fb_gain, s_nom,
        j_real, s_fb, crash, U_real);
  } else if constexpr (rmppi_form<Dyn, Cost>() == 2) {
    return static_cast<int>(launch_rmppi_staged<Dyn, Cost>(
        K, s, x0_nom, x0_real, U, K, T, dt, m, cons, gains, sigma, coeff, fb_gain,
        s_nom, j_real, s_fb, crash, U_real));
  } else {
    const int nb = (K + kBlockSamples - 1) / kBlockSamples;
    rmppi_rollout_kernel<Dyn, Cost><<<nb, kBlockSamples, 0, s>>>(
        x0_nom, x0_real, U, K, T, dt, m, cons, gains, sigma, coeff, fb_gain, s_nom,
        j_real, s_fb, crash, U_real);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry of the RMPPI kernel for one (dynamics, cost) pair, to be
// expanded inside extern "C". Every pointer is memory of CUDA device
// `device`, and `stream` one of its streams; dyn_params and cost_map may be
// null for a pair that reads none, dyn_map is null for every pair of this
// kernel. cons is the (4, C) table [lower; upper; deadband; zero control];
// gains (T, C, S); sigma (T, C); coeff (C,); fb_gain = 0.5 lambda
// (1 - alpha). Returns the CUDA error of the launch (0 when it was accepted).
// Beside it, NAME_form() says which form it launches: 1 the warp form
// (rmppi_rollout_warp_kernel), 2 the staged form
// (rmppi_rollout_staged_kernel), 0 the one-thread kernel.
#define RMPPI_ENTRY(NAME, DYN, COST)                                          \
  int NAME(int device, const float* x0_nom, const float* x0_real,            \
           const float* U, int K, int T, float dt, const float* dyn_params,  \
           const float* cost_params, const float* cost_map,                  \
           const float* dyn_map, const float* cons, const float* gains,      \
           const float* sigma, const float* coeff, float fb_gain,            \
           float* s_nom, float* j_real, float* s_fb, int* crash,             \
           float* U_real, void* stream) {                                    \
    return rmppi_entry<DYN, COST>(                                           \
        device, x0_nom, x0_real, U, K, T, dt,                                \
        ModelArgs{dyn_params, cost_params, cost_map, dyn_map}, cons, gains,  \
        sigma, coeff, fb_gain, s_nom, j_real, s_fb, crash, U_real, stream);  \
  }                                                                          \
  int NAME##_form() { return rmppi_form<DYN, COST>(); }
