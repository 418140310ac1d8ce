// The lane-group form of B1's split dynamics pass (split_kernels.cuh) for the
// analytic models whose step is long: a group of G lanes per sample.
//
// Replaces, for a model that declares kLaneGroup (the bicycle slip,
// bicycle_slip.cuh), the one-thread split_dynamics_kernel: the dynamics pass
// of the split mode of the TPU kernel
// mppi_generic_tpu/ops/pallas_rollout.py::_fused_call (run_tile, :663-696).
// One thread per sample ran the bicycle's step as one chain of four tanhf, a
// tanf, two sinf and two cosf, fmodf and four correctly rounded divisions on
// 30 blocks of 64 threads at K = 1920: 60 warps on 132 SMs, each step about
// 0.85 us of dependent latency.
//
// split_dynamics_lanes_kernel<Dyn, X0>: blocks of kLaneSamples samples, 32 /
// G samples a warp (G = Dyn::kLaneGroup: 8 for the bicycle), the G lanes of
// a group holding the same state and running the model's step_lanes: where
// the step evaluates one function
// on independent operands (the tanh terms, the two pairs of divisions, sinf
// and cosf of the wheel angle and of the yaw), each lane of the group takes
// one operand set and shuffles hand the results round, so the group walks a
// chain of seven such evaluations a step where the thread walked fourteen.
// The warp reads each chunk of kChunk steps of its samples' controls (a
// sample's 32 C floats contiguous in U, a lane's share prefetched a chunk
// ahead) into shared memory, from which the lanes read a step's controls at
// one address a group. Each step the lane of the group whose index is o mod
// G stages output o, all of its outputs in one vector store, and after the
// chunk the block writes them to Y[t, o, k] in rows of its samples, four
// neighbours a 16-byte store (a store a step from each lane was measured
// slower: PERF.md section 6).
//
// What bounds it on this card: bytes (Y written and U read once, 9.2 MB at
// K = 1920, T = 100: 0.0027 ms); what bounds the form is the step's chain of
// dependent evaluations, which every sample walks T times.
//
// -DMPPI_SPLIT_ONE_THREAD builds the one-thread pass instead, as for the
// warp form (split_warp.cuh).
//
// Numerics: the step's values bit for bit (step_lanes), so Y equals the
// one-thread pass's and split_outputs_plain's. A group past K steps a zero
// state (every lane takes part in every shuffle) and writes nothing.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "mppi_common.cuh"
#include "sample_staged.cuh"

namespace {

// A model with the lane-group form declares kLaneGroup, the lanes a sample
// (a multiple of 4 that divides 32), and has step_lanes(sh, x, u, t, dt, y).
template <class D, class = void>
struct HasLaneStep : std::false_type {};
template <class D>
struct HasLaneStep<D, std::void_t<decltype(D::kLaneGroup)>> : std::true_type {};

#ifdef MPPI_SPLIT_ONE_THREAD
template <class D>
constexpr bool kSplitLanes = false;
#else
template <class D>
constexpr bool kSplitLanes = HasLaneStep<D>::value;
#endif

constexpr int kLaneSamples = 16;  // samples a block

template <class Dyn, bool X0>
__global__ void __launch_bounds__(kLaneSamples * Dyn::kLaneGroup)
split_dynamics_lanes_kernel(const float* __restrict__ x0, const float* __restrict__ U,
                            int K, int T, float dt, ModelArgs m,
                            float* __restrict__ Y) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  constexpr int G = Dyn::kLaneGroup;
  constexpr int NW = 32 / G;           // samples a warp
  constexpr int kRow = kChunk * C;     // a sample's controls of a chunk
  constexpr int kPer = NW * kRow / 32;  // the floats of them a lane fetches
  // a lane's outputs o = l, l + G, ... of a step, padded to one vector store
  constexpr int kOuts = (O + G - 1) / G;
  constexpr int kSlots = kOuts <= 1 ? 1 : kOuts <= 2 ? 2 : 4;
  static_assert(kOuts <= 4, "a lane stages at most four outputs a step");
  using Slots = typename std::conditional<
      kSlots == 4, float4, typename std::conditional<kSlots == 2, float2, float>::type>::type;
  const int lane = threadIdx.x & 31;
  const int g = lane / G;
  const int l = lane % G;
  const int w = threadIdx.x >> 5;
  const int wbase = blockIdx.x * kLaneSamples + w * NW;  // the warp's first sample
  const int k = wbase + g;

  __shared__ typename Dyn::Shared dyn_sh;
  __shared__ float u_s[kLaneSamples][kRow + 1];  // the pad parts the samples' banks
  // the warp's outputs of a chunk: step j, lane (g, l)'s slots
  __shared__ Slots y_s[kLaneSamples * G / 32][kChunk][32];
  stage_model<Dyn>(m, &dyn_sh);
  __syncthreads();
  const bool valid = k < K;
  float(*uw)[kRow + 1] = u_s + w * NW;

  float x[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    x[i] = !valid ? 0.0f : X0 ? x0[static_cast<size_t>(k) * S + i] : x0[i];
  }
  // the lane's floats q * 32 + lane of the warp's chunk rows: 32 contiguous
  // floats of one sample an instruction
  float pre[kPer];
  auto fetch = [&](int ch) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int f = q * 32 + lane;
      const int kk = wbase + f / kRow;
      const int idx = ch * kRow + f % kRow;
      pre[q] = kk < K && idx < T * C ? U[static_cast<size_t>(kk) * T * C + idx] : 0.0f;
    }
  };
  fetch(0);
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int bbase = blockIdx.x * kLaneSamples;
  // Y's rows take 16-byte stores where K keeps them aligned and the block
  // is full
  const bool vec = K % 4 == 0 && bbase + kLaneSamples <= K;
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();  // the block has read the chunk before and its outputs
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int f = q * 32 + lane;
      uw[f / kRow][f % kRow] = pre[q];
    }
    __syncwarp();
    if (ch + 1 < n_chunks) fetch(ch + 1);
    const int t0 = ch * kChunk;
    const int n = min(kChunk, T - t0);
    for (int j = 0; j < n; ++j) {
      const int t = t0 + j;
      float u[C];
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = uw[g][j * C + c];
      float y[O];
      Dyn::step_lanes(dyn_sh, x, u, static_cast<float>(t), dt, y);
      // the lane's outputs into one vector store
      float v[kSlots];
#pragma unroll
      for (int e = 0; e < kSlots; ++e) {
        float ye = 0.0f;
#pragma unroll
        for (int o = e * G; o < (e + 1) * G && o < O; ++o) ye = o % G == l ? y[o] : ye;
        v[e] = ye;
      }
      if constexpr (kSlots == 4) {
        y_s[w][j][lane] = make_float4(v[0], v[1], v[2], v[3]);
      } else if constexpr (kSlots == 2) {
        y_s[w][j][lane] = make_float2(v[0], v[1]);
      } else {
        y_s[w][j][lane] = v[0];
      }
    }
    // the chunk's outputs to Y in rows of the block's samples: four
    // neighbouring samples of one (step, output) a thread
    __syncthreads();
    for (int f = threadIdx.x; f < n * O * (kLaneSamples / 4); f += kLaneSamples * G) {
      const int j = f / (O * kLaneSamples / 4);
      const int o = (f / (kLaneSamples / 4)) % O;
      const int s0 = 4 * (f % (kLaneSamples / 4));
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sb = s0 + e;  // the sample of the block: warp sb / NW, group sb % NW
        v[e] = reinterpret_cast<const float*>(&y_s[sb / NW][j][(sb % NW) * G + o % G])[o / G];
      }
      float* row = Y + (static_cast<size_t>(t0 + j) * O + o) * K + bbase + s0;
      if (vec) {
        *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (bbase + s0 + e < K) row[e] = v[e];
        }
      }
    }
  }
}

}  // namespace
