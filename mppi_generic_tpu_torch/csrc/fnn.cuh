// The in-kernel FNN step (B10): a fully-connected network with tanh hidden
// layers, evaluated per thread from weights staged in shared memory.
//
// Replaces the TPU kernels' use of mppi_generic_tpu/nn/fnn.py::forward_axis0
// (:80) inside _fused_call and _fused_solve_call, where each layer is one MXU
// matmul over a 128-lane sample tile. Here each thread runs its own sample:
// every output unit sums its inputs left to right, then adds the bias, then
// applies tanhf (not on the last layer). The plain PyTorch version with the
// same order is FNN.forward_axis0_plain (nn/fnn.py); a matmul would sum in
// another order.
//
// The parameters are one packed float table, W1 (N1 x N0 row-major), b1, W2,
// b2, W3, b3 (FNN.packed). All threads of a block stage it into shared memory
// once (fnn_stage); every thread of a warp then reads the same weight at the
// same time, a broadcast without bank conflicts. What bounds it: the
// multiply-adds, N0 N1 + N1 N2 + N2 N3 per sample-step (1,344 for 6-32-32-4),
// each a separate multiply and add (--fmad=false), and N1 + N2 accurate tanhf.
// The layer sizes are compile-time, so the loops unroll and the activations
// stay in registers.
//
// The warp form (forward_warp, for the split dynamics passes of
// split_warp.cuh, one warp per sample): lane o computes output unit o of
// each layer, its inputs summed left to right exactly as fnn_layer sums
// them; the next layer's inputs reach every lane by __shfl_sync from lane j,
// taken in the order j = 0..N-1. No dot product is split across lanes, so
// every unit is the same float as the one-thread form's. Its table is
// staged by stage_warp with each layer's W transposed to (IN, OUT), so that
// the 32 lanes read 32 consecutive words (no bank conflicts).
#pragma once

#include <math.h>

#include "warp.cuh"

template <int IN, int OUT, bool TANH>
__device__ inline void fnn_layer(const float* w, const float* b,
                                 const float* in, float* out) {
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < IN; ++j) acc = acc + w[o * IN + j] * in[j];
    acc = acc + b[o];
    out[o] = TANH ? tanhf(acc) : acc;
  }
}

// The same layer with the loop over the output units rolled (#pragma unroll
// 1), as csrc/lstm.cuh has its gate loops: the same operations in the same
// order, a fraction of the code. The activations are indexed by the rolled
// loop, so they live in local memory (L1). B7's ladder and B8 use it, so
// that riccati.cu and rmppi_rollout.cu build in about 10 s. B1 and B3 keep
// the unrolled layer, which takes about a minute per source to build: with
// the rolled one they took 17-44 % longer (AutoRally, K=1920, T=150, on an
// H100).
template <int IN, int OUT, bool TANH>
__device__ inline void fnn_layer_rolled(const float* w, const float* b,
                                        const float* in, float* out) {
#pragma unroll 1
  for (int o = 0; o < OUT; ++o) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < IN; ++j) acc = acc + w[o * IN + j] * in[j];
    acc = acc + b[o];
    out[o] = TANH ? tanhf(acc) : acc;
  }
}

// N0 inputs, two tanh hidden layers of N1 and N2 units, N3 linear outputs
template <int N0, int N1, int N2, int N3>
struct FNN3 {
  static constexpr int kParams = N1 * N0 + N1 + N2 * N1 + N2 + N3 * N2 + N3;

  // every thread of the block copies its share; the caller syncs after
  __device__ static inline void stage(const float* __restrict__ params,
                                      float* sh) {
    for (int i = threadIdx.x; i < kParams; i += blockDim.x) sh[i] = params[i];
  }

  // the index of packed parameter i (FNN.packed) in the warp form's table:
  // each W (OUT, IN) at its offset as W^T (IN, OUT), the biases in place
  __host__ __device__ static constexpr int warp_slot(int i) {
    constexpr int kL2 = N1 * N0 + N1;      // layer 2's offset
    constexpr int kL3 = kL2 + N2 * N1 + N2;  // layer 3's offset
    return i < kL2   ? transposed_slot(i, 0, N0, N1)
           : i < kL3 ? transposed_slot(i, kL2, N1, N2)
                     : transposed_slot(i, kL3, N2, N3);
  }

  // the warp form's table: every thread of the block; the caller syncs after
  __device__ static inline void stage_warp(const float* __restrict__ params,
                                           float* sh) {
    for (int i = threadIdx.x; i < kParams; i += blockDim.x) {
      sh[warp_slot(i)] = params[i];
    }
  }

  // One step of the warp form from stage_warp's table: in (N0) is the same
  // on every lane, and so is out (N3) after it. Lane o takes unit o % N of
  // each layer of N units (lanes past N repeat a unit); every lane takes
  // part in every shuffle.
  __device__ static inline void forward_warp(const float* p, const float* in,
                                             float* out) {
    static_assert(N1 <= 32 && N2 <= 32 && N3 <= 32, "a layer wider than a warp");
    const int lane = threadIdx.x & 31;
    const int o1 = lane % N1;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < N0; ++j) acc = acc + p[j * N1 + o1] * in[j];
    acc = acc + p[N1 * N0 + o1];
    const float a1 = tanhf(acc);
    p += N1 * N0 + N1;
    const int o2 = lane % N2;
    acc = 0.0f;
#pragma unroll
    for (int j = 0; j < N1; ++j) {
      acc = acc + p[j * N2 + o2] * __shfl_sync(kFullMask, a1, j);
    }
    acc = acc + p[N2 * N1 + o2];
    const float a2 = tanhf(acc);
    p += N2 * N1 + N2;
    const int o3 = lane % N3;
    acc = 0.0f;
#pragma unroll
    for (int j = 0; j < N2; ++j) {
      acc = acc + p[j * N3 + o3] * __shfl_sync(kFullMask, a2, j);
    }
    const float a3 = acc + p[N3 * N2 + o3];
#pragma unroll
    for (int o = 0; o < N3; ++o) out[o] = __shfl_sync(kFullMask, a3, o);
  }

  // kRolled: the layers' output loops rolled (fnn_layer_rolled)
  template <bool kRolled = false>
  __device__ static inline void forward(const float* p, const float* in,
                                        float* out) {
    float h1[N1];
    float h2[N2];
    if constexpr (kRolled) {
      fnn_layer_rolled<N0, N1, true>(p, p + N1 * N0, in, h1);
      p += N1 * N0 + N1;
      fnn_layer_rolled<N1, N2, true>(p, p + N2 * N1, h1, h2);
      p += N2 * N1 + N2;
      fnn_layer_rolled<N2, N3, false>(p, p + N3 * N2, h2, out);
    } else {
      fnn_layer<N0, N1, true>(p, p + N1 * N0, in, h1);
      p += N1 * N0 + N1;
      fnn_layer<N1, N2, true>(p, p + N2 * N1, h1, h2);
      p += N2 * N1 + N2;
      fnn_layer<N2, N3, false>(p, p + N3 * N2, h2, out);
    }
  }
};
