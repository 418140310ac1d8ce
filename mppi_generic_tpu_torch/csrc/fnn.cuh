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
#pragma once

#include <math.h>

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
