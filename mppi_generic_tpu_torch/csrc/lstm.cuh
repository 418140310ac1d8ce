// The in-kernel LSTM step (B10): one LSTM cell and its two-layer FNN output
// head, evaluated per thread from weights staged in shared memory.
//
// Replaces the TPU kernels' use of mppi_generic_tpu/nn/lstm.py::
// LSTM.forward_axis0 (:197, step_axis0 :174) inside _fused_call (B1) and
// _fused_solve_call (B3), where each gate is an (H, H) @ (H, tile) MXU
// product over a 128-lane sample tile and (h, c) ride the horizon loop's
// carry as (H, rows, 128) blocks. Here each thread runs its own sample, and
// its (h, c) are the caller's per-thread recurrent carry (Dyn::R floats,
// rollout_kernel.cuh / sample_kernels.cuh), filled from the model's warm
// state before the horizon loop. The plain PyTorch version with the same
// order of operations is LSTM.forward_axis0_plain (nn/lstm.py):
//
//   z_r   = (sum_j W_m[r, j] h[j]) + (sum_j W_i[r, j] x[j]) + b[r]
//           each sum left to right from 0, the three parts in JAX's order
//   g_i, g_f, g_o = 1 / (1 + expf(-z)),  g_c = tanhf(z)
//   c'    = g_i g_c + g_f c,   h' = g_o tanhf(c')
//   out   = W2 tanhf(W1 [h'; x] + b1) + b2   (FNN.forward_axis0_plain)
//
// The table (LSTM.kernel_table): W_m (4, H, H), W_i (4, H, I), b (4, H) in
// the gate order (i, f, o, c), then the head's W1 (N1, H + I), b1, W2
// (NO, N1), b2. Every thread of a warp reads the same weight at the same
// time, a shared-memory broadcast.
//
// What bounds it: the multiply-adds, 4 H (H + I) for the gates and
// N1 (H + I) + NO N1 for the head per sample-step (1,280 + 336 for the
// racer steering LSTM 4 -> 16, head 20-16-1), each a separate multiply and
// add (--fmad=false), and 3 H accurate expf, 2 H + N1 tanhf. The loops over
// the hidden and head units are rolled (#pragma unroll 1) to keep the code,
// and with it the build time of the pairs' eight kernel variants, small; the
// sums over the inputs unroll. h' and the head's hidden layer are indexed
// by the rolled loop, so they live in local memory (L1).
#pragma once

#include <math.h>

// the sigmoid of csrc and of nn/lstm.py's ``sigmoid``: one IEEE division
__device__ inline float lstm_sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// I inputs, H hidden units; the head [h'; x] (H + I) -> N1 (tanh) -> NO
template <int I, int H, int N1, int NO>
struct LSTMNet {
  static constexpr int kGates = 4 * H * (H + I) + 4 * H;
  static constexpr int kHead = N1 * (H + I) + N1 + NO * N1 + NO;
  static constexpr int kParams = kGates + kHead;

  // One step: h and c (H each, the caller's carry) are updated in place,
  // out gets the head's NO outputs. x must not alias h or c.
  __device__ static inline void forward(const float* p, float* h, float* c,
                                        const float* x, float* out) {
    const float* wm = p;
    const float* wi = p + 4 * H * H;
    const float* b = p + 4 * H * (H + I);
    float hn[H];
#pragma unroll 1
    for (int o = 0; o < H; ++o) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int r = g * H + o;
        float am = 0.0f;
#pragma unroll
        for (int j = 0; j < H; ++j) am = am + wm[r * H + j] * h[j];
        float ai = 0.0f;
#pragma unroll
        for (int j = 0; j < I; ++j) ai = ai + wi[r * I + j] * x[j];
        z[g] = am + ai + b[r];
      }
      const float g_i = lstm_sigmoid(z[0]);
      const float g_f = lstm_sigmoid(z[1]);
      const float g_o = lstm_sigmoid(z[2]);
      const float g_c = tanhf(z[3]);
      const float c2 = g_i * g_c + g_f * c[o];
      c[o] = c2;  // c[o] is read by unit o only
      hn[o] = g_o * tanhf(c2);
    }
#pragma unroll
    for (int o = 0; o < H; ++o) h[o] = hn[o];

    const float* w1 = p + kGates;
    const float* b1 = w1 + N1 * (H + I);
    const float* w2 = b1 + N1;
    const float* b2 = w2 + NO * N1;
    float a1[N1];
#pragma unroll 1
    for (int o = 0; o < N1; ++o) {
      const float* row = w1 + o * (H + I);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < H; ++j) acc = acc + row[j] * h[j];
#pragma unroll
      for (int j = 0; j < I; ++j) acc = acc + row[H + j] * x[j];
      a1[o] = tanhf(acc + b1[o]);
    }
#pragma unroll 1
    for (int o = 0; o < NO; ++o) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < N1; ++j) acc = acc + w2[o * N1 + j] * a1[j];
      out[o] = acc + b2[o];
    }
  }
};
