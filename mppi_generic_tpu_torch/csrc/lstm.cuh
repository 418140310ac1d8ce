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
//
// The warp form (forward_warp, for the split dynamics passes of
// split_warp.cuh, one warp per sample; H = 16): lanes 0-15 take gates (i, f)
// of unit o = lane, lanes 16-31 gates (o, c) of unit o = lane - 16, each z
// formed as above; the pair of activated gates is exchanged with
// __shfl_xor_sync(..., 16), so lanes o and o + 16 both form c'[o] and h'[o]
// with the same operations on the same values. The carry is (h[o], c[o]) in
// lane o and its mirror o + 16: two registers a lane. h[j] reaches every
// lane by __shfl_sync from lane j, j = 0..H-1 in order. The head's N1 rows
// go on lanes 0..N1-1 (mirrored above), its NO outputs on lanes 0..NO-1,
// then to every lane. No sum is split across lanes, so every value is the
// float of the one-thread form. stage_warp lays the table out for it: the
// gate rows of each lane's first gate (i or o) and of its second (f or c),
// each block transposed (lane-minor), and the head's W1 and W2 transposed,
// so that the lanes read consecutive words.
#pragma once

#include <math.h>

#include "warp.cuh"

// the sigmoid of csrc and of nn/lstm.py's ``sigmoid``: one IEEE division
__device__ inline float lstm_sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// I inputs, H hidden units; the head [h'; x] (H + I) -> N1 (tanh) -> NO
template <int I, int H, int N1, int NO>
struct LSTMNet {
  static constexpr int kGates = 4 * H * (H + I) + 4 * H;
  static constexpr int kHead = N1 * (H + I) + N1 + NO * N1 + NO;
  static constexpr int kParams = kGates + kHead;
  static constexpr int kHidden = H;

  // the index of table entry i (LSTM.kernel_table) in the warp form's table
  __host__ __device__ static constexpr int warp_slot(int i) {
    constexpr int kWi = 4 * H * H;         // W_i's offset
    constexpr int kB = 4 * H * (H + I);    // b's offset
    constexpr int kW1 = kGates;            // the head's W1
    constexpr int kW2 = kW1 + N1 * (H + I) + N1;
    if (i >= kW2) return transposed_slot(i, kW2, N1, NO);
    if (i >= kW1) return transposed_slot(i, kW1, H + I, N1);
    // a gate row r = g H + o goes to block g & 1 (lanes' first or second
    // gate), lane (g >> 1) H + o
    const int off = i >= kB ? kB : i >= kWi ? kWi : 0;
    const int n = i >= kB ? 1 : i >= kWi ? I : H;  // entries per row
    const int r = (i - off) / n;
    const int j = (i - off) % n;
    const int g = r / H;
    const int lane = (g >> 1) * H + r % H;
    return off + (g & 1) * n * 2 * H + j * 2 * H + lane;
  }

  // the warp form's table: every thread of the block; the caller syncs after
  __device__ static inline void stage_warp(const float* __restrict__ params,
                                           float* sh) {
    for (int i = threadIdx.x; i < kParams; i += blockDim.x) {
      sh[warp_slot(i)] = params[i];
    }
  }

  // One step of the warp form from stage_warp's table: h and c are this
  // lane's unit's (lane % H), updated in place; x (I) is the same on every
  // lane, and so is out (NO) after it. Every lane takes part in every
  // shuffle.
  __device__ static inline void forward_warp(const float* p, float& h, float& c,
                                             const float* x, float* out) {
    static_assert(2 * H == 32 && N1 <= 32 && NO <= 32, "the lane map is for H = 16");
    const int lane = threadIdx.x & 31;
    const bool second = lane >= H;  // gates (o, c) of unit lane - H
    const float* wm = p;
    const float* wi = p + 4 * H * H;
    const float* b = p + 4 * H * (H + I);
    float am_a = 0.0f;
    float am_b = 0.0f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float hj = __shfl_sync(kFullMask, h, j);
      am_a = am_a + wm[j * 2 * H + lane] * hj;
      am_b = am_b + wm[(H + j) * 2 * H + lane] * hj;
    }
    float ai_a = 0.0f;
    float ai_b = 0.0f;
#pragma unroll
    for (int j = 0; j < I; ++j) {
      ai_a = ai_a + wi[j * 2 * H + lane] * x[j];
      ai_b = ai_b + wi[(I + j) * 2 * H + lane] * x[j];
    }
    const float g_a = lstm_sigmoid(am_a + ai_a + b[lane]);  // i or o
    const float z_b = am_b + ai_b + b[2 * H + lane];
    const float g_b = second ? tanhf(z_b) : lstm_sigmoid(z_b);  // f or c
    const float m_a = __shfl_xor_sync(kFullMask, g_a, H);
    const float m_b = __shfl_xor_sync(kFullMask, g_b, H);
    const float g_i = second ? m_a : g_a;
    const float g_f = second ? m_b : g_b;
    const float g_o = second ? g_a : m_a;
    const float g_c = second ? g_b : m_b;
    const float c2 = g_i * g_c + g_f * c;
    c = c2;
    h = g_o * tanhf(c2);

    const float* w1 = p + kGates;
    const float* b1 = w1 + N1 * (H + I);
    const float* w2 = b1 + N1;
    const float* b2 = w2 + NO * N1;
    const int o1 = lane % N1;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < H; ++j) acc = acc + w1[j * N1 + o1] * __shfl_sync(kFullMask, h, j);
#pragma unroll
    for (int j = 0; j < I; ++j) acc = acc + w1[(H + j) * N1 + o1] * x[j];
    const float a1 = tanhf(acc + b1[o1]);
    const int o2 = lane % NO;
    acc = 0.0f;
#pragma unroll
    for (int j = 0; j < N1; ++j) acc = acc + w2[j * NO + o2] * __shfl_sync(kFullMask, a1, j);
    const float v = acc + b2[o2];
#pragma unroll
    for (int o = 0; o < NO; ++o) out[o] = __shfl_sync(kFullMask, v, o);
  }

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

// One step of LSTM Net from the carry rec: the one-thread form's (h[H],
// c[H]) or, with kWarp, the warp form's (h, c) of this lane's unit.
template <bool kWarp, class Net>
__device__ inline void lstm_forward(const float* p, float* rec, const float* x,
                                    float* out) {
  if constexpr (kWarp) {
    Net::forward_warp(p, rec[0], rec[1], x, out);
  } else {
    Net::forward(p, rec, rec + Net::kHidden, x, out);
  }
}
