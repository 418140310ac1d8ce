// The staged form of the RMPPI augmented rollout (B8) for the models without
// the warp form: one walker thread per sample keeps only the two systems'
// chains of states, and producer warps read and clamp the raw samples ahead
// of it and take every step's costs after it.
//
// Replaces, for the double integrator's entries (rmppi_rollout.cu: the
// circle and the robust cost), the one-thread rmppi_rollout_kernel
// (rmppi_kernel.cuh), the counterpart of the TPU kernel
// mppi_generic_tpu/ops/pallas_rollout.py::_fused_rmppi_call (:2127, entry
// fused_rmppi_rollout :2352). One thread walked both systems, 40 blocks of
// 64 threads at K = 2560 and 4 at the rmppi_di_robust loop's K = 256: each
// step read its raw sample from its own strided row, clamped it twice,
// formed the feedback and its cost (a correctly rounded division a
// control), stepped both systems and took both running costs (a sqrtf
// each), all in one chain of T steps.
//
// rmppi_rollout_staged_kernel<Dyn, Cost>: a block holds NS = kRmppiSamples =
// 32 samples (80 blocks at K = 2560, 8 at 256) on B4's ring
// (sample_staged.cuh: named barriers, two stages of kChunk = 32 steps; a
// stage holds a record a (step, sample), RmppiStage). Threads 0..NS-1 are
// the walkers, one sample each: per step, from its record, u_raw and u_nom;
// x_nom and x_real before the step into it; dx = x_real - x_nom, the
// feedback u_fb (the gain products in s order), u_real = clamp(u_raw +
// u_fb) over u_raw, and both steps. A step's inputs are read before the
// step ahead of it (the asm volatile guard atop each step keeps its own
// reads below it). The kRmppiProducerWarps warps after them are the
// producers: for each chunk, lane j makes step t0 + j of each of their
// samples, every read issued before any is used: u_raw (a warp reads a
// sample's 32 C contiguous floats) and u_nom = clamp(u_raw); warp 0 also the
// step's state-free table: the gain rows K[t] and sigma^2 as sg * sg. Once
// the walkers have left a chunk, lane j of a producer warp takes step t0 + j
// of its samples apart from the chain (the cost is not StickyCrash,
// mppi_common.cuh: its value ignores the crash flag): the feedback's cost
// from dx as the walker formed it, both outputs (the model's step again, the
// same floats), both running costs and the real system's crash flag, U_real
// written; then three lanes a sample add them in t order, one into each of
// s_nom, j_real and s_fb, the second also OR-ing the crash flags. Every
// value is made by the one-thread kernel's operations in its order, so the
// outputs are its floats and rmppi_rollout_plain's. Barriers:
// kBarFull + s (stage s full: producers arrive, walkers wait), kBarEmpty + s
// (stage s walked: walkers arrive, producers wait) and kBarProducers (the
// producers among themselves, before they refill a stage).
//
// What bounds it on this card: bytes, as for the one-thread kernel (U read
// and U_real written once, about 0.6 us at K = 2560, T = 50); what bounds
// the form is the walker's chain (per step the record's reads and writes,
// dx, the gain products, the clamp and two Euler steps), the first chunk's
// reads before it and the last chunk's costs after it. Blocks of 32 samples
// spread the producers' work over twice the SMs of 64, and the records
// give a walker six 8- or 16-byte shared-memory accesses a step for the
// rows' twenty-two 4-byte ones (both measured faster on the H100: PERF.md
// section 6).
//
// -DMPPI_RMPPI_ONE_THREAD builds the one-thread kernel instead
// (rmppi_kernel.cuh). The k >= K and t >= T tests skip work only: every
// thread takes part in every barrier, so the last block's and the last
// chunk's raggedness changes no barrier count.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mppi_common.cuh"
#include "sample_staged.cuh"

namespace {

// samples of a block (one walker warp), its producer warps and the samples
// of each: K = 2560 runs 80 blocks, K = 256 runs 8
constexpr int kRmppiSamples = 32;
constexpr int kRmppiProducerWarps = 8;
constexpr int kRmppiThreads = kRmppiSamples + 32 * kRmppiProducerWarps;
constexpr int kRmppiPerWarp = kRmppiSamples / kRmppiProducerWarps;
constexpr int kBarProducers = 5;  // the producer warps among themselves

// A stage: for step j and sample i a record of kRec floats, 16-byte
// aligned, of three groups of 4 floats' multiples: u_raw then u_nom (C
// each; the walker writes u_real over u_raw), x_nom and x_real before the
// step (S each). Once the walkers are done with a chunk, the producers leave
// each step's c_nom, c_real, fb and the real system's crash flag (0 or 1) in
// the x_nom group and, at t = T - 1, the terminal costs in the x_real group. Steps lie kStep = NS kRec + 4 floats
// apart: a walker warp (32 samples of a step) and a producer warp (32 steps
// of a sample) each reach distinct banks with their 16-byte accesses.
template <int NS, int S, int C>
struct RmppiStage {
  static constexpr int kUW = (2 * C + 3) / 4 * 4;
  static constexpr int kXW = (S + 3) / 4 * 4;
  static_assert(kXW >= 4, "the x_nom group holds a step's costs and flag");
  static constexpr int kXNom = kUW;
  static constexpr int kXReal = kUW + kXW;
  static constexpr int kRec = kUW + 2 * kXW;
  static constexpr int kStep = NS * kRec + 4;
  static constexpr int kFloats = kChunk * kStep;
  // the step's state-free table, 16-byte rows: K[t] (C S), sigma^2 (C)
  static constexpr int kSig2 = C * S;
  static constexpr int kTab = (C * S + C + 3) / 4 * 4;
  __device__ static float4* rec(float* st, int j, int i) {
    return reinterpret_cast<float4*>(st + j * kStep + i * kRec);
  }
};

// component e (a constant once unrolled) of v
__device__ inline float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// floats f[0..n) from the float4s q: f[e] = comp(q[e / 4], e % 4)
template <int N>
__device__ inline void unpack(const float4* q, float* f) {
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = comp(q[e / 4], e % 4);
}

// the float4s of a group of N floats (padded with zeros) from f
template <int N>
__device__ inline void pack(const float* f, float4* q) {
  float g[(N + 3) / 4 * 4];
#pragma unroll
  for (int e = 0; e < (N + 3) / 4 * 4; ++e) g[e] = e < N ? f[e] : 0.0f;
#pragma unroll
  for (int e = 0; e < (N + 3) / 4; ++e) q[e] = make_float4(g[4 * e], g[4 * e + 1], g[4 * e + 2], g[4 * e + 3]);
}

// u_fb = K[t] dx, the gain products in s order (rmppi_rollout_kernel's)
template <int S>
__device__ inline float feedback(const float* g, const float* dx) {
  float u_fb = g[0] * dx[0];
#pragma unroll
  for (int s = 1; s < S; ++s) u_fb = u_fb + g[s] * dx[s];
  return u_fb;
}

template <class Dyn, class Cost>
__global__ void __launch_bounds__(kRmppiThreads, 1)
rmppi_rollout_staged_kernel(const float* __restrict__ x0_nom,
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
  static_assert(!StickyCrash<Cost>::value,
                "the producers take each step's cost apart from the chain");
  constexpr int NS = kRmppiSamples;
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr int O = Dyn::O;
  using R = RmppiStage<NS, S, C>;
  constexpr int kTab = R::kTab;
  constexpr int kRing = NS + 32 * kRmppiProducerWarps;  // the ring's barriers
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int k0 = blockIdx.x * NS;

  extern __shared__ float4 stages4[];  // two stages of R::kFloats
  float* stages = reinterpret_cast<float*>(stages4);
  __shared__ float4 tabs4[2][kChunk][kTab / 4];
  __shared__ typename Dyn::Shared dyn_sh;
  stage_model<Dyn>(m, &dyn_sh);
  __syncthreads();
  const int tid = threadIdx.x;
  float cr[4 * C];  // the constraint table, in registers
#pragma unroll
  for (int e = 0; e < 4 * C; ++e) cr[e] = cons[e];

  if (tid < NS) {  // the walker of sample k0 + i
    const int i = tid;
    const bool valid = k0 + i < K;
    float x_nom[S], x_real[S], y[O];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      x_nom[s] = x0_nom[s];
      x_real[s] = x0_real[s];
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      float* st = stages + (ch & 1) * R::kFloats;
      const float4(*tab)[kTab / 4] = tabs4[ch & 1];
      const int t0 = ch * kChunk;
      const int n = min(kChunk, T - t0);
      named_sync(kBarFull + (ch & 1), kRing);
      if (valid) {
        // step j's inputs: the u group and the gain rows
        float4 in_u[R::kUW / 4], in_g[(C * S + 3) / 4];
        auto read = [&](int j) {
          const float4* r = R::rec(st, j, i);
#pragma unroll
          for (int q = 0; q < R::kUW / 4; ++q) in_u[q] = r[q];
#pragma unroll
          for (int q = 0; q < (C * S + 3) / 4; ++q) in_g[q] = tab[j][q];
        };
        read(0);
        for (int j = 0; j < n; ++j) {
          // keeps nvcc from hoisting the staged tables out of the loop (as
          // in staged_chain); step j's inputs were read above it
          asm volatile("" ::: "memory");
          float u[2 * C], g[C * S];
          unpack<2 * C>(in_u, u);
          unpack<C * S>(in_g, g);
          if (j + 1 < n) read(j + 1);
          const float t = static_cast<float>(t0 + j);
          float4* r = R::rec(st, j, i);
          pack<S>(x_nom, r + R::kXNom / 4);
          pack<S>(x_real, r + R::kXReal / 4);
          float dx[S];
#pragma unroll
          for (int s = 0; s < S; ++s) dx[s] = x_real[s] - x_nom[s];
          float u_real[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            u_real[c] = clamp_channel(u[c] + feedback<S>(g + c * S, dx), cr, C, c);
          }
          float* ur = reinterpret_cast<float*>(r);
          if constexpr (C == 2) {
            *reinterpret_cast<float2*>(ur) = make_float2(u_real[0], u_real[1]);
          } else {
#pragma unroll
            for (int c = 0; c < C; ++c) ur[c] = u_real[c];
          }
          Dyn::step(dyn_sh, x_nom, u + C, t, dt, y);
          Dyn::step(dyn_sh, x_real, u_real, t, dt, y);
        }
      }
      named_arrive(kBarEmpty + (ch & 1), kRing);
    }
  } else {  // a producer warp: samples w, w + kRmppiProducerWarps, ...
    const int w = (tid - NS) >> 5;
    const int lane = tid & 31;
    const typename Cost::Params cp = Cost::load(m.cost_params, m.cost_map);
    // chunk ch's raw samples and table into stage (ch & 1), lane j's step
    // t0 + j of each sample, every read issued before any store
    auto fill = [&](int ch) {
      float* st = stages + (ch & 1) * R::kFloats;
      const int t = ch * kChunk + lane;
      float u[kRmppiPerWarp][C];
#pragma unroll
      for (int q = 0; q < kRmppiPerWarp; ++q) {
        const int k = k0 + w + q * kRmppiProducerWarps;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          u[q][c] = k < K && t < T ? U[(static_cast<size_t>(k) * T + t) * C + c] : 0.0f;
        }
      }
      if (w == 0 && t < T) {  // the step's table, with the one-thread kernel's operations
        float tb[kTab];
#pragma unroll
        for (int e = 0; e < C * S; ++e) tb[e] = gains[t * C * S + e];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float sg = sigma[t * C + c];
          tb[R::kSig2 + c] = sg * sg;
        }
        pack<C * S + C>(tb, tabs4[ch & 1][lane]);
      }
#pragma unroll
      for (int q = 0; q < kRmppiPerWarp; ++q) {
        float un[2 * C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          un[c] = u[q][c];
          un[C + c] = clamp_channel(u[q][c], cr, C, c);
        }
        pack<2 * C>(un, R::rec(st, lane, w + q * kRmppiProducerWarps));
      }
    };
    // lane 3 q + r (r < 3) keeps sum r of sample w + q kRmppiProducerWarps,
    // in t order: s_nom, j_real, s_fb; then that sum's terminal cost
    const int q_sum = lane / 3;
    const int r_sum = lane % 3;
    const int i_sum = w + q_sum * kRmppiProducerWarps;
    const bool sums = q_sum < kRmppiPerWarp && k0 + i_sum < K;
    float acc = 0.0f, term = 0.0f;
    bool crashed = false;
    for (int ch = 0; ch < n_chunks && ch < 2; ++ch) {
      fill(ch);
      named_arrive(kBarFull + ch, kRing);
    }
    for (int ch = 0; ch < n_chunks; ++ch) {
      float* st = stages + (ch & 1) * R::kFloats;
      const int t0 = ch * kChunk;
      const int t = t0 + lane;
      named_sync(kBarEmpty + (ch & 1), kRing);
      // lane j's step t0 + j of each sample: the feedback's cost as the
      // walker formed u_fb, the two outputs, the two running costs (each
      // step on its own: the cost is not StickyCrash), U_real
      if (t < T) {
        float tb[kTab];
        unpack<kTab>(tabs4[ch & 1][lane], tb);
        const float tf = static_cast<float>(t);
#pragma unroll
        for (int q = 0; q < kRmppiPerWarp; ++q) {
          const int i = w + q * kRmppiProducerWarps;
          const int k = k0 + i;
          if (k < K) {
            float4* r = R::rec(st, lane, i);
            float u[2 * C], x_nom[S], x_real[S], dx[S], y_nom[O], y_real[O];
            unpack<2 * C>(r, u);
            unpack<S>(r + R::kXNom / 4, x_nom);
            unpack<S>(r + R::kXReal / 4, x_real);
#pragma unroll
            for (int c = 0; c < C; ++c) U_real[(static_cast<size_t>(k) * T + t) * C + c] = u[c];
#pragma unroll
            for (int s = 0; s < S; ++s) dx[s] = x_real[s] - x_nom[s];
            float fb = 0.0f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float u_fb = feedback<S>(tb + c * S, dx);
              fb = fb + coeff[c] * u_fb * u_fb / tb[R::kSig2 + c];
            }
            fb = fb_gain * fb;
            Dyn::step(dyn_sh, x_nom, u + C, tf, dt, y_nom);
            Dyn::step(dyn_sh, x_real, u, tf, dt, y_real);
            // the cost ignores the flags' values; the real system's is set
            // where its step crashes
            int crash_n = 0, crash_r = 0;
            const float c_nom = Cost::running_cost(cp, y_nom, u + C, t, &crash_n);
            const float c_real = Cost::running_cost(cp, y_real, u, t, &crash_r);
            const float costs[4] = {c_nom, c_real, fb, crash_r != 0 ? 1.0f : 0.0f};
            pack<4>(costs, r + R::kXNom / 4);
            if (t == T - 1) {
              const float terms[2] = {Cost::terminal_cost(cp, y_nom),
                                      Cost::terminal_cost(cp, y_real)};
              pack<2>(terms, r + R::kXReal / 4);
            }
          }
        }
      }
      __syncwarp();
      const int n = min(kChunk, T - t0);
      if (sums) {
        // s_nom + c_nom, j_real + c_real, s_fb + c_real + fb
        const int e = r_sum == 0 ? 0 : 1;
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          const float* c = reinterpret_cast<const float*>(R::rec(st, j, i_sum) + R::kXNom / 4);
          acc = acc + c[e];
          if (r_sum == 2) acc = acc + c[2];
          crashed = crashed || c[3] != 0.0f;
        }
        if (ch == n_chunks - 1) {
          term = reinterpret_cast<const float*>(R::rec(st, n - 1, i_sum) + R::kXReal / 4)[e];
        }
      }
      if (ch + 2 < n_chunks) {
        // every producer is done with stage (ch & 1) before it is refilled
        named_sync(kBarProducers, 32 * kRmppiProducerWarps);
        fill(ch + 2);
        named_arrive(kBarFull + (ch & 1), kRing);
      }
    }
    if (sums) {
      const int k = k0 + i_sum;
      float* out = r_sum == 0 ? s_nom_out : r_sum == 1 ? j_real_out : s_fb_out;
      out[k] = (acc + term) / static_cast<float>(T);
      if (r_sum == 1) crash_out[k] = crashed ? 1 : 0;
    }
  }
}

// Launch B8's staged form over ceil(K / 32) blocks with its two stages
// (past 48 KB of shared memory, after the opt-in, which the first launch of
// each instantiation makes). Returns the launch error.
template <class Dyn, class Cost, class... Args>
cudaError_t launch_rmppi_staged(int K, cudaStream_t s, Args... args) {
  constexpr size_t smem =
      2 * sizeof(float) * RmppiStage<kRmppiSamples, Dyn::S, Dyn::C>::kFloats;
  auto kern = rmppi_rollout_staged_kernel<Dyn, Cost>;
  static const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<(K + kRmppiSamples - 1) / kRmppiSamples, kRmppiThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace
