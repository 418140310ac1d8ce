// DDP backward Riccati recursion (B6) and line-search ladder (B7) for
// Hopper, as templates over the sizes and the model. riccati.cu instantiates
// the backward entries and the ladder entries of the double integrator, the
// cartpole and the AutoRally network.
//
// Replaces the TPU kernels of mppi_generic_tpu/ops/pallas_riccati.py:
// _riccati_call (the backward recursion alone, riccati_backward) and
// _ladder_call (the recursion, then the forward pass of every line-search
// step, riccati_ladder_solve). The plain PyTorch versions are in
// mppi_generic_tpu_torch/ops/riccati.py; its wrappers launch these kernels
// through the C entries (BACKWARD_ENTRY, LADDER_ENTRY).
//
// riccati_backward_warp_kernel<S, C> (B6): one block of one warp runs the
// recursion of _backward_pass_into (pallas_riccati.py:63-133) spread over
// its lanes, backward_pass_warp below (B7's recursion, unchanged): per step
// the products Vxx A and Vxx B, the Q terms, the (C, C) system solved by the
// unrolled Gauss elimination of _solve_gauss (no pivoting: quu is SPD after
// the Tikhonov term), the gains, and the value function updated and
// symmetrised, each entry on one lane; the step's A, B, dLx and dLu arrive by
// cp.async two steps ahead. The gains go to dynamic shared memory (T (C S +
// C) floats: 64 KB at T = 1024, (7, 2), past the 48 KB default, so the
// launch opts in), and the warp copies them out coalesced at the end, as the
// ladder does. riccati_backward_kernel<S, C>, built instead with
// -DMPPI_BACKWARD_ONE_THREAD, is the earlier form: one thread runs
// backward_pass with Vx and Vxx in registers (at S = 7 the step's matrices
// take all 255 registers a thread may have) and loads each step's inputs
// from device memory inside the chain. Both give the floats of the plain
// version.
//
// riccati_ladder_warp_kernel<Dyn> (B7): one block. Every thread first stages
// the model's parameters (Dyn::Shared: the AutoRally network's 1,412 floats,
// in the warp form's layout; the cartpole's 3; none for the double
// integrator) and the forward passes' (T, S) and (T, C) tables into shared
// memory. Warp 0 then runs the same recursion spread over its lanes
// (backward_pass_warp): each entry of a step's products (Vxx A, Vxx B, qx,
// qu; then qxx, qux, quu; then the new Vxx and Vx) belongs to one lane,
// which sums over k in the one-thread order; lane j <= S solves column j of
// the (C, C) system with its S + 1 right-hand columns, every such lane
// eliminating M itself (the same floats on each); the step's operands and
// products live in shared memory, where cp.async puts A, B, dLx and dLu two
// steps ahead. After __syncthreads the block copies the gains to the outputs
// and runs the forward passes: for a model with the warp form (HasWarpStep,
// warp_model.cuh: AutoRally), warp w runs line-search steps w, w + W, ...,
// the network through Dyn::state_deriv<true> (FNN3::forward_warp, one unit
// per lane) and everything else the same operations on every lane; for the
// other models thread n < n_alpha runs step n. A forward pass is
// u = clamp(us + alpha_n k + K (x - xs)), x <- x + Dyn::state_deriv(sh, x,
// u) dt (no angle wrap), with the tracking cost sum_t<T-1 (ex'Q ex +
// eu'R eu) dt plus the terminal ex'Q_f ex at t = T-1
// (pallas_riccati.py:233-266). Every value is computed once per lane by the
// operations of the one-thread kernel in its order, so the outputs are its
// floats and those of the plain version.
//
// riccati_ladder_kernel<Dyn>: the one-thread ladder, built instead with
// -DMPPI_LADDER_ONE_THREAD (thread 0 runs backward_pass, thread n runs step
// n's forward pass), kept to time the two forms in one call.
//
// What bounds them on this card: not bytes (about 27 KB in and out at T=50,
// S=4, C=2, n_alpha=14: 8 ns at 3.35 TB/s) and not operations (about 0.5
// MFLOP; at T=150 with the AutoRally network about 14 MFLOP), but latency:
// the recursion is a chain of T-1 dependent steps, and the forward pass a
// second chain of T steps, each a model step (about 3,000 operations for
// the network). On one thread a recursion step was a few hundred (S=4) to a
// few thousand (S=7) dependent operations issued one by one, and
// the network a serial chain of multiply-adds; spread over a warp, a step is
// four rounds of a few overlapping S-term sums per lane, each round ended by
// __syncwarp, and the network a warp-form step. What remains is the
// correctly rounded division of the (C, C) solve, the round trips through
// shared memory between rounds, and in the forward pass the tracking cost's
// serial sum and the network's shuffles.
//
// The TPU kernel's SMEM scalar tables, its 128-lane vector of alphas and its
// shard_map wrapper are TPU mechanics and are not ported.
//
// Numerics: built without --use_fast_math and with --fmad=false; every sum
// is taken left to right over the index, in the order of the TPU kernel's
// unrolled loops and of the plain version, so the kernels reproduce the
// plain version bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "mppi_common.cuh"
#include "warp.cuh"
#include "warp_model.cuh"

namespace {

constexpr int kMaxAlphas = 128;  // line-search steps of one ladder launch
constexpr int kLadderWarps = 16;  // most warps of the warp ladder's block

struct RiccatiArgs {
  const float* As;     // (T, S, S) discrete state Jacobians
  const float* Bs;     // (T, S, C) control Jacobians
  const float* dLx;    // (T, S) state cost gradient, before dt
  const float* dLu;    // (T, C) control cost gradient, before dt
  const float* Qdt;    // (S, S) Q * dt
  const float* Rdt;    // (C, C) R * dt
  const float* Vxx_T;  // (S, S) terminal value Hessian
  const float* Vx_T;   // (S,) terminal value gradient
  int T;
  float dt;
  float reg;  // Tikhonov term on quu's diagonal
};

// M X = rhs for M (C x C) and rhs (C x N), the unrolled elimination of
// _solve_gauss: pivot rows in order, each eliminated row updated right of
// the pivot, then back-substitution. M and rhs are overwritten.
template <int C, int N>
__device__ inline void solve_gauss(float (&M)[C][C], float (&rhs)[C][N],
                                   float (&x)[C][N]) {
#pragma unroll
  for (int p = 0; p < C; ++p) {
    const float inv_p = 1.0f / M[p][p];
#pragma unroll
    for (int r = p + 1; r < C; ++r) {
      const float f = M[r][p] * inv_p;
#pragma unroll
      for (int c = p + 1; c < C; ++c) M[r][c] = M[r][c] - f * M[p][c];
#pragma unroll
      for (int j = 0; j < N; ++j) rhs[r][j] = rhs[r][j] - f * rhs[p][j];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int r = C - 1; r >= 0; --r) {
      float acc = rhs[r][j];
#pragma unroll
      for (int c = r + 1; c < C; ++c) acc = acc - M[r][c] * x[c][j];
      x[r][j] = acc / M[r][r];
    }
  }
}

// The backward recursion; Ks (T, C, S) and ks (T, C) may be shared or
// device memory. Run by one thread.
template <int S, int C>
__device__ void backward_pass(const RiccatiArgs& a, float* Ks, float* ks) {
  const int T = a.T;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ks[(T - 1) * C + c] = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) Ks[((T - 1) * C + c) * S + s] = 0.0f;
  }
  float Vx[S], Vxx[S][S], Qdt[S][S], Rdt[C][C];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    Vx[r] = a.Vx_T[r];
#pragma unroll
    for (int c = 0; c < S; ++c) {
      Vxx[r][c] = a.Vxx_T[r * S + c];
      Qdt[r][c] = a.Qdt[r * S + c];
    }
  }
#pragma unroll
  for (int r = 0; r < C; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) Rdt[r][c] = a.Rdt[r * C + c];
  }

  for (int t = T - 2; t >= 0; --t) {
    float A[S][S], B[S][C];
#pragma unroll
    for (int r = 0; r < S; ++r) {
#pragma unroll
      for (int c = 0; c < S; ++c) A[r][c] = a.As[(t * S + r) * S + c];
#pragma unroll
      for (int c = 0; c < C; ++c) B[r][c] = a.Bs[(t * S + r) * C + c];
    }
    // VA = Vxx A, VB = Vxx B
    float VA[S][S], VB[S][C];
#pragma unroll
    for (int r = 0; r < S; ++r) {
#pragma unroll
      for (int c = 0; c < S; ++c) {
        float acc = Vxx[r][0] * A[0][c];
#pragma unroll
        for (int k = 1; k < S; ++k) acc = acc + Vxx[r][k] * A[k][c];
        VA[r][c] = acc;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float acc = Vxx[r][0] * B[0][c];
#pragma unroll
        for (int k = 1; k < S; ++k) acc = acc + Vxx[r][k] * B[k][c];
        VB[r][c] = acc;
      }
    }
    // qx = dLx dt + A' Vx, qu = dLu dt + B' Vx
    float qx[S], qu[C];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float acc = A[0][s] * Vx[0];
#pragma unroll
      for (int k = 1; k < S; ++k) acc = acc + A[k][s] * Vx[k];
      qx[s] = a.dLx[t * S + s] * a.dt + acc;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float acc = B[0][c] * Vx[0];
#pragma unroll
      for (int k = 1; k < S; ++k) acc = acc + B[k][c] * Vx[k];
      qu[c] = a.dLu[t * C + c] * a.dt + acc;
    }
    // qxx = Q dt + A' (Vxx A), qux = B' (Vxx A), quu = R dt + B' (Vxx B) + reg I
    float qxx[S][S], qux[C][S], quu[C][C];
#pragma unroll
    for (int r = 0; r < S; ++r) {
#pragma unroll
      for (int c = 0; c < S; ++c) {
        float acc = A[0][r] * VA[0][c];
#pragma unroll
        for (int k = 1; k < S; ++k) acc = acc + A[k][r] * VA[k][c];
        qxx[r][c] = Qdt[r][c] + acc;
      }
    }
#pragma unroll
    for (int r = 0; r < C; ++r) {
#pragma unroll
      for (int c = 0; c < S; ++c) {
        float acc = B[0][r] * VA[0][c];
#pragma unroll
        for (int k = 1; k < S; ++k) acc = acc + B[k][r] * VA[k][c];
        qux[r][c] = acc;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float acc = B[0][r] * VB[0][c];
#pragma unroll
        for (int k = 1; k < S; ++k) acc = acc + B[k][r] * VB[k][c];
        quu[r][c] = Rdt[r][c] + acc;
        if (r == c) quu[r][c] = quu[r][c] + a.reg;
      }
    }
    // quu [K | k] = -[qux | qu]
    float rhs[C][S + 1], sol[C][S + 1];
#pragma unroll
    for (int r = 0; r < C; ++r) {
#pragma unroll
      for (int s = 0; s < S; ++s) rhs[r][s] = qux[r][s];
      rhs[r][S] = qu[r];
    }
    solve_gauss<C, S + 1>(quu, rhs, sol);
    float Kk[C][S], kk[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        Kk[c][s] = -sol[c][s];
        Ks[(t * C + c) * S + s] = Kk[c][s];
      }
      kk[c] = -sol[c][S];
      ks[t * C + c] = kk[c];
    }
    // Vxx <- sym(qxx + qux' K), Vx <- qx + qux' k
    float Vn[S][S];
#pragma unroll
    for (int r = 0; r < S; ++r) {
#pragma unroll
      for (int c = 0; c < S; ++c) {
        float acc = qux[0][r] * Kk[0][c];
#pragma unroll
        for (int k = 1; k < C; ++k) acc = acc + qux[k][r] * Kk[k][c];
        Vn[r][c] = qxx[r][c] + acc;
      }
    }
#pragma unroll
    for (int r = 0; r < S; ++r) {
#pragma unroll
      for (int c = 0; c < S; ++c) Vxx[r][c] = 0.5f * (Vn[r][c] + Vn[c][r]);
      float acc = qux[0][r] * kk[0];
#pragma unroll
      for (int k = 1; k < C; ++k) acc = acc + qux[k][r] * kk[k];
      Vx[r] = qx[r] + acc;
    }
  }
}

// B6's earlier form (-DMPPI_BACKWARD_ONE_THREAD): one thread.
template <int S, int C>
__global__ void __launch_bounds__(1)
riccati_backward_kernel(RiccatiArgs a, float* __restrict__ Ks,
                        float* __restrict__ ks) {
  backward_pass<S, C>(a, Ks, ks);
}

// The operands and products of one recursion step in shared memory: the
// inputs [A | B | dLx | dLu] of steps t, t - 1 and t - 2 (in[t % 3]; cp.async
// fills them two steps ahead), the value function, round 1's products
// [VA (S, S) | VB (S, C) | qx (S) | qu (C)] and round 2's [qxx (S, S) |
// qux (C, S) | quu (C, C)].
template <int S, int C>
struct WarpRecursion {
  static constexpr int kIn = S * S + S * C + S + C;
  static constexpr int kRound1 = S * S + S * C + S + C;
  static constexpr int kRound2 = S * S + C * S + C * C;
  static constexpr int kRound4 = S * S + S;  // the new Vxx and Vx
  float in[3][kIn];
  float Vxx[S * S];
  float Vx[S];
  float r1[kRound1];
  float r2[kRound2];
  float Qdt[S * S];
  float Rdt[C * C];
};

// the N floats at src into dst, lane l taking l, l + 32, ... (cp.async)
template <int N>
__device__ inline void copy_async(float* dst, const float* src, int lane) {
#pragma unroll
  for (int j = 0; j < (N + 31) / 32; ++j) {
    if (lane + 32 * j < N) cp_async_f32(dst + lane + 32 * j, src + lane + 32 * j);
  }
}

// step t's inputs into in[t % 3], this lane's share, as one cp.async group
// (an empty group for t < 0, which keeps the group count of every step)
template <int S, int C>
__device__ inline void prefetch_step(const RiccatiArgs& a, WarpRecursion<S, C>& w, int t,
                                     int lane) {
  if (t >= 0) {
    float* in = w.in[t % 3];
    copy_async<S * S>(in, a.As + t * S * S, lane);
    copy_async<S * C>(in + S * S, a.Bs + t * S * C, lane);
    copy_async<S>(in + S * S + S * C, a.dLx + t * S, lane);
    copy_async<C>(in + S * S + S * C + S, a.dLu + t * C, lane);
  }
  cp_async_commit();
}

// p[0] q[0] + p[ps] q[qs] + ... over N terms, summed left to right (the
// one-thread recursion's acc = P0 Q0; acc = acc + Pk Qk)
template <int N>
__device__ inline float dot_strided(const float* p, int ps, const float* q, int qs) {
  float acc = p[0] * q[0];
#pragma unroll
  for (int k = 1; k < N; ++k) acc = acc + p[k * ps] * q[k * qs];
  return acc;
}

// The entries e < N of a round's segment, lane l taking l, l + 32, ...:
// v[j] = f(e) for e = l + 32 j, computed for every j before any is stored
// (store_segment), so that the loads of all of a lane's sums overlap. A
// lane past N computes entry N - 1 again and stores nothing: every lane
// runs the same code, with no branch around a sum.
template <int N>
__host__ __device__ constexpr int lane_iters() {
  return (N + 31) / 32;
}

template <int N, class F>
__device__ inline void compute_segment(float (&v)[lane_iters<N>()], int lane, F f) {
#pragma unroll
  for (int j = 0; j < lane_iters<N>(); ++j) {
    v[j] = f(lane + 32 * j < N ? lane + 32 * j : N - 1);
  }
}

template <int N>
__device__ inline void store_segment(float* out, const float (&v)[lane_iters<N>()], int lane) {
#pragma unroll
  for (int j = 0; j < lane_iters<N>(); ++j) {
    if (lane + 32 * j < N) out[lane + 32 * j] = v[j];
  }
}

// backward_pass spread over the 32 lanes of the calling warp, the gains
// written to Ks (T, C, S) and ks (T, C) (shared memory). Step t's inputs
// were copied to shared memory by cp.async two steps before. Four rounds a
// step, each ended by __syncwarp; each round is made of segments, one per
// product (VA, VB, qx, qu; ...), and lane l takes entries l, l + 32, ... of
// each segment, each entry one sum in the one-thread order. A segment's
// operands are fixed by its kind, so every lane runs the same code (no
// divergent choice of operands), and a lane stores its entries only once
// all are computed, so that their loads overlap:
//   1. VA = Vxx A, VB = Vxx B, qx = dLx dt + A' Vx, qu = dLu dt + B' Vx
//   2. qxx = Q dt + A' VA, qux = B' VA, quu = R dt + B' VB + reg I
//   3. lane j <= S: column j of quu [K | k] = -[qux | qu] (lanes j < S: K's
//      column j, lane S: k), each lane eliminating quu itself
//   4. Vxx = sym(qxx + qux' K) (both Vn entries on the entry's lane),
//      Vx = qx + qux' k
// Every value is the float of backward_pass.
template <int S, int C>
__device__ void backward_pass_warp(const RiccatiArgs& a, WarpRecursion<S, C>& w,
                                   float* Ks, float* ks) {
  constexpr int SS = S * S, SC = S * C, CS = C * S, CC = C * C;
  const int lane = threadIdx.x & 31;
  const int T = a.T;
  prefetch_step<S, C>(a, w, T - 2, lane);
  prefetch_step<S, C>(a, w, T - 3, lane);
  for (int i = lane; i < CS + C; i += 32) {
    if (i < CS) {
      Ks[(T - 1) * CS + i] = 0.0f;
    } else {
      ks[(T - 1) * C + i - CS] = 0.0f;
    }
  }
  for (int i = lane; i < SS; i += 32) {
    w.Vxx[i] = a.Vxx_T[i];
    w.Qdt[i] = a.Qdt[i];
  }
  for (int i = lane; i < S; i += 32) w.Vx[i] = a.Vx_T[i];
  for (int i = lane; i < CC; i += 32) w.Rdt[i] = a.Rdt[i];

  float* VA = w.r1;
  float* VB = VA + SS;
  float* qx = VB + SC;
  float* qu = qx + S;
  float* qxx = w.r2;
  float* qux = qxx + SS;
  float* quu = qux + CS;
  for (int t = T - 2; t >= 0; --t) {
    prefetch_step<S, C>(a, w, t - 2, lane);  // into the buffer step t + 1 has freed
    cp_async_wait<2>();                      // step t's group has arrived
    __syncwarp();
    const float* A = w.in[t % 3];
    const float* B = A + SS;
    const float* dLx = B + SC;
    const float* dLu = dLx + S;
    const float* Vxx = w.Vxx;
    const float* Vx = w.Vx;

    // round 1
    float va[lane_iters<SS>()], vb[lane_iters<SC>()], vqx[lane_iters<S>()],
        vqu[lane_iters<C>()];
    compute_segment<SS>(va, lane, [&](int e) {  // sum_k Vxx[r][k] A[k][c]
      return dot_strided<S>(Vxx + (e / S) * S, 1, A + e % S, S);
    });
    compute_segment<SC>(vb, lane, [&](int e) {  // sum_k Vxx[r][k] B[k][c]
      return dot_strided<S>(Vxx + (e / C) * S, 1, B + e % C, C);
    });
    compute_segment<S>(vqx, lane, [&](int e) {  // dLx[s] dt + sum_k A[k][s] Vx[k]
      return dLx[e] * a.dt + dot_strided<S>(A + e, S, Vx, 1);
    });
    compute_segment<C>(vqu, lane, [&](int e) {  // dLu[c] dt + sum_k B[k][c] Vx[k]
      return dLu[e] * a.dt + dot_strided<S>(B + e, C, Vx, 1);
    });
    store_segment<SS>(VA, va, lane);
    store_segment<SC>(VB, vb, lane);
    store_segment<S>(qx, vqx, lane);
    store_segment<C>(qu, vqu, lane);
    __syncwarp();
    // round 2
    float vxx[lane_iters<SS>()], vux[lane_iters<CS>()], vuu[lane_iters<CC>()];
    compute_segment<SS>(vxx, lane, [&](int e) {  // Qdt[r][c] + sum_k A[k][r] VA[k][c]
      return w.Qdt[e] + dot_strided<S>(A + e / S, S, VA + e % S, S);
    });
    compute_segment<CS>(vux, lane, [&](int e) {  // sum_k B[k][r] VA[k][c]
      return dot_strided<S>(B + e / S, C, VA + e % S, S);
    });
    compute_segment<CC>(vuu, lane, [&](int e) {  // Rdt[r][c] + sum_k B[k][r] VB[k][c] (+ reg)
      const float v = w.Rdt[e] + dot_strided<S>(B + e / C, C, VB + e % C, C);
      return e / C == e % C ? v + a.reg : v;
    });
    store_segment<SS>(qxx, vxx, lane);
    store_segment<CS>(qux, vux, lane);
    store_segment<CC>(quu, vuu, lane);
    __syncwarp();
    // round 3: the (C, C) system, column `col` of [qux | qu] (lanes past S
    // solve column S again and store nothing)
    {
      const int col = lane < S ? lane : S;
      float M[C][C], r[C], x[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) M[i][c] = quu[i * C + c];
        r[i] = col < S ? qux[i * S + col] : qu[i];
      }
#pragma unroll
      for (int p = 0; p < C; ++p) {
        const float inv_p = 1.0f / M[p][p];
#pragma unroll
        for (int i = p + 1; i < C; ++i) {
          const float f = M[i][p] * inv_p;
#pragma unroll
          for (int c = p + 1; c < C; ++c) M[i][c] = M[i][c] - f * M[p][c];
          r[i] = r[i] - f * r[p];
        }
      }
#pragma unroll
      for (int i = C - 1; i >= 0; --i) {
        float acc = r[i];
#pragma unroll
        for (int c = i + 1; c < C; ++c) acc = acc - M[i][c] * x[c];
        x[i] = acc / M[i][i];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (lane < S) {
          Ks[(t * C + c) * S + lane] = -x[c];
        } else if (lane == S) {
          ks[t * C + c] = -x[c];
        }
      }
    }
    __syncwarp();
    // round 4: Vxx <- sym(qxx + qux' K), Vx <- qx + qux' k; Vn[r][c] and
    // Vn[c][r] on the entry's lane
    const float* Kk = Ks + t * CS;
    const float* kk = ks + t * C;
    float vn[lane_iters<SS>()], vx[lane_iters<S>()];
    compute_segment<SS>(vn, lane, [&](int e) {
      const int r = e / S, c = e % S;
      const float n1 = qxx[r * S + c] + dot_strided<C>(qux + r, S, Kk + c, S);
      const float n2 = qxx[c * S + r] + dot_strided<C>(qux + c, S, Kk + r, S);
      return 0.5f * (n1 + n2);
    });
    compute_segment<S>(vx, lane, [&](int e) {
      return qx[e] + dot_strided<C>(qux + e, S, kk, 1);
    });
    store_segment<SS>(w.Vxx, vn, lane);
    store_segment<S>(w.Vx, vx, lane);
    __syncwarp();
  }
  cp_async_wait<0>();  // the empty groups of t < 0
}

// The dynamic shared memory of B6's warp form, in floats: the gains Ks
// (T, C, S) and ks (T, C).
template <int S, int C>
constexpr size_t backward_warp_smem_floats(int T) {
  return static_cast<size_t>(T) * (C * S + C);
}

// B6: the recursion over the block's one warp (backward_pass_warp), the
// gains into shared memory, then copied out coalesced.
template <int S, int C>
__global__ void __launch_bounds__(32)
riccati_backward_warp_kernel(RiccatiArgs a, float* __restrict__ Ks_out,
                             float* __restrict__ ks_out) {
  __shared__ WarpRecursion<S, C> rec;
  extern __shared__ float smem[];  // backward_warp_smem_floats
  const int T = a.T;
  float* Ks = smem;
  float* ks = Ks + T * C * S;
  backward_pass_warp<S, C>(a, rec, Ks, ks);
  __syncwarp();
  for (int i = threadIdx.x; i < T * C * S; i += 32) Ks_out[i] = Ks[i];
  for (int i = threadIdx.x; i < T * C; i += 32) ks_out[i] = ks[i];
}

// 1 where the backward entries launch riccati_backward_warp_kernel, 0 where
// the one-thread riccati_backward_kernel (-DMPPI_BACKWARD_ONE_THREAD)
#ifdef MPPI_BACKWARD_ONE_THREAD
constexpr int kBackwardForm = 0;
#else
constexpr int kBackwardForm = 1;
#endif

// B6 for (S, C) in this build's form (only that kernel is instantiated).
// Returns the launch error.
template <int S, int C>
int launch_backward(const RiccatiArgs& a, float* Ks, float* ks, cudaStream_t stream) {
  if constexpr (kBackwardForm) {
    const size_t smem = sizeof(float) * backward_warp_smem_floats<S, C>(a.T);
    // above 48 KB of static and dynamic shared memory together, a launch
    // needs the opt-in (T = 1024 at S = 7, C = 2: 64 KB of gains)
    if (smem + sizeof(WarpRecursion<S, C>) > 48 * 1024) {
      const cudaError_t attr = cudaFuncSetAttribute(
          riccati_backward_warp_kernel<S, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (attr != cudaSuccess) return static_cast<int>(attr);
    }
    riccati_backward_warp_kernel<S, C><<<1, 32, smem, stream>>>(a, Ks, ks);
  } else {
    riccati_backward_kernel<S, C><<<1, 1, 0, stream>>>(a, Ks, ks);
  }
  return static_cast<int>(cudaGetLastError());
}

struct LadderArgs {
  const float* xs;      // (T, S) reference states
  const float* us;      // (T, C) reference controls
  const float* goal_x;  // (T, S)
  const float* goal_u;  // (T, C)
  const float* Q;       // (S, S)
  const float* R;       // (C, C)
  const float* Q_f;     // (S, S)
  const float* ulim;    // (2, C): lower row, upper row
  const float* alphas;  // (n_alpha,)
  int n_alpha;
};

// Line-search step n's forward pass and tracking cost from the gains Ks, ks
// (shared memory). kWarp: run by every lane of a warp, the same operations
// on each, the model's step in its warp form (Dyn::state_deriv<true>); the
// rows of xs_new and us_new are written by lanes s < S and c < C, the cost
// by lane 0.
template <class Dyn, bool kWarp>
__device__ inline void ladder_forward(const RiccatiArgs& a, const LadderArgs& l,
                                      const typename Dyn::Shared& dyn_sh, const float* Ks,
                                      const float* ks, int n, float* __restrict__ costs,
                                      float* __restrict__ xs_new, float* __restrict__ us_new) {
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  const int T = a.T;
  const int lane = threadIdx.x & 31;
  const float alpha = l.alphas[n];
  float x[S];
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = l.xs[s];
  float acc = 0.0f;
  float* xo = xs_new + static_cast<size_t>(n) * T * S;
  float* uo = us_new + static_cast<size_t>(n) * T * C;
  for (int t = 0; t < T; ++t) {
    // a compiler barrier, as in the warp kernels: the staged network is read
    // from shared memory each step, not hoisted into registers and spilled
    if (kWarp) asm volatile("" ::: "memory");
    float dx[S];
#pragma unroll
    for (int s = 0; s < S; ++s) dx[s] = x[s] - l.xs[t * S + s];
    float u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float u_c = l.us[t * C + c] + alpha * ks[t * C + c];
#pragma unroll
      for (int s = 0; s < S; ++s) u_c = u_c + Ks[(t * C + c) * S + s] * dx[s];
      u[c] = fminf(fmaxf(u_c, l.ulim[c]), l.ulim[C + c]);
    }
    float step;
    if (t < T - 1) {
      float ex[S], eu[C];
#pragma unroll
      for (int s = 0; s < S; ++s) ex[s] = x[s] - l.goal_x[t * S + s];
#pragma unroll
      for (int c = 0; c < C; ++c) eu[c] = u[c] - l.goal_u[t * C + c];
      float rc = l.Q[0] * ex[0] * ex[0];
#pragma unroll
      for (int i = 1; i < S * S; ++i) rc = rc + l.Q[i] * ex[i / S] * ex[i % S];
#pragma unroll
      for (int i = 0; i < C * C; ++i) rc = rc + l.R[i] * eu[i / C] * eu[i % C];
      step = rc * a.dt;
    } else {
      float ex[S];
#pragma unroll
      for (int s = 0; s < S; ++s) ex[s] = x[s] - l.goal_x[(T - 1) * S + s];
      step = l.Q_f[0] * ex[0] * ex[0];
#pragma unroll
      for (int i = 1; i < S * S; ++i) step = step + l.Q_f[i] * ex[i / S] * ex[i % S];
    }
    acc = t == 0 ? step : acc + step;
    float xdot[S];
    if constexpr (kWarp) {
      float xv = x[0];
#pragma unroll
      for (int s = 1; s < S; ++s) xv = lane == s ? x[s] : xv;
      if (lane < S) xo[t * S + lane] = xv;
      float uv = u[0];
#pragma unroll
      for (int c = 1; c < C; ++c) uv = lane == c ? u[c] : uv;
      if (lane < C) uo[t * C + lane] = uv;
      Dyn::template state_deriv<true>(dyn_sh, x, u, static_cast<float>(t), xdot);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) xo[t * S + s] = x[s];
#pragma unroll
      for (int c = 0; c < C; ++c) uo[t * C + c] = u[c];
      Dyn::state_deriv(dyn_sh, x, u, static_cast<float>(t), xdot);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = x[s] + xdot[s] * a.dt;
  }
  if (!kWarp || lane == 0) costs[n] = acc;
}

// The one-thread ladder (built with -DMPPI_LADDER_ONE_THREAD): thread 0 runs
// the recursion, thread n < n_alpha line-search step n.
template <class Dyn>
__global__ void __launch_bounds__(kMaxAlphas)
riccati_ladder_kernel(RiccatiArgs a, LadderArgs l, ModelArgs m,
                      float* __restrict__ Ks_out, float* __restrict__ ks_out,
                      float* __restrict__ costs, float* __restrict__ xs_new,
                      float* __restrict__ us_new) {
  static_assert(RecDim<Dyn>::value == 0, "the ladder steps stateless models");
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  __shared__ typename Dyn::Shared dyn_sh;  // the model's parameters
  extern __shared__ float smem[];          // Ks (T, C, S), then ks (T, C)
  const int T = a.T;
  float* Ks = smem;
  float* ks = smem + T * C * S;
  stage_model<Dyn>(m, &dyn_sh);
  if (threadIdx.x == 0) backward_pass<S, C>(a, Ks, ks);
  __syncthreads();
  for (int i = threadIdx.x; i < T * C * S; i += blockDim.x) Ks_out[i] = Ks[i];
  for (int i = threadIdx.x; i < T * C; i += blockDim.x) ks_out[i] = ks[i];
  if (threadIdx.x < l.n_alpha) {
    ladder_forward<Dyn, false>(a, l, dyn_sh, Ks, ks, threadIdx.x, costs, xs_new, us_new);
  }
}

// The dynamic shared memory of the warp ladder, in floats: the gains Ks
// (T, C, S) and ks (T, C), then the forward passes' tables xs and goal_x
// (T, S), us and goal_u (T, C), staged once so that no step of a forward
// pass waits on device memory.
template <int S, int C>
constexpr size_t ladder_warp_smem_floats(int T) {
  return static_cast<size_t>(T) * (C * S + C + 2 * (S + C));
}

// B7: every thread stages the model and the forward passes' tables, warp 0
// runs the recursion (backward_pass_warp); then a model with the warp form
// runs one line-search step per warp (warp w: steps w, w + W, ...), every
// other model one per thread.
template <class Dyn>
__global__ void __launch_bounds__(32 * kLadderWarps)
riccati_ladder_warp_kernel(RiccatiArgs a, LadderArgs l, ModelArgs m,
                           float* __restrict__ Ks_out, float* __restrict__ ks_out,
                           float* __restrict__ costs, float* __restrict__ xs_new,
                           float* __restrict__ us_new) {
  static_assert(RecDim<Dyn>::value == 0, "the ladder steps stateless models");
  constexpr int S = Dyn::S;
  constexpr int C = Dyn::C;
  constexpr bool kWarp = HasWarpStep<Dyn>::value;
  __shared__ typename Dyn::Shared dyn_sh;  // the model's parameters
  __shared__ WarpRecursion<S, C> rec;
  extern __shared__ float smem[];  // ladder_warp_smem_floats
  const int T = a.T;
  float* Ks = smem;
  float* ks = Ks + T * C * S;
  float* xs = ks + T * C;
  float* goal_x = xs + T * S;
  float* us = goal_x + T * S;
  float* goal_u = us + T * C;
  if constexpr (kWarp) {
    stage_model_warp<Dyn>(m, &dyn_sh);
  } else {
    stage_model<Dyn>(m, &dyn_sh);
  }
  for (int i = threadIdx.x; i < T * S; i += blockDim.x) {
    xs[i] = l.xs[i];
    goal_x[i] = l.goal_x[i];
  }
  for (int i = threadIdx.x; i < T * C; i += blockDim.x) {
    us[i] = l.us[i];
    goal_u[i] = l.goal_u[i];
  }
  if (threadIdx.x < 32) backward_pass_warp<S, C>(a, rec, Ks, ks);
  __syncthreads();
  for (int i = threadIdx.x; i < T * C * S; i += blockDim.x) Ks_out[i] = Ks[i];
  for (int i = threadIdx.x; i < T * C; i += blockDim.x) ks_out[i] = ks[i];
  LadderArgs ls = l;
  ls.xs = xs;
  ls.us = us;
  ls.goal_x = goal_x;
  ls.goal_u = goal_u;
  if constexpr (kWarp) {
    for (int n = threadIdx.x >> 5; n < l.n_alpha; n += blockDim.x >> 5) {
      ladder_forward<Dyn, true>(a, ls, dyn_sh, Ks, ks, n, costs, xs_new, us_new);
    }
  } else if (threadIdx.x < l.n_alpha) {
    ladder_forward<Dyn, false>(a, ls, dyn_sh, Ks, ks, threadIdx.x, costs, xs_new, us_new);
  }
}

// 1 where the entries launch riccati_ladder_warp_kernel, 0 where the
// one-thread riccati_ladder_kernel (-DMPPI_LADDER_ONE_THREAD)
#ifdef MPPI_LADDER_ONE_THREAD
constexpr int kLadderForm = 0;
#else
constexpr int kLadderForm = 1;
#endif

// the ladder kernel of this build (only that one is instantiated)
template <class Dyn>
auto ladder_kernel() {
  if constexpr (kLadderForm) {
    return riccati_ladder_warp_kernel<Dyn>;
  } else {
    return riccati_ladder_kernel<Dyn>;
  }
}

template <class Dyn>
int launch_ladder(const RiccatiArgs& a, const LadderArgs& l, ModelArgs m,
                  float* Ks, float* ks, float* costs, float* xs_new,
                  float* us_new, cudaStream_t stream) {
  const auto kernel = ladder_kernel<Dyn>();
  const size_t smem = sizeof(float) * (kLadderForm
                                           ? ladder_warp_smem_floats<Dyn::S, Dyn::C>(a.T)
                                           : static_cast<size_t>(a.T) * (Dyn::C * Dyn::S + Dyn::C));
  const size_t fixed = sizeof(typename Dyn::Shared) +
                       (kLadderForm ? sizeof(WarpRecursion<Dyn::S, Dyn::C>) : 0);
  // above 48 KB of static and dynamic shared memory together, a launch needs
  // the opt-in (T = 1024 at S = 7, C = 2: 65.5 KB of gains alone, 137 KB
  // with the warp form's tables)
  if (smem + fixed > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  // the warp form with a warp-form model: a warp per line-search step, at
  // most kLadderWarps; otherwise a thread per step (warp 0 at least)
  const int threads = kLadderForm && HasWarpStep<Dyn>::value
                          ? 32 * (l.n_alpha < kLadderWarps ? l.n_alpha : kLadderWarps)
                          : ((l.n_alpha + 31) / 32) * 32;
  kernel<<<1, threads, smem, stream>>>(a, l, m, Ks, ks, costs, xs_new, us_new);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward kernel for (S, C) in this build's form (launch_backward), to
// be expanded inside extern "C". Every pointer is memory of CUDA device
// `device`, and `stream` one of its streams. Returns the CUDA error of the
// launch (0 when it was accepted).
#define BACKWARD_ENTRY(NAME, S_, C_)                                          \
  int NAME(int device, const float* As, const float* Bs, const float* dLx,   \
           const float* dLu, const float* Qdt, const float* Rdt,             \
           const float* Vxx_T, const float* Vx_T, int T, float dt, float reg,\
           float* Ks, float* ks, void* stream) {                             \
    const cudaError_t set = cudaSetDevice(device);                           \
    if (set != cudaSuccess) return static_cast<int>(set);                    \
    const RiccatiArgs a{As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T, T, dt, reg};\
    return launch_backward<S_, C_>(a, Ks, ks,                                \
                                   static_cast<cudaStream_t>(stream));       \
  }

// The ladder kernel for the model DYN, 1 <= n_alpha <= kMaxAlphas, to be
// expanded inside extern "C". dyn_params is the model's parameter table
// (null for a model without one). Outputs: Ks (T, C, S), ks (T, C), costs
// (n_alpha,), xs_new (n_alpha, T, S), us_new (n_alpha, T, C). Returns the
// CUDA error of the launch (0 when it was accepted).
#define LADDER_ENTRY(NAME, DYN)                                               \
  int NAME(int device, const float* As, const float* Bs, const float* dLx,   \
           const float* dLu, const float* Qdt, const float* Rdt,             \
           const float* Vxx_T, const float* Vx_T, const float* xs,           \
           const float* us, const float* goal_x, const float* goal_u,        \
           const float* Q, const float* R, const float* Q_f,                 \
           const float* ulim, const float* alphas, const float* dyn_params,  \
           int n_alpha, int T, float dt, float reg, float* Ks, float* ks,    \
           float* costs, float* xs_new, float* us_new, void* stream) {       \
    const cudaError_t set = cudaSetDevice(device);                           \
    if (set != cudaSuccess) return static_cast<int>(set);                    \
    const RiccatiArgs a{As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T, T, dt, reg};\
    const LadderArgs l{xs, us, goal_x, goal_u, Q, R, Q_f, ulim, alphas,      \
                       n_alpha};                                             \
    return launch_ladder<DYN>(a, l,                                          \
                              ModelArgs{dyn_params, nullptr, nullptr,        \
                                        nullptr},                            \
                              Ks, ks, costs, xs_new, us_new,                 \
                              static_cast<cudaStream_t>(stream));            \
  }
