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
// riccati_backward_kernel<S, C>: one thread runs the recursion of
// _backward_pass_into (pallas_riccati.py:63-133): Vx and Vxx in registers,
// per step the products Vxx A and Vxx B, the Q terms, the (C, C) system
// solved by the unrolled Gauss elimination of _solve_gauss (no pivoting:
// quu is SPD after the Tikhonov term), the gains written out, and the value
// function updated and symmetrised. At S = 7 the step's matrices exceed the
// registers and spill to local memory (L1).
//
// riccati_ladder_kernel<Dyn>: one block. Every thread first stages the
// model's parameters (Dyn::Shared: the AutoRally network's 1,412 floats, the
// cartpole's 3, none for the double integrator) into static shared memory,
// as the rollout kernels do (mppi_common.cuh stage_model). Thread 0 runs the
// same recursion and writes the gains to dynamic shared memory; after
// __syncthreads the block copies them to the outputs, and thread n <
// n_alpha runs line-search step n's forward pass from shared memory:
// u = clamp(us + alpha_n k + K (x - xs)), x <- x + Dyn::state_deriv(sh, x,
// u) dt (no angle wrap), with the tracking cost sum_t<T-1 (ex'Q ex +
// eu'R eu) dt plus the terminal ex'Q_f ex at t = T-1
// (pallas_riccati.py:233-266).
//
// What bounds it on this card: not bytes (about 27 KB in and out at T=50,
// S=4, C=2, n_alpha=14: 8 ns at 3.35 TB/s) and not operations (about 0.5
// MFLOP; at T=150 with the AutoRally network about 14 MFLOP), but latency:
// the recursion is a chain of T-1 dependent steps, each a few hundred (S=4)
// to a few thousand (S=7) dependent floating-point operations on one
// thread, and the forward pass a second chain of T steps, each a model step
// (about 3,000 operations for the network). The simple design keeps the
// chain in registers and the gains in shared memory; spreading a step's
// products over a warp is later work.
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

namespace {

constexpr int kMaxAlphas = 128;  // threads of the ladder kernel's block

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

template <int S, int C>
__global__ void __launch_bounds__(1)
riccati_backward_kernel(RiccatiArgs a, float* __restrict__ Ks,
                        float* __restrict__ ks) {
  backward_pass<S, C>(a, Ks, ks);
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

  const int n = threadIdx.x;
  if (n >= l.n_alpha) return;
  const float alpha = l.alphas[n];
  float x[S];
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = l.xs[s];
  float acc = 0.0f;
  float* xo = xs_new + static_cast<size_t>(n) * T * S;
  float* uo = us_new + static_cast<size_t>(n) * T * C;
  for (int t = 0; t < T; ++t) {
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
#pragma unroll
    for (int s = 0; s < S; ++s) xo[t * S + s] = x[s];
#pragma unroll
    for (int c = 0; c < C; ++c) uo[t * C + c] = u[c];
    float xdot[S];
    Dyn::state_deriv(dyn_sh, x, u, static_cast<float>(t), xdot);
#pragma unroll
    for (int s = 0; s < S; ++s) x[s] = x[s] + xdot[s] * a.dt;
  }
  costs[n] = acc;
}

template <class Dyn>
int launch_ladder(const RiccatiArgs& a, const LadderArgs& l, ModelArgs m,
                  float* Ks, float* ks, float* costs, float* xs_new,
                  float* us_new, cudaStream_t stream) {
  auto kernel = riccati_ladder_kernel<Dyn>;
  const size_t smem = sizeof(float) * a.T * (Dyn::C * Dyn::S + Dyn::C);
  // above 48 KB of static and dynamic shared memory together, a launch needs
  // the opt-in (T = 1024 at S = 7, C = 2 is 65.5 KB of gains alone)
  if (smem + sizeof(typename Dyn::Shared) > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const int threads = ((l.n_alpha + 31) / 32) * 32;
  kernel<<<1, threads, smem, stream>>>(a, l, m, Ks, ks, costs, xs_new, us_new);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward kernel for (S, C), to be expanded inside extern "C". Every
// pointer is memory of CUDA device `device`, and `stream` one of its
// streams. Returns the CUDA error of the launch (0 when it was accepted).
#define BACKWARD_ENTRY(NAME, S_, C_)                                          \
  int NAME(int device, const float* As, const float* Bs, const float* dLx,   \
           const float* dLu, const float* Qdt, const float* Rdt,             \
           const float* Vxx_T, const float* Vx_T, int T, float dt, float reg,\
           float* Ks, float* ks, void* stream) {                             \
    const cudaError_t set = cudaSetDevice(device);                           \
    if (set != cudaSuccess) return static_cast<int>(set);                    \
    const RiccatiArgs a{As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T, T, dt, reg};\
    riccati_backward_kernel<S_, C_>                                          \
        <<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(a, Ks, ks);         \
    return static_cast<int>(cudaGetLastError());                             \
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
