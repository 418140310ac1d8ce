// Philox4x32-10 and the Box-Muller normals of the fused sampling kernels.
//
// Replaces the TPU hardware PRNG of the JAX kernels (pltpu.prng_seed and
// prng_random_bits in pallas_solve.py:172, :184-197 and pallas_rollout.py:
// 1725, :1749-1756, :1850-1885), whose stream follows the grid step that
// draws it. Philox is counter-based (Salmon et al., SC 2011): its output is a
// pure function of a 128-bit counter and a 64-bit key, so each thread draws
// its own normals where it needs them and no sample scratch is kept.
//
// The mapping, which mppi_generic_tpu_torch/ops/philox.py reproduces:
//   counter = (k, t, c / 2, 0), key = (seed, 0)  ->  words w0, w1, w2, w3
//   stream s (0: z, 1: NLN's z2) takes the pair (w[2s], w[2s+1]):
//     u1 = ((w[2s] >> 8) + 0.5f) * 2^-24     in (0, 1)
//     u2 = (w[2s+1] >> 8) * 2^-24            in [0, 1)
//     r = sqrtf(-2 logf(u1)), theta = 2 pi u2
//   channel 2p gets r cosf(theta), channel 2p + 1 gets r sinf(theta)
// for sample k, step t and channel c = 2p or 2p + 1. Every normal is then a
// pure function of (seed, k, t, c, stream): no thread or block layout can
// change it. The transcendentals are the accurate logf, sqrtf, sinf and cosf
// (no __ intrinsics; built without fast math and with --fmad=false), in the
// order of the plain PyTorch version.
#pragma once

#include <math.h>
#include <stdint.h>

struct Philox4x32 {
  static constexpr uint32_t kM0 = 0xD2511F53u;
  static constexpr uint32_t kM1 = 0xCD9E8D57u;
  static constexpr uint32_t kW0 = 0x9E3779B9u;
  static constexpr uint32_t kW1 = 0xBB67AE85u;

  __host__ __device__ static inline void mulhilo(uint32_t a, uint32_t b,
                                                 uint32_t* hi, uint32_t* lo) {
    const uint64_t p = static_cast<uint64_t>(a) * static_cast<uint64_t>(b);
    *hi = static_cast<uint32_t>(p >> 32);
    *lo = static_cast<uint32_t>(p);
  }

  // ten rounds of Philox4x32 on ctr[4] under key (k0, k1), in place
  __host__ __device__ static inline void rounds10(uint32_t* ctr, uint32_t k0,
                                                  uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      if (r > 0) {
        k0 += kW0;
        k1 += kW1;
      }
      uint32_t hi0, lo0, hi1, lo1;
      mulhilo(kM0, ctr[0], &hi0, &lo0);
      mulhilo(kM1, ctr[2], &hi1, &lo1);
      const uint32_t c1 = ctr[1];
      const uint32_t c3 = ctr[3];
      ctr[0] = hi1 ^ c1 ^ k0;
      ctr[1] = lo1;
      ctr[2] = hi0 ^ c3 ^ k1;
      ctr[3] = lo0;
    }
  }
};

// Box-Muller pair from two words, in the float32 operations of
// ops/philox.py::_box_muller
__device__ inline void box_muller(uint32_t wa, uint32_t wb, float* z_cos,
                                  float* z_sin) {
  const float inv_2_24 = 5.9604644775390625e-08f;  // 2^-24, exact
  const float f1 = static_cast<float>(static_cast<int>(wa >> 8));
  const float f2 = static_cast<float>(static_cast<int>(wb >> 8));
  const float u1 = (f1 + 0.5f) * inv_2_24;
  const float u2 = f2 * inv_2_24;
  const float r = sqrtf(-2.0f * logf(u1));
  const float theta = 6.2831853071795864f * u2;
  *z_cos = r * cosf(theta);
  *z_sin = r * sinf(theta);
}

// The normals of sample k at step t for all C channels: z[c] from stream 0
// and, with TWO_STREAMS, z2[c] from stream 1.
template <int C, bool TWO_STREAMS>
__device__ inline void philox_normals(uint32_t seed, int k, int t, float* z,
                                      float* z2) {
#pragma unroll
  for (int p = 0; p < (C + 1) / 2; ++p) {
    uint32_t w[4] = {static_cast<uint32_t>(k), static_cast<uint32_t>(t),
                     static_cast<uint32_t>(p), 0u};
    Philox4x32::rounds10(w, seed, 0u);
    float a, b;
    box_muller(w[0], w[1], &a, &b);
    z[2 * p] = a;
    if (2 * p + 1 < C) z[2 * p + 1] = b;
    if (TWO_STREAMS) {
      box_muller(w[2], w[3], &a, &b);
      z2[2 * p] = a;
      if (2 * p + 1 < C) z2[2 * p + 1] = b;
    }
  }
}
