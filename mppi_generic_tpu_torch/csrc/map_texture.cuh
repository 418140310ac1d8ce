// The in-kernel map query (B9): an exact-f32 bilinear read of one channel of
// a 2D map in global memory, with CUDA's clamp addressing and linear filter
// on normalized coordinates.
//
// Replaces the TPU kernels' map queries in mppi_generic_tpu/maps/texture.py:
// _query_tex_pallas (:456, the tent-mask MXU bilinear of a VMEM-resident
// map), _query_tex_windowed (:373, the same through a lazily fetched HBM
// window), _tent_dot (:62, their f32 / bf16x3 matmul) and query_tex_channel
// (:568, one channel of a channel-major map). On Hopper the whole map is
// addressable from every thread, so there is no window and no matmul: four
// loads and the lerp. The hardware texture filter is not used: it quantizes
// the lerp fraction to 9 bits (texture.py:36-41).
//
// The plain PyTorch version is MapTexture2D.query_world_components_channel
// (maps/texture.py), with the same operations in the same order, the world ->
// map -> tex pipeline of world_to_tex_components (u = mx / res / W, then the
// sample position u W - 0.5, kept as a round trip) and the four-tap lerp.
// What bounds it: latency, two dependent loads per query (the sample position,
// then the texels; neighbouring samples read nearby texels, from L1/L2).
#pragma once

#include <math.h>

// One channel of a map: texel (y, x) at data[offset + (y W + x) stride].
// The kernels read it from the cost's table (ar_standard_cost.cuh), laid out
// by MapTexture2D.kernel_meta.
struct MapTex {
  const float* data;
  int H, W, offset, stride;
  float origin[3];
  float rot[9];  // rows of R
  float res[3];
};

// normalized coordinate -> (lo, hi, fraction) along an axis of n texels,
// clamp addressing (texture.py _bilinear_axis). The clamp keeps a NaN, as
// torch.clamp and jnp.clip do: a NaN position reads texel 0 with a NaN
// fraction, so the query is NaN.
__device__ inline void bilinear_axis(float coord, int n, int* lo, int* hi,
                                     float* frac) {
  float x = coord * static_cast<float>(n) - 0.5f;
  const float top = static_cast<float>(n - 1);
  x = x < 0.0f ? 0.0f : (x > top ? top : x);
  const float l = floorf(x);
  *frac = x - l;
  *lo = isnan(l) ? 0 : static_cast<int>(l);
  *hi = min(*lo + 1, n - 1);
}

__device__ inline float map_query_tex(const MapTex& m, float u, float v) {
  int x0, x1, y0, y1;
  float fx, fy;
  bilinear_axis(u, m.W, &x0, &x1, &fx);
  bilinear_axis(v, m.H, &y0, &y1, &fy);
  const float* d = m.data + m.offset;
  const float v00 = d[(y0 * m.W + x0) * m.stride];
  const float v01 = d[(y0 * m.W + x1) * m.stride];
  const float v10 = d[(y1 * m.W + x0) * m.stride];
  const float v11 = d[(y1 * m.W + x1) * m.stride];
  const float top = v00 + fx * (v01 - v00);
  const float bot = v10 + fx * (v11 - v10);
  return top + fy * (bot - top);
}

// world (wx, wy, wz) -> map = R (world - origin) -> normalized (u, v)
// (MapTexture2D.world_to_tex_components)
__device__ inline void map_world_to_tex(const MapTex& m, float wx, float wy,
                                        float wz, float* u, float* v) {
  const float dx = wx - m.origin[0];
  const float dy = wy - m.origin[1];
  const float dz = wz - m.origin[2];
  const float mx = m.rot[0] * dx + m.rot[1] * dy + m.rot[2] * dz;
  const float my = m.rot[3] * dx + m.rot[4] * dy + m.rot[5] * dz;
  *u = mx / m.res[0] / static_cast<float>(m.W);
  *v = my / m.res[1] / static_cast<float>(m.H);
}

// world (wx, wy, 0) -> (u, v) -> query
__device__ inline float map_query_world(const MapTex& m, float wx, float wy) {
  float u, v;
  map_world_to_tex(m, wx, wy, 0.0f, &u, &v);
  return map_query_tex(m, u, v);
}

// The map of a cost's packed table: int32 words [H, W, offset, stride] from
// words[0], then the float32 origin (3), rotation rows (9) and resolution (3)
// (MapTexture2D.kernel_meta); the data pointer comes apart.
__device__ inline MapTex load_map_tex(const float* words, const float* data) {
  MapTex m;
  m.data = data;
  m.H = __float_as_int(words[0]);
  m.W = __float_as_int(words[1]);
  m.offset = __float_as_int(words[2]);
  m.stride = __float_as_int(words[3]);
#pragma unroll
  for (int i = 0; i < 3; ++i) m.origin[i] = words[4 + i];
#pragma unroll
  for (int i = 0; i < 9; ++i) m.rot[i] = words[7 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) m.res[i] = words[16 + i];
  return m;
}
