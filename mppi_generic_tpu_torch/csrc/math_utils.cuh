// Device twins of mppi_generic_tpu_torch/utils/math_utils.py: the angle wrap,
// sign and the polynomial atan, atan2 and asin of the JAX package
// (utils/math_utils.py), which the models and costs call and which set the
// reference's numbers. The minimum, maximum and clamps keep a NaN as
// torch.minimum, torch.maximum and torch.clamp do (fminf and fmaxf drop it),
// so a NaN flows through as in the plain versions.
//
// Every constant is the float32 rounding of the Python float the JAX package
// writes (static_cast<float> of the double literal), which is what PyTorch and
// JAX use when they combine such a constant with a float32 tensor; a float
// literal such as 0.9998660f would be rounded from the decimal directly.
#pragma once

#include <math.h>

constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kTwoPi = static_cast<float>(6.283185307179586);
constexpr float kHalfPi = static_cast<float>(1.5707963267948966);

// mod(theta + pi, 2 pi) - pi with the floored modulo of jnp.mod and
// torch.remainder written out: fmodf (exact), then the sign fix.
__device__ inline float normalize_angle(float theta) {
  const float a = theta + kPi;
  float m = fmodf(a, kTwoPi);
  if (m < 0.0f) m = m + kTwoPi;
  return m - kPi;
}

// minimax odd polynomial on |z| <= 1 (utils/math_utils.py atan_approx)
__device__ inline float atan_approx(float z) {
  const float s = z * z;
  return z * (static_cast<float>(0.9998660) +
              s * (static_cast<float>(-0.3302995) +
                   s * (static_cast<float>(0.180141) +
                        s * (static_cast<float>(-0.085133) +
                             static_cast<float>(0.0208351) * s))));
}

// full-range atan via |x| > 1 inversion (atan_full_approx)
__device__ inline float atan_full_approx(float x) {
  const float ax = fabsf(x);
  const bool inv = ax > 1.0f;
  const float z = inv ? 1.0f / fmaxf(ax, static_cast<float>(1e-30)) : ax;
  float r = atan_approx(z);
  r = inv ? kHalfPi - r : r;
  return x < 0.0f ? -r : r;
}

// sign(x) with sign(0) == 1 (the reference's mppi::math::sign)
__device__ inline float sign(float x) { return x < 0.0f ? -1.0f : 1.0f; }

// torch.maximum / torch.minimum: NaN if either operand is NaN
__device__ inline float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ inline float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// torch.clamp(x, lo, hi): a NaN stays NaN
__device__ inline float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// atan2 from atan_approx with octant reduction (atan2_approx, eps 1e-30)
__device__ inline float atan2_approx(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = max_nan(ax, ay);
  const float lo = min_nan(ax, ay);
  const float eps = static_cast<float>(1e-30);
  float r = atan_approx(lo / (hi < eps ? eps : hi));
  r = ay > ax ? kHalfPi - r : r;
  r = x < 0.0f ? kPi - r : r;
  return y < 0.0f ? -r : r;
}

// arcsin as atan2_approx(x, sqrt(1 - x^2)) on the clipped domain (asin_approx)
__device__ inline float asin_approx(float x) {
  x = clamp_nan(x, -1.0f, 1.0f);
  const float c = 1.0f - x * x;
  return atan2_approx(x, sqrtf(c < 0.0f ? 0.0f : c));
}
