// Device twins of mppi_generic_tpu_torch/utils/math_utils.py: the angle wrap
// and the polynomial atan of the JAX package (utils/math_utils.py), which the
// models and costs call and which set the reference's numbers.
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
