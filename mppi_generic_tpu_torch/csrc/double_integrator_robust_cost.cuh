// Double-integrator robust (smooth-barrier) annulus cost for the rollout and
// RMPPI kernels.
//
// Device twin of DoubleIntegratorRobustCost.state_cost in
// mppi_generic_tpu_torch/costs/double_integrator.py (the JAX package's
// costs/double_integrator.py:65-95, reference
// double_integrator_robust_cost.cu): the circle cost's parameters and speed
// and angular-momentum terms, with the crash term replaced by the barrier
// 0.5 crash_cost d^2 on the normalised distance d = (r^2 - center) / width
// from the annulus center-line, and by discount^t crash_cost where |d| > 1.
// It never sets the crash status. Same operations in the same order as the
// PyTorch version.
#pragma once

#include "double_integrator_circle_cost.cuh"

struct DoubleIntegratorRobustCost {
  using Params = DoubleIntegratorCircleCost::Params;
  static constexpr int kNumParams = DoubleIntegratorCircleCost::kNumParams;

  // the rollout and RMPPI kernels' interface: this cost reads no map
  __host__ __device__ static inline Params load(const float* p,
                                                const float* /*map*/) {
    return DoubleIntegratorCircleCost::load(p);
  }

  __host__ __device__ static inline float running_cost(const Params& q,
                                                       const float* y,
                                                       const float* /*u*/,
                                                       int t, int* /*crash*/) {
    const float radial2 = y[0] * y[0] + y[1] * y[1];
    const float speed = sqrtf(y[2] * y[2] + y[3] * y[3]);
    const float ang_mom = y[0] * y[3] - y[1] * y[2];
    const float center_r2 = 0.5f * (q.inner_path_radius2 + q.outer_path_radius2);
    const float width = 0.5f * (q.outer_path_radius2 - q.inner_path_radius2);
    const float d = (radial2 - center_r2) / width;  // |d| = 1 on the boundary
    float cost = 0.5f * q.crash_cost * d * d;
    if (fabsf(d) > 1.0f) {
      cost = expf(static_cast<float>(t) * logf(q.discount)) * q.crash_cost;
    }
    cost = cost + q.velocity_cost * fabsf(speed - q.velocity_desired);
    cost = cost + q.velocity_cost * fabsf(ang_mom - q.angular_momentum_desired);
    return cost;
  }

  __host__ __device__ static inline float terminal_cost(const Params& /*q*/,
                                                        const float* /*y*/) {
    return 0.0f;
  }
};
