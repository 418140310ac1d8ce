// Double-integrator annulus-tracking cost for the fused rollout kernels.
//
// Device twin of DoubleIntegratorCircleCost.state_cost in
// mppi_generic_tpu_torch/costs/double_integrator.py. The parameters arrive
// as the cost module's packed float32 `params` buffer, in the order of its
// PARAM_NAMES. Same operations in the same order as the PyTorch version;
// the discount power is expf(t * logf(discount)), as math_utils.discount_pow
// computes it, so a discount of 1 gives exactly 1.
#pragma once

struct DoubleIntegratorCircleCost {
  struct Params {
    float velocity_cost;
    float crash_cost;
    float velocity_desired;
    float inner_path_radius2;
    float outer_path_radius2;
    float angular_momentum_desired;
    float discount;
  };
  static constexpr int kNumParams = 7;

  __host__ __device__ static inline Params load(const float* p) {
    Params q;
    q.velocity_cost = p[0];
    q.crash_cost = p[1];
    q.velocity_desired = p[2];
    q.inner_path_radius2 = p[3];
    q.outer_path_radius2 = p[4];
    q.angular_momentum_desired = p[5];
    q.discount = p[6];
    return q;
  }

  // running cost at step t on output y; never sets the crash status
  __host__ __device__ static inline float running_cost(const Params& q,
                                                       const float* y,
                                                       const float* /*u*/,
                                                       int t, int* /*crash*/) {
    const float radial2 = y[0] * y[0] + y[1] * y[1];
    const float speed = sqrtf(y[2] * y[2] + y[3] * y[3]);
    const float ang_mom = y[0] * y[3] - y[1] * y[2];
    const bool out_of_track =
        (radial2 < q.inner_path_radius2) || (radial2 > q.outer_path_radius2);
    float cost = 0.0f;
    if (out_of_track) {
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
