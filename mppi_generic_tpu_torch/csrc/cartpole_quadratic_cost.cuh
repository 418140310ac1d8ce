// Cartpole swing-up quadratic cost for the rollout and sampling kernels.
//
// Device twin of CartpoleQuadraticCost in
// mppi_generic_tpu_torch/costs/cartpole.py (the JAX package's
// costs/cartpole.py:17-45): sum_i coeffs_i (y_i - desired_i)^2 over the four
// outputs, summed left to right as sum(terms[1:], terms[0]); the terminal
// cost is terminal_cost_coeff times the same quadratic. The parameters arrive
// as the cost's packed `params` table: coeffs (4), desired_state (4),
// terminal_cost_coeff. Never sets the crash status.
#pragma once

struct CartpoleQuadraticCost {
  struct Params {
    float coeffs[4];
    float desired[4];
    float terminal;
  };

  __device__ static inline Params load(const float* p, const float* /*map*/) {
    Params q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q.coeffs[i] = p[i];
      q.desired[i] = p[4 + i];
    }
    q.terminal = p[8];
    return q;
  }

  __device__ static inline float quad(const Params& q, const float* y) {
    float d = y[0] - q.desired[0];
    float s = q.coeffs[0] * (d * d);
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      d = y[i] - q.desired[i];
      s = s + q.coeffs[i] * (d * d);
    }
    return s;
  }

  __device__ static inline float running_cost(const Params& q, const float* y,
                                              const float* /*u*/, int /*t*/,
                                              int* /*crash*/) {
    return quad(q, y);
  }

  __device__ static inline float terminal_cost(const Params& q, const float* y) {
    return q.terminal * quad(q, y);
  }
};
