// Quadratic cost to a goal state or a goal trajectory for the rollout and
// sampling kernels, templated on the output dimension O.
//
// Device twin of QuadraticCost in mppi_generic_tpu_torch/costs/quadratic.py
// (the JAX package's costs/quadratic.py:18-57, reference quadratic_cost.cuh):
// sum_i coeffs_i (y_i - goal_i)^2 over the O outputs, summed left to right.
// With a goal trajectory (H_goal > 0) the goal of step t is row
// clamp(current_time + t, 0, H_goal - 1) of the (H_goal, O) table that rides
// as the cost's map (getIndex, quadratic_cost.cuh:49-58): a gather by t from
// global memory, cached in L1, since every sample reads the same row at the
// same step. The terminal cost is terminal_scale times the state cost at the
// last goal row (the fixed goal at t = 0). The packed `params` table: coeffs
// (O), the fixed goal (O), terminal_scale, then int32 words [H_goal,
// current_time]. Never sets the crash status.
#pragma once

template <int O>
struct QuadraticCostT {
  struct Params {
    float coeffs[O];
    float goal[O];
    float terminal_scale;
    int H;             // rows of the goal trajectory; 0: the fixed goal
    int current_time;  // the trajectory row of step 0
    const float* traj;
  };

  __device__ static inline Params load(const float* p, const float* map) {
    Params q;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      q.coeffs[i] = p[i];
      q.goal[i] = p[O + i];
    }
    q.terminal_scale = p[2 * O];
    q.H = __float_as_int(p[2 * O + 1]);
    q.current_time = __float_as_int(p[2 * O + 2]);
    q.traj = map;
    return q;
  }

  __device__ static inline float state_cost(const Params& q, const float* y,
                                            int t) {
    float g[O];
    if (q.H > 0) {
      int idx = q.current_time + t;
      idx = idx < 0 ? 0 : (idx > q.H - 1 ? q.H - 1 : idx);
#pragma unroll
      for (int i = 0; i < O; ++i) g[i] = q.traj[idx * O + i];
    } else {
#pragma unroll
      for (int i = 0; i < O; ++i) g[i] = q.goal[i];
    }
    float err = y[0] - g[0];
    float s = q.coeffs[0] * (err * err);
#pragma unroll
    for (int i = 1; i < O; ++i) {
      err = y[i] - g[i];
      s = s + q.coeffs[i] * (err * err);
    }
    return s;
  }

  __device__ static inline float running_cost(const Params& q, const float* y,
                                              const float* /*u*/, int t,
                                              int* /*crash*/) {
    return state_cost(q, y, t);
  }

  __device__ static inline float terminal_cost(const Params& q, const float* y) {
    return q.terminal_scale * state_cost(q, y, q.H > 0 ? q.H - 1 : 0);
  }
};
