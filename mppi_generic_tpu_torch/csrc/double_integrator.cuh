// Planar double-integrator step for the fused rollout kernels.
//
// Device twin of DoubleIntegratorDynamics.step in
// mppi_generic_tpu_torch/models/double_integrator.py (state_deriv -> Euler
// update -> state_to_output): state [pos_x, pos_y, vel_x, vel_y], control
// [accel_x, accel_y]. The operations and their order are those of the
// PyTorch version, one rounding each, so that the kernel built with
// --fmad=false reproduces the plain version bit for bit.
#pragma once

struct DoubleIntegrator {
  static constexpr int S = 4;  // state
  static constexpr int C = 2;  // control
  static constexpr int O = 4;  // output

  // x <- x + xdot * dt with xdot = [x2, x3, u0, u1]; y <- x (output = state)
  __host__ __device__ static inline void step(float* x, const float* u,
                                              float /*t*/, float dt,
                                              float* y) {
    const float xd0 = x[2];
    const float xd1 = x[3];
    x[0] = x[0] + xd0 * dt;
    x[1] = x[1] + xd1 * dt;
    x[2] = x[2] + u[0] * dt;
    x[3] = x[3] + u[1] * dt;
    for (int i = 0; i < O; ++i) y[i] = x[i];
  }
};
