// Cartpole step for the rollout and sampling kernels, and its derivative for
// the DDP ladder kernel.
//
// Device twin of CartpoleDynamics.step in
// mppi_generic_tpu_torch/models/cartpole.py (the JAX package's
// models/cartpole.py:19-58, reference cartpole_dynamics.cu:49-71): state
// [pos_x, vel_x, theta, theta_dot], control [force], output = state. The
// same operations in the same order as the PyTorch version, one rounding each
// (--fmad=false), squares as x * x, gravity the float32 rounding of 9.81;
// then the Euler update x + xdot * dt (state_deriv, then step). The masses
// and the pole length arrive as the model's packed `params` table
// (cart_mass, pole_mass, pole_length), staged into shared memory by every
// block (stage); the kernel syncs after.
#pragma once

#include <math.h>

struct Cartpole {
  static constexpr int S = 4;  // state
  static constexpr int C = 1;  // control
  static constexpr int O = 4;  // output
  static constexpr bool kStaged = true;
  static constexpr float kGravity = static_cast<float>(9.81);

  struct Shared {
    float p[3];  // cart_mass, pole_mass, pole_length
  };

  __device__ static inline void stage(const float* __restrict__ params,
                                      Shared* sh) {
    for (int i = threadIdx.x; i < 3; i += blockDim.x) sh->p[i] = params[i];
  }

  // xdot = [vel_x, x_acc, theta_dot, theta_acc] (CartpoleDynamics.state_deriv;
  // the DDP ladder's forward pass steps x <- x + xdot * dt with it)
  __device__ static inline void state_deriv(const Shared& sh, const float* x,
                                            const float* u, float /*t*/,
                                            float* xdot) {
    const float m_c = sh.p[0], m_p = sh.p[1], l_p = sh.p[2];
    const float theta_dot = x[3];
    const float force = u[0];
    const float sin_t = sinf(x[2]);
    const float cos_t = cosf(x[2]);
    const float denom = m_c + m_p * (sin_t * sin_t);
    const float td2 = theta_dot * theta_dot;
    xdot[0] = x[1];
    xdot[1] = (force + m_p * sin_t * (l_p * td2 + kGravity * cos_t)) / denom;
    xdot[2] = theta_dot;
    xdot[3] = ((-force) * cos_t - m_p * l_p * td2 * cos_t * sin_t -
               (m_c + m_p) * kGravity * sin_t) /
              (l_p * denom);
  }

  __device__ static inline void step(const Shared& sh, float* x, const float* u,
                                     float t, float dt, float* y) {
    float xdot[S];
    state_deriv(sh, x, u, t, xdot);
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = x[i] + xdot[i] * dt;
#pragma unroll
    for (int i = 0; i < O; ++i) y[i] = x[i];
  }
};
