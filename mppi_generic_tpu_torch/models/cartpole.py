"""Cartpole dynamics, in PyTorch.

Counterpart of ``CartpoleDynamics`` in ``mppi_generic_tpu/models/cartpole.py``
(reference cartpole_dynamics.cu:49-71): state [pos_x, vel_x, theta,
theta_dot], control [force], output = state, gravity 9.81. The masses and
the pole length are the 0-dim entries of the packed ``params`` buffer
(cart_mass, pole_mass, pole_length), so the divisions are tensor divisions
on every device, as in the kernels. Squares are written as ``x * x``.

The CUDA kernels carry the same step in ``csrc/cartpole.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.models.base import Dynamics

GRAVITY = 9.81
PARAM_NAMES = ("cart_mass", "pole_mass", "pole_length")


class CartpoleDynamics(Dynamics):
    STATE_DIM = 4
    CONTROL_DIM = 1
    OUTPUT_DIM = 4

    def __init__(self, cart_mass=1.0, pole_mass=1.0, pole_length=1.0, device="cpu",
                 **constraints):
        super().__init__(device=device, **constraints)
        self.register_buffer("params", torch.tensor(
            np.asarray([cart_mass, pole_mass, pole_length], np.float32), device=device))

    @classmethod
    def create(cls, cart_mass=1.0, pole_mass=1.0, pole_length=1.0, device="cpu",
               **constraints):
        return cls(cart_mass, pole_mass, pole_length, device=device, **constraints)

    def __getattr__(self, name):
        if name in PARAM_NAMES:
            return self.params[PARAM_NAMES.index(name)]
        return super().__getattr__(name)

    def state_deriv(self, x, u, t=0.0):
        theta_dot, force = x[3], u[0]
        sin_t, cos_t = torch.sin(x[2]), torch.cos(x[2])
        m_c, m_p, l_p = self.cart_mass, self.pole_mass, self.pole_length
        denom = m_c + m_p * (sin_t * sin_t)
        td2 = theta_dot * theta_dot
        x_acc = (force + m_p * sin_t * (l_p * td2 + GRAVITY * cos_t)) / denom
        t_acc = (-force * cos_t - m_p * l_p * td2 * cos_t * sin_t
                 - (m_c + m_p) * GRAVITY * sin_t) / (l_p * denom)
        return torch.stack([x[1], x_acc, theta_dot, t_acc])

    def kernel_params(self):
        """The (cart_mass, pole_mass, pole_length) table csrc/cartpole.cuh
        stages."""
        return self.params

    def state_from_map(self, mapping):
        return torch.tensor([mapping[k] for k in ("POS_X", "VEL_X", "THETA", "THETA_DOT")],
                            dtype=torch.float32, device=self.params.device)
