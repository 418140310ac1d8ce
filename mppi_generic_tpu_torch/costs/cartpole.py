"""Cartpole swing-up quadratic cost, in PyTorch.

Counterpart of ``CartpoleQuadraticCost`` in
``mppi_generic_tpu/costs/cartpole.py`` (reference
cartpole_quadratic_cost.cu): sum_i coeffs_i (y_i - desired_i)^2 over the
four outputs, summed left to right; the terminal cost is the same quadratic
times ``terminal_cost_coeff``. The CUDA kernels carry the same cost in
``csrc/cartpole_quadratic_cost.cuh``, which reads the packed ``params``
buffer: coeffs (4), desired_state (4), terminal_cost_coeff.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mppi_generic_tpu_torch.costs.base import Cost


class CartpoleQuadraticCost(Cost):
    CONTROL_DIM = 1
    OUTPUT_DIM = 4

    def __init__(self, coeffs=(1000.0, 100.0, 2000.0, 100.0),
                 desired_state=(0.0, 0.0, math.pi, 0.0), terminal_cost_coeff=0.0,
                 device="cpu"):
        super().__init__()
        table = np.concatenate([np.asarray(coeffs, np.float32).reshape(4),
                                np.asarray(desired_state, np.float32).reshape(4),
                                np.asarray([terminal_cost_coeff], np.float32)])
        self.register_buffer("params", torch.tensor(table, device=device))

    @property
    def coeffs(self):
        return self.params[0:4]

    @property
    def desired_state(self):
        return self.params[4:8]

    @property
    def terminal_cost_coeff(self):
        return self.params[8]

    def _quad(self, y):
        p = self.params
        terms = []
        for i in range(4):
            d = y[i] - p[4 + i]
            terms.append(p[i] * (d * d))
        return sum(terms[1:], terms[0])

    def state_cost(self, y, t, crash):
        return self._quad(y), crash

    def terminal_cost(self, y):
        return self.terminal_cost_coeff * self._quad(y)
