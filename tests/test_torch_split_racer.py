"""The split form of B1 and B3 for the racer LSTM pairs, on the CPU: the
plain versions of the port's split kernels against the JAX package's split
mode (``split_cost=True``, its Pallas kernels in interpret mode), through
``check_split_b1`` and ``check_split_b3`` of test_torch_split_pairs.py
(tolerances there; each also against the port's combined plain version).
The LSTM's (h, c) rides the dynamics pass from the model's warm state; the
cost pass evaluates the AutoRally cost's sticky crash twice a step.

The racer LSTM-steering model (elevation map, settling, track map): B1 in
its four modes and B3 (Gaussian) at K = 128, T = 8. The racer
LSTM-uncertainty model (three LSTMs, flat ground): B1's costs mode and B3
at K = 64, T = 6 (JAX's interpret-mode LSTM kernels take seconds).
"""

import pytest
import torch

from test_torch_split_pairs import MODES, check_split_b1, check_split_b3

SHAPES = {"racer_steering_ar": (128, 8), "racer_unc_ar": (64, 6)}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = ([("racer_steering_ar", mode) for mode in MODES]
         + [("racer_unc_ar", "costs")])


@pytest.mark.parametrize("name,mode", CASES)
def test_racer_b1_split_plain_matches_jax_split(name, mode, one_thread):
    check_split_b1(name, mode, *SHAPES[name])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_racer_b3_split_plain_matches_jax_split(name, one_thread):
    check_split_b3(name, *SHAPES[name])
