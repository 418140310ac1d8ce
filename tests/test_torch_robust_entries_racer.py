"""B1 from one x0 per sample for the racer LSTM models, on the CPU: the
port's plain versions of the combined kernel and of the split form against
the JAX package's kernel in interpret mode (x from each sample's row of x0,
(h, c) from the warm state for every sample, as pallas_rollout.py:646-662),
9 candidates x 4 samples over T = 6 (JAX's interpret-mode LSTM kernels take
seconds). Tolerances rtol / atol 1e-4 (the LSTM and head sums in other
orders through T steps, as test_torch_racer_kernels.py); crash flags
exactly. RMPPI's B8 refuses these models in both packages; their stage 2
is in test_torch_fallbacks.py.
"""

import pytest
import torch

from test_torch_robust_entries import check_b1_x0, check_x0_split

RACERS = ("racer_steering_ar", "racer_unc_ar")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", RACERS)
def test_racer_b1_x0_plain_matches_jax_kernel(name, one_thread):
    check_b1_x0(name)


@pytest.mark.parametrize("name", RACERS)
def test_racer_b1_x0_split_plain_matches_jax_split(name, one_thread):
    check_x0_split(name)
