"""The full-suspension RacerSuspension (``racer_suspension_ar``: the rigid
body on four spring-damper wheels over its elevation map, ARStandardCost on
the layout (0, 1, 5, 6, 3, 4) of the JAX suite's kernel test of the model):
the plain version of its B1 entry against JAX's Pallas kernels
in interpret mode, on the CPU.

B3 and B4 are in ``test_torch_racer_family_suspension_sampling.py``. The helpers,
configurations and tolerances are those of test_torch_racer_family_kernels.py."""

import pytest

from test_torch_racer_family_kernels import (
    B1_MODES,
    K,
    K_RAGGED,
    check_b1,
    one_thread,
)

__all__ = ["one_thread"]  # the fixture of the helpers' file
NAME = "racer_suspension_ar"


@pytest.mark.parametrize("mode", B1_MODES)
def test_b1_plain_matches_jax_kernel(mode, one_thread):
    crash = check_b1(NAME, mode, K_RAGGED if mode == "costs+lr" else K)
    if mode == "costs":
        assert 0 < int(crash.sum()) < K  # some samples crash, some do not
