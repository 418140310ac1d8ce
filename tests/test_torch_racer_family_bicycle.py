"""BicycleSlipParametricElevation on its elevation map (``bicycle_elevation_ar``:
the slip model, the propagated covariance, static settling), ARStandardCost
on the track map: the plain version of its B1 entry against
JAX's Pallas kernels in interpret mode, on the CPU. The bicycle's samples
keep close together (its wheel angle is the steering angle over 9.1): from
its start every sample reaches the hot block, at different steps.

B3 and B4 are in ``test_torch_racer_family_bicycle_sampling.py``. The helpers,
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
NAME = "bicycle_elevation_ar"


@pytest.mark.parametrize("mode", B1_MODES)
def test_b1_plain_matches_jax_kernel(mode, one_thread):
    check_b1(NAME, mode, K_RAGGED if mode == "costs+lr" else K)
