"""BicycleSlipParametricElevation on its elevation map (``bicycle_elevation_ar``:
the slip model, the propagated covariance, static settling), ARStandardCost
on the track map: the plain versions of its B3 and B4 entries against
JAX's Pallas kernels in interpret mode, on the CPU. The bicycle's samples
keep close together (its wheel angle is the steering angle over 9.1): from
its start every sample reaches the hot block, at different steps.

B1 is in ``test_torch_racer_family_bicycle.py``. The helpers, configurations
and tolerances are those of test_torch_racer_family_kernels.py."""

import pytest

from test_torch_racer_family_kernels import (
    B3_KINDS,
    B4_KINDS,
    K,
    K_RAGGED,
    check_b3,
    check_b4,
    one_thread,
)

__all__ = ["one_thread"]  # the fixture of the helpers' file
NAME = "bicycle_elevation_ar"


@pytest.mark.parametrize("kind", B3_KINDS)
def test_b3_plain_matches_jax_kernel(kind, one_thread):
    check_b3(NAME, kind, K_RAGGED if kind == "nln" else K)


@pytest.mark.parametrize("kind", B4_KINDS)
def test_b4_plain_matches_jax_kernel(kind, one_thread):
    check_b4(NAME, kind, K_RAGGED if kind == "nln" else K)
