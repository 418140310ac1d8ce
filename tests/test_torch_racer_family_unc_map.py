"""RacerDubinsElevationLSTMUncertainty on an elevation map: the map mode of
the ``racer_unc_ar`` entries (the suspension's ground and the static roll
and pitch read from the map), ARStandardCost on the track map: the plain
versions of its B1 entry against JAX's Pallas kernels in
interpret mode, on the CPU.

B3 and B4 are in ``test_torch_racer_family_unc_map_b3.py`` and ``..._b4.py``.
The helpers, configurations and tolerances are those of
test_torch_racer_family_kernels.py."""

import pytest

from test_torch_racer_family_kernels import (
    B1_MODES,
    K,
    K_RAGGED,
    check_b1,
    one_thread,
)

__all__ = ["one_thread"]  # the fixture of the helpers' file
NAME = "racer_unc_map"


@pytest.mark.parametrize("mode", B1_MODES)
def test_b1_plain_matches_jax_kernel(mode, one_thread):
    crash = check_b1(NAME, mode, K_RAGGED if mode == "costs+lr" else K)
    if mode == "costs":
        assert 0 < int(crash.sum()) < K  # some samples crash, some do not
