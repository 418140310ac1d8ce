"""RacerDubinsElevationLSTMUncertainty on an elevation map: the map mode of
the ``racer_unc_ar`` entries (the suspension's ground and the static roll
and pitch read from the map), ARStandardCost on the track map: the plain
versions of its B3 entry against JAX's Pallas kernels in
interpret mode, on the CPU.

B1 is in ``test_torch_racer_family_unc_map.py``, B4 in
``test_torch_racer_family_unc_map_b4.py``. The helpers, configurations
and tolerances are those of test_torch_racer_family_kernels.py."""

import pytest

from test_torch_racer_family_kernels import (
    B3_KINDS,
    K,
    K_RAGGED,
    check_b3,
    one_thread,
)

__all__ = ["one_thread"]  # the fixture of the helpers' file
NAME = "racer_unc_map"


@pytest.mark.parametrize("kind", B3_KINDS)
def test_b3_plain_matches_jax_kernel(kind, one_thread):
    check_b3(NAME, kind, K_RAGGED if kind == "nln" else K)
