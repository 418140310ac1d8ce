"""RacerDubinsElevationLSTMUncertainty on an elevation map: the map mode of
the ``racer_unc_ar`` entries (the suspension's ground and the static roll
and pitch read from the map), ARStandardCost on the track map: the plain
versions of its B4 entry against JAX's Pallas kernels in
interpret mode, on the CPU.

B1 is in ``test_torch_racer_family_unc_map.py``, B3 in
``test_torch_racer_family_unc_map_b3.py``. The helpers, configurations
and tolerances are those of test_torch_racer_family_kernels.py."""

import pytest

from test_torch_racer_family_kernels import (
    B4_KINDS,
    K,
    K_RAGGED,
    check_b4,
    one_thread,
)

__all__ = ["one_thread"]  # the fixture of the helpers' file
NAME = "racer_unc_map"


@pytest.mark.parametrize("kind", B4_KINDS)
def test_b4_plain_matches_jax_kernel(kind, one_thread):
    check_b4(NAME, kind, K_RAGGED if kind == "nln" else K)
