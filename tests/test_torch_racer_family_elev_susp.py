"""RacerDubinsElevationSuspension (``racer_elev_susp_ar``: the steering LSTM,
the four-wheel suspension over its elevation map, the propagated covariance),
ARStandardCost on the track map: the plain versions of its B1
entry against JAX's Pallas kernels in interpret mode, on the CPU.

B3 and B4 are in ``test_torch_racer_family_elev_susp_sampling.py``.
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
NAME = "racer_elev_susp_ar"


@pytest.mark.parametrize("mode", B1_MODES)
def test_b1_plain_matches_jax_kernel(mode, one_thread):
    crash = check_b1(NAME, mode, K_RAGGED if mode == "costs+lr" else K)
    if mode == "costs":
        assert 0 < int(crash.sum()) < K  # some samples crash, some do not
