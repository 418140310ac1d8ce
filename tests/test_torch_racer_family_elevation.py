"""The RACER Dubins elevation model without an LSTM (``racer_elevation_ar``:
static settling on its elevation map, ARStandardCost on the track map): the
plain versions of its B1, B3 and B4 entries against JAX's Pallas kernels in
interpret mode, on the CPU.

The helpers, configurations and tolerances are those of
test_torch_racer_family_kernels.py."""

import pytest

from test_torch_racer_family_kernels import (
    B1_MODES,
    B3_KINDS,
    B4_KINDS,
    K,
    K_RAGGED,
    check_b1,
    check_b3,
    check_b4,
    one_thread,
)

__all__ = ["one_thread"]  # the fixture of the helpers' file
NAME = "racer_elevation_ar"


@pytest.mark.parametrize("mode", B1_MODES)
def test_b1_plain_matches_jax_kernel(mode, one_thread):
    crash = check_b1(NAME, mode, K_RAGGED if mode == "costs+lr" else K)
    if mode == "costs":
        assert 0 < int(crash.sum()) < K  # some samples crash, some do not


@pytest.mark.parametrize("kind", B3_KINDS)
def test_b3_plain_matches_jax_kernel(kind, one_thread):
    check_b3(NAME, kind, K_RAGGED if kind == "nln" else K)


@pytest.mark.parametrize("kind", B4_KINDS)
def test_b4_plain_matches_jax_kernel(kind, one_thread):
    check_b4(NAME, kind, K_RAGGED if kind == "nln" else K)
