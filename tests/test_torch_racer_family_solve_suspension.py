"""One ``VanillaMPPI`` solve of RacerSuspension and of the bicycle on its
elevation map through ``fused`` against JAX ``pallas`` and through
``fused_solve`` against JAX ``pallas_fused``, on the CPU, with the helpers
and tolerances of test_torch_racer_family_solve.py."""

import pytest

from test_torch_racer_family_solve import PATHS, check_pair, fresh_jit_cache, one_thread

__all__ = ["fresh_jit_cache", "one_thread"]  # the fixtures of the helpers' files


@pytest.mark.parametrize("name", ['racer_suspension_ar', 'bicycle_elevation_ar'])
@pytest.mark.parametrize("port_kernel,jax_kernel", PATHS)
def test_vanilla_solve_matches_jax(name, port_kernel, jax_kernel, monkeypatch, one_thread,
                                   fresh_jit_cache):
    check_pair(name, port_kernel, jax_kernel, monkeypatch)
