"""The port's kernel tuner (``ops/autotune.py``, the counterpart of JAX
``ops/autotune.py``) on the CPU, at K=64, T=16: the choice over the eager
paths for the double integrator and for Tube-MPPI (JAX
tests/test_review_regressions.py:115), the split sweep of a kernel path,
the in-process and the disk cache (``MPPI_TUNE_CACHE_DIR``,
``MPPI_RETUNE=1``), the cache key's parameter shapes, and the candidates a
controller cannot take. Times on the CPU say nothing of the card: these
tests check what is timed and what is cached, not which path wins."""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch import (
    ColoredMPPI,
    ColoredNoiseDistribution,
    GaussianDistribution,
    TubeMPPI,
    VanillaMPPI,
)
from mppi_generic_tpu_torch.costs import ARStandardCost, DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.maps import MapTexture2D
from mppi_generic_tpu_torch.models import AutorallyNNDynamics, DoubleIntegratorDynamics
from mppi_generic_tpu_torch.ops import autotune

K, T = 64, 16
X0 = torch.tensor([2.0, 0.0, 0.0, 1.0])


@pytest.fixture(autouse=True)
def fresh_caches(tmp_path, monkeypatch):
    """Each test starts with empty caches and a disk cache of its own."""
    monkeypatch.setenv("MPPI_TUNE_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("MPPI_RETUNE", raising=False)
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_DISK", None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counted(monkeypatch):
    """Counts the tuner's timings."""
    calls = []
    real = autotune.time_solve

    def time_solve(ctrl, *args, **kw):
        calls.append((ctrl.kernel, ctrl.split_cost))
        return real(ctrl, *args, **kw)

    monkeypatch.setattr(autotune, "time_solve", time_solve)
    return calls


def _vanilla(**kw):
    return VanillaMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                       GaussianDistribution.create(std_dev=[1.0, 1.0]),
                       num_timesteps=T, num_rollouts=K, device="cpu", **kw)


@pytest.mark.parametrize("controller", ["vanilla", "tube"])
def test_choice_over_combined_and_split(controller, counted):
    if controller == "vanilla":
        ctrl = _vanilla()
    else:
        ctrl = TubeMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                        GaussianDistribution.create(std_dev=[1.0, 1.0]),
                        num_timesteps=T, num_rollouts=K, device="cpu")
    timings = {}
    tuned = autotune.choose_appropriate_kernel(ctrl, X0, num_evaluations=1,
                                               candidates=("combined", "split"),
                                               timings=timings)
    assert tuned.kernel in ("combined", "split")
    assert tuned.kernel == min(timings, key=timings.get)
    assert set(timings) == {"combined", "split"}
    assert ctrl.kernel == "fused"  # the controller itself is left as it was
    assert type(tuned) is type(ctrl) and tuned.dynamics is ctrl.dynamics
    res, _ = tuned.solve(X0, tuned.init_state(0))
    res = res.real if controller == "tube" else res
    assert bool(torch.isfinite(res.control_mean).all())
    # the second call reads the in-process cache and times nothing
    n = len(counted)
    again = autotune.choose_appropriate_kernel(ctrl, X0, num_evaluations=1,
                                               candidates=("combined", "split"))
    assert len(counted) == n
    assert (again.kernel, again.split_cost) == (tuned.kernel, tuned.split_cost)


def test_split_sweep_of_a_kernel_path(counted):
    """A kernel path wins alone; its two forms are timed and the faster
    kept (the cost is eligible); a forced split_cost is not swept."""
    timings = {}
    tuned = autotune.choose_appropriate_kernel(_vanilla(), X0, num_evaluations=1,
                                               candidates=("fused",), timings=timings)
    assert tuned.kernel == "fused"
    assert set(timings) == {"fused", "fused split_cost=False", "fused split_cost=True"}
    assert tuned.split_cost == (timings["fused split_cost=True"]
                                < timings["fused split_cost=False"])
    assert counted == [("fused", None), ("fused", False), ("fused", True)]
    forced = autotune.choose_appropriate_kernel(_vanilla(split_cost=False), X0,
                                                num_evaluations=1, candidates=("fused",))
    assert forced.split_cost is False and len(counted) == 4


def test_disk_cache_round_trip_and_retune(tmp_path, monkeypatch, counted):
    ctrl = _vanilla()
    tuned = autotune.choose_appropriate_kernel(ctrl, X0, num_evaluations=1,
                                               candidates=("combined", "split"))
    assert (tmp_path / "autotune.json").exists()
    n = len(counted)
    # a new process: empty in-process caches, the file read back
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_DISK", None)
    again = autotune.choose_appropriate_kernel(ctrl, X0, num_evaluations=1,
                                               candidates=("combined", "split"))
    assert len(counted) == n and again.kernel == tuned.kernel
    # MPPI_RETUNE=1 times again
    monkeypatch.setenv("MPPI_RETUNE", "1")
    autotune.choose_appropriate_kernel(ctrl, X0, num_evaluations=1,
                                       candidates=("combined", "split"))
    assert len(counted) == 2 * n


def test_cache_key_separates_a_model_with_a_map():
    """The key holds the shapes of the dynamics' and the cost's buffers, so a
    cost with a costmap and one without never share a choice."""
    tex = MapTexture2D(np.zeros((8, 8), np.float32), origin=(-4, -4, 0))

    def ar(cost):
        return VanillaMPPI(AutorallyNNDynamics.create(seed=0), cost,
                           GaussianDistribution.create(std_dev=[0.3, 0.5]),
                           num_timesteps=T, num_rollouts=K, device="cpu")

    with_map, flat = ar(ARStandardCost(costmap=tex)), ar(ARStandardCost())
    cands = autotune.DEFAULT_CANDIDATES
    assert autotune._config_key(with_map, cands) != autotune._config_key(flat, cands)
    assert autotune._config_key(flat, cands) == autotune._config_key(
        ar(ARStandardCost()), cands)
    # K, T, the split choice and the candidates are part of it too
    base = autotune._config_key(_vanilla(), cands)
    assert base != autotune._config_key(_vanilla(split_cost=True), cands)
    assert base != autotune._config_key(_vanilla(), ("combined",))


def test_unsupported_candidates_are_skipped(counted):
    """The colored sampler draws eagerly: ColoredMPPI takes no fused_solve,
    so the tuner never times it; a name the controller does not know is
    skipped as well."""
    ctrl = ColoredMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                       ColoredNoiseDistribution.create(std_dev=[1.0, 1.0],
                                                       exponents=[1.0, 2.0]),
                       num_timesteps=T, num_rollouts=K, device="cpu")
    assert not autotune._kernel_supported(ctrl, "fused_solve")
    assert not autotune._kernel_supported(ctrl, "pallas")
    timings = {}
    tuned = autotune.choose_appropriate_kernel(ctrl, X0, num_evaluations=1,
                                               candidates=("fused_solve", "pallas", "split"),
                                               timings=timings)
    assert set(timings) == {"split"} and tuned.kernel == "split"
    assert all(kernel != "fused_solve" for kernel, _ in counted)
