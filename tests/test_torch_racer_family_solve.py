"""One ``VanillaMPPI`` solve of RACER Dubins and its elevation model (the
configurations of test_torch_racer_family_kernels.py, whose helpers this
file uses; the other pairs' solves are in
test_torch_racer_family_solve_{suspension,lstm,unc_map}.py) through
``fused`` against JAX ``pallas`` and through ``fused_solve`` against JAX
``pallas_fused`` on the same normals, on the CPU,
as test_torch_vanilla_fused_solve.py does for the double integrator. The
bicycle with a normals map: the kernel wrappers refuse it with
``KernelIncompatible`` (no kernel of either package reads a 3-channel map)
and the controller's eager solve, on both kernel paths, matches JAX
``kernel="combined"``.

Tolerances: costs rtol / atol 1e-4, crash flags exactly, baselines rtol
1e-5, the means rtol 1e-4 / atol 1e-5 widened by what the measured cost
differences move them (``_weight_slack``), the re-rolled trajectories by
T dt 10 times that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.costs import ARStandardCost as JStandard
from mppi_generic_tpu.models import BicycleSlipParametricElevation as JBicycle
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.ops import KernelIncompatible
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve
from mppi_generic_tpu_torch.sampling import GaussianDistribution
from test_torch_autorally import jax_cost_params
from test_torch_bicycle_elevation import jax_bicycle_params, jax_normals_map
from test_torch_racer import jax_elevation_map
from test_torch_racer_family_kernels import (
    C,
    DT,
    SAMPLER_FIELDS,
    T,
    _close,
    _mean,
    family_jax,
    one_thread,
)
from test_torch_racer_kernels import _track_map
from test_torch_zoo_kernels import _weight_slack

__all__ = ["one_thread"]  # the fixture of the helpers' file
K = 64
PATHS = [("fused_solve", "pallas_fused"), ("fused", "pallas")]
# two of the pairs without an LSTM; test_torch_racer_family_solve_suspension.py
# has the other two, test_torch_racer_family_solve_lstm.py and
# test_torch_racer_family_solve_unc_map.py the LSTM configurations
ANALYTIC = ("racer_dubins_ar", "racer_elevation_ar")


@pytest.fixture
def fresh_jit_cache():
    """solve is jitted: a cached trace would ignore the patched noise."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def solve_both(jdyn, jcost, p, kind, x0, port_kernel, jax_kernel, monkeypatch):
    """One solve of each package's VanillaMPPI (lambda 1, alpha 0, a warm
    mean) on the same Gaussian normals: (JAX result, JAX state, port result,
    port state)."""
    eps = np.random.default_rng(21).normal(size=(K, T, C)).astype(np.float32)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, m, n, s=0: jnp.asarray(eps))
    jsamp = JGaussian.create(std_dev=[0.3, 0.5], control_cost_coeff=[0.5, 1.0])
    jc = JVanilla(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(DT),
                  lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T,
                  num_rollouts=K, num_iters=1, kernel=jax_kernel)
    tc = convert.vanilla_from_params(
        p, jax_cost_params(jcost), {n: np.asarray(getattr(jsamp, n)) for n in SAMPLER_FIELDS},
        dict(dt=DT, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K, num_iters=1),
        device="cpu", kernel=port_kernel, dynamics_kind=kind, cost_kind="ar_standard")
    js = jc.init_state(jax.random.PRNGKey(0)).replace(control_mean=jnp.asarray(_mean()))
    ts = convert.state_from_params(
        {n: np.asarray(getattr(js, n))
         for n in ("control_mean", "control_history", "previous_baseline")}, tc)
    jres, jnew = jc.solve(jnp.asarray(x0), js, 1)
    tres, tnew = tc.solve(torch.from_numpy(x0), ts, 1, injected_noise=torch.from_numpy(eps))
    return jres, jnew, tres, tnew, eps


def check_solve(jres, jnew, tres, tnew, eps):
    _close(tres.costs, jres.costs, 1e-4, 1e-4, "costs")
    np.testing.assert_array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    _close(tres.baseline, jres.baseline, 1e-5, 0, "baseline")
    U = np.asarray(jnp.clip(jnp.asarray(_mean()) + jnp.asarray([0.3, 0.5]) * jnp.asarray(eps),
                            -1, 1))
    _, mean_atol = _weight_slack(tres.costs, jres.costs, U, jres.control_mean, 1.0)
    _close(tres.control_mean, jres.control_mean, 1e-4, mean_atol, "control mean")
    _close(tnew.control_mean, jnew.control_mean, 1e-4, mean_atol, "new control mean")
    # the re-rollout of the mean: T steps from the means' difference
    traj_atol = 1e-5 + T * DT * 10 * mean_atol
    _close(tres.state_trajectory, jres.state_trajectory, 1e-4, traj_atol, "state trajectory")
    _close(tres.output_trajectory, jres.output_trajectory, 1e-4, traj_atol,
           "output trajectory")


def check_pair(name, port_kernel, jax_kernel, monkeypatch):
    jdyn, p, kind, x0, indices = family_jax(name)
    jcost = JStandard(costmap=_track_map(), output_indices=indices)
    fr.reset_launch_counts()
    check_solve(*solve_both(jdyn, jcost, p, kind, x0, port_kernel, jax_kernel, monkeypatch))
    assert not any(fr.launch_counts.values())  # the CPU: plain versions only


@pytest.mark.parametrize("name", ANALYTIC)
@pytest.mark.parametrize("port_kernel,jax_kernel", PATHS)
def test_vanilla_solve_matches_jax(name, port_kernel, jax_kernel, monkeypatch, one_thread,
                                   fresh_jit_cache):
    check_pair(name, port_kernel, jax_kernel, monkeypatch)


def _normals_bicycle():
    jdyn = JBicycle.create(elevation_map=jax_elevation_map(), normals_map=jax_normals_map(),
                           K_x=0.3)
    x0 = np.zeros(22, np.float32)
    x0[0], x0[1], x0[2], x0[5] = 0.6, 0.2, 0.2, 3.0
    x0[12:16] = 0.05
    return jdyn, x0


def test_normals_map_is_refused_by_every_wrapper():
    jdyn, x0 = _normals_bicycle()
    dyn = convert.bicycle_parametric_elevation_from_params(jax_bicycle_params(jdyn))
    jcost = JStandard(costmap=_track_map())
    cost = convert.ar_cost_from_params(jax_cost_params(jcost))
    samp = GaussianDistribution.create(std_dev=[0.3, 0.5])
    x0t, mean = torch.from_numpy(x0), torch.from_numpy(_mean())
    U = torch.zeros((K, T, C))
    calls = [
        lambda: fr.fused_rollout_costs(dyn, cost, x0t, U, DT),
        lambda: fr.fused_weighted_rollout(dyn, cost, x0t, U, DT, 1.0),
        lambda: fused_solve.fused_solve_iteration(dyn, cost, samp, x0t, mean, 0, DT, 1.0, 0.0,
                                                  K),
        lambda: fr.fused_sample_rollout_costs(dyn, cost, samp, x0t, mean, 0, DT, 1.0, 0.0, K),
    ]
    for call in calls:
        with pytest.raises(KernelIncompatible, match="normals_map"):
            call()
    # without the normals map the same model takes the kernels
    dyn.normals_map = None
    assert fr.fused_rollout_costs(dyn, cost, x0t, U, DT)[0].shape == (K,)


@pytest.mark.parametrize("port_kernel", ["fused_solve", "fused"])
def test_normals_map_solve_runs_eager_and_matches_jax_combined(port_kernel, monkeypatch,
                                                               one_thread, fresh_jit_cache):
    jdyn, x0 = _normals_bicycle()
    jcost = JStandard(costmap=_track_map(), output_indices=(2, 3, 5, 6, 0, 1))
    fr.reset_launch_counts()
    check_solve(*solve_both(jdyn, jcost, jax_bicycle_params(jdyn), "bicycle_elevation", x0,
                            port_kernel, "combined", monkeypatch))
