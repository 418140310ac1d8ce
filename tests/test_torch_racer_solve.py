"""One ``VanillaMPPI`` solve of each racer bench row's configuration
(bench.py:719-743, :791-807, cut as in ``test_torch_racer_kernels.py``, whose
helpers this file uses) through ``fused_solve``, ``fused`` and ``combined``
against JAX ``pallas_fused``, ``pallas`` and ``combined`` on the same
normals, on the CPU. Tolerances: costs rtol / atol 1e-4, crash flags
exactly, baselines rtol 1e-5, the means rtol 1e-4 / atol 1e-5 widened by
what the measured cost differences move them (``_weight_slack``), the
re-rolled trajectories by T dt 10 times that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.models import (
    RacerDubinsElevationLSTMSteering,
    RacerDubinsElevationLSTMUncertainty,
)
from test_torch_autorally import jax_cost_params
from test_torch_racer import jax_racer_params
from test_torch_racer_kernels import (
    C,
    DT,
    SAMPLER_FIELDS,
    SHAPES,
    _close,
    _mean,
    _setup,
    _x0,
    fresh_jit_cache,
    one_thread,
)
from test_torch_zoo_kernels import _weight_slack

__all__ = ["fresh_jit_cache", "one_thread"]  # fixtures of the helpers' file


PATHS = [("fused_solve", "pallas_fused"), ("fused", "pallas"), ("combined", "combined")]


@pytest.mark.parametrize("kind", ["steering", "unc"])
@pytest.mark.parametrize("port_kernel,jax_kernel", PATHS)
def test_vanilla_solve_matches_jax(kind, port_kernel, jax_kernel, monkeypatch, one_thread,
                                   fresh_jit_cache):
    """One solve of the row's configuration (lambda 1, alpha 0, stride 1, a
    warm mean) through each path against JAX on the same normals (JAX's
    pallas_fused takes its XLA path off the TPU, with the patched
    _draw_noise); the re-rollout of the mean carries the LSTM state."""
    K, T = SHAPES[kind]
    eps = np.random.default_rng(21).normal(size=(K, T, C)).astype(np.float32)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, m, n, s=0: jnp.asarray(eps))
    (jdyn, jcost, jsamp), _ = _setup(kind)
    jc = JVanilla(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(DT),
                  lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T,
                  num_rollouts=K, num_iters=1, kernel=jax_kernel)
    port_cls = (RacerDubinsElevationLSTMSteering if kind == "steering"
                else RacerDubinsElevationLSTMUncertainty)
    tc = convert.vanilla_from_params(
        jax_racer_params(jdyn, port_cls), jax_cost_params(jcost),
        {n: np.asarray(getattr(jsamp, n)) for n in SAMPLER_FIELDS},
        dict(dt=DT, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K, num_iters=1),
        device="cpu", kernel=port_kernel, dynamics_kind=f"racer_{kind}",
        cost_kind="ar_standard")
    js = jc.init_state(jax.random.PRNGKey(0)).replace(control_mean=jnp.asarray(_mean(T)))
    ts = convert.state_from_params(
        {n: np.asarray(getattr(js, n))
         for n in ("control_mean", "control_history", "previous_baseline")}, tc)
    x0 = _x0(kind)
    jres, jnew = jc.solve(jnp.asarray(x0), js, 1)
    tres, tnew = tc.solve(torch.from_numpy(x0), ts, 1, injected_noise=torch.from_numpy(eps))
    _close(tres.costs, jres.costs, 1e-4, 1e-4, "costs")
    np.testing.assert_array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    _close(tres.baseline, jres.baseline, 1e-5, 0, "baseline")
    U = np.asarray(jnp.clip(jnp.asarray(_mean(T)) + 0.3 * jnp.asarray(eps), -1, 1))
    _, mean_atol = _weight_slack(tres.costs, jres.costs, U, jres.control_mean, 1.0)
    _close(tres.control_mean, jres.control_mean, 1e-4, mean_atol, "control mean")
    _close(tnew.control_mean, jnew.control_mean, 1e-4, mean_atol, "new control mean")
    # the re-rollout of the mean: T steps from the means' difference
    traj_atol = 1e-5 + T * DT * 10 * mean_atol
    _close(tres.state_trajectory, jres.state_trajectory, 1e-4, traj_atol, "state trajectory")
    _close(tres.output_trajectory, jres.output_trajectory, 1e-4, traj_atol,
           "output trajectory")
