"""Tube-MPPI on ``kernel="fused_solve"`` (JAX ``pallas_fused``), on the
CPU: both systems through the fused solve's plain version with one seed per
iteration, so that they draw the same normals, as the JAX package's two
same-key solves do (controllers/tube.py:93-127).

* One solve on AutoRally with ``ARStandardCost`` on a 32^2 map where part
  of the samples crash (``bench.py:704-717`` cut to K=256, T=16, the network
  at scale 1), against JAX ``TubeMPPI(kernel="pallas_fused")`` on the same
  injected normals (off the TPU JAX takes its XLA path with the patched
  ``_draw_noise``), the DDP ladder kernel in interpret mode. Tolerances as
  ``test_torch_robust_family_solve.py``: costs rtol 2e-5 / atol 2e-4, the
  means from the measured cost differences, the gains rtol 1e-4 / atol
  1e-4, crash flags and the acceptance exactly.
* The shared seed: with the kernels' own draw, both systems' samples differ
  from their means by the same normals times sigma (rtol 1e-6: the two
  means round differently when added).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mppi_generic_tpu.controllers import TubeMPPI as JTube
from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu_torch import DDPFeedback, GaussianDistribution, TubeMPPI, convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from test_torch_autorally import jax_cost_params, jax_dynamics_params
from test_torch_autorally_kernels import X0 as AR_X0
from test_torch_autorally_kernels import _setup
from test_torch_robust_family_solve import (
    DT,
    FEEDBACK_FIELDS,
    K_AR,
    SAMPLER_FIELDS,
    T_AR,
    _close,
    _compare_system,
    _params,
    _patch_noise,
    _t,
    fresh_jit_cache,  # noqa: F401 (a fixture)
    one_thread,  # noqa: F401 (a fixture)
)


def test_tube_autorally_fused_solve_matches_jax(monkeypatch, fresh_jit_cache, one_thread):
    rng = np.random.default_rng(41)
    eps = {K_AR: rng.normal(size=(K_AR, T_AR, 2)).astype(np.float32)}
    _patch_noise(monkeypatch, eps)
    (jdyn, jcost, jsamp), _ = _setup("32")
    jc = JTube(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(DT),
               lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T_AR,
               num_rollouts=K_AR, feedback=JDDP.create(jdyn, DT), kernel="pallas_fused")
    tc = convert.tube_from_params(
        jax_dynamics_params(jdyn), jax_cost_params(jcost), _params(jsamp, SAMPLER_FIELDS),
        dict(dt=DT, lam=1.0, alpha=0.0, num_timesteps=T_AR, num_rollouts=K_AR,
             num_iters=1, nominal_threshold=jc.nominal_threshold),
        _params(jc.feedback, FEEDBACK_FIELDS), device="cpu", kernel="fused_solve",
        dynamics_kind="autorally", cost_kind="ar_standard")
    f32 = lambda a: np.asarray(a, np.float32)
    x_nom = AR_X0 + f32([0.02, 0.03, -0.02, 0.0, -0.1, 0.0, 0.0])
    js = jc.init_state(jax.random.PRNGKey(0)).replace(
        control_mean=jnp.asarray(f32(0.2 * rng.normal(size=(T_AR, 2)))),
        nominal_mean=jnp.asarray(f32(0.2 * rng.normal(size=(T_AR, 2)))),
        nominal_state=jnp.asarray(x_nom), nominal_initialized=jnp.bool_(True))
    p = _params(js, ("control_mean", "nominal_mean", "nominal_state", "control_history",
                     "nominal_initialized", "previous_baseline_real",
                     "previous_baseline_nominal"))
    p["feedback_state"] = _params(js.feedback_state,
                                  ("gains", "x_traj", "u_traj", "total_cost"))
    ts = convert.tube_state_from_params(p, tc)
    jres, jnew = jc.solve(jnp.asarray(AR_X0), js)
    tres, tnew = tc.solve(_t(AR_X0), ts, injected_noise=_t(eps[K_AR]))

    assert int(tres.nominal_state_used) == int(jres.nominal_state_used)
    std = tc.sampler.std_dev
    for system, mean in (("real", ts.control_mean), ("nominal", ts.nominal_mean)):
        U = torch.clamp(_t(eps[K_AR]) * std + mean, tc.dynamics.control_ranges[:, 0],
                        tc.dynamics.control_ranges[:, 1])
        _compare_system(getattr(tres, system), getattr(jres, system), U, 1.0, T_AR,
                        (2e-5, 2e-4), system)
    # one seed for both systems: the same samples, the same crash pattern in
    # each where the states agree
    assert 0 < int(np.asarray(jres.real.crash).sum()) < K_AR
    _close(tnew.feedback_state.gains, jnew.feedback_state.gains, 1e-4, 1e-4, "gains")
    _close(tnew.nominal_state, jnew.nominal_state, 1e-6, 1e-6, "nominal_state")


def test_tube_fused_solve_shares_the_draw_between_systems():
    dyn = DoubleIntegratorDynamics.create()
    ctrl = TubeMPPI(dyn, DoubleIntegratorCircleCost(),
                    GaussianDistribution.create(std_dev=[1.0, 0.7]),
                    feedback=DDPFeedback.create(dyn, DT), dt=DT, num_timesteps=12,
                    num_rollouts=128, kernel="fused_solve", return_samples=True,
                    device="cpu")
    cs = ctrl.init_state(seed=5)
    g = torch.Generator().manual_seed(6)
    cs = cs.replace(control_mean=torch.randn((12, 2), generator=g),
                    nominal_mean=torch.randn((12, 2), generator=g),
                    nominal_state=torch.tensor([2.1, 0.1, 0.0, 1.8]),
                    nominal_initialized=True)
    res, _ = ctrl.solve(torch.tensor([2.0, 0.0, 0.0, 2.0]), cs)
    z_real = (res.real.sampled_controls - cs.control_mean) / ctrl.sampler.std_dev
    z_nom = (res.nominal.sampled_controls - cs.nominal_mean) / ctrl.sampler.std_dev
    _close(z_real, z_nom, 1e-6, 1e-5)
    assert float(z_real.std()) > 0.5  # real draws, not a constant
