"""The Tube-MPPI path of the port against the JAX package: one solve
against the JAX controller with ``kernel="pallas"`` (its Pallas rollout and
DDP ladder kernels in interpret mode) and ``"combined"`` on the same
injected noise, with the real solution adopted and with it refused;
``slide_control_sequence``; the shared noise of the two systems; and a
short CPU closed loop.

Tolerances: rtol 1e-5 / atol 1e-5, as for the vanilla solve
(tests/test_torch_vanilla.py); crash flags and the acceptance exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import TubeMPPI as JTube
from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.feedback import ilqr as j_ilqr
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu_torch import DDPFeedback, GaussianDistribution, TubeMPPI, convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics

K, T, C, S = 256, 16, 2, 4
DT, LAM, THRESH = 0.02, 2.0, 20.0
RTOL = ATOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(t, j, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


def _jax_controller(kernel):
    dyn = JDI.create()
    return JTube(
        dynamics=dyn, cost=JCircle(),
        sampler=JGaussian.create(std_dev=[1.0, 0.8], control_cost_coeff=[0.5, 1.0]),
        dt=jnp.float32(DT), lam=jnp.float32(LAM), alpha=jnp.float32(0.0),
        num_timesteps=T, num_rollouts=K, nominal_threshold=jnp.float32(THRESH),
        feedback=JDDP.create(dyn, DT), kernel=kernel)


def _params(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def _port_of(jc, kernel):
    return convert.tube_from_params(
        _params(jc.dynamics, ("control_ranges", "control_deadband",
                              "zero_control", "system_noise")),
        _params(jc.cost, DoubleIntegratorCircleCost.PARAM_NAMES),
        _params(jc.sampler, ("std_dev", "control_cost_coeff",
                             "pure_noise_percentage", "std_dev_decay")),
        dict(dt=jc.dt, lam=jc.lam, alpha=jc.alpha, num_timesteps=T,
             num_rollouts=K, num_iters=jc.num_iters,
             nominal_threshold=jc.nominal_threshold),
        _params(jc.feedback, ("Q", "R", "Q_f", "dt", "num_iterations")),
        device="cpu", kernel=kernel)


def _port_state(js, tc):
    p = _params(js, ("control_mean", "nominal_mean", "nominal_state",
                     "control_history", "nominal_initialized",
                     "previous_baseline_real", "previous_baseline_nominal"))
    p["feedback_state"] = _params(js.feedback_state,
                                  ("gains", "x_traj", "u_traj", "total_cost"))
    return convert.tube_state_from_params(p, tc)


# (real state, nominal state): "adopt" has both on the track, so the real
# solution is adopted; "refuse" puts the real state outside the annulus
# (crash costs), so the nominal system keeps its own solution
SCENARIOS = {"adopt": ([2.02, 0.05, -0.1, 1.9], [2.0, 0.0, 0.0, 2.0]),
             "refuse": ([2.6, 0.2, 0.5, 1.5], [2.0, 0.0, 0.0, 2.0])}


def _warm_state(jc, scenario):
    rng = np.random.default_rng(len(scenario))
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    return jc.init_state(jax.random.PRNGKey(0)).replace(
        control_mean=f32(rng.normal(scale=0.3, size=(T, C))),
        nominal_mean=f32(rng.normal(scale=0.3, size=(T, C))),
        nominal_state=f32(SCENARIOS[scenario][1]),
        control_history=f32(rng.normal(scale=0.3, size=(2, C))),
        nominal_initialized=jnp.bool_(True))


@pytest.fixture
def fresh_jit_cache():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("kernels", [("pallas", "fused"), ("combined", "combined")],
                         ids=["pallas", "combined"])
def test_tube_solve_matches_jax(kernels, scenario, monkeypatch, fresh_jit_cache):
    eps = np.random.default_rng(12).normal(size=(K, T, C)).astype(np.float32)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, mean, n, stride=0: jnp.asarray(eps))
    monkeypatch.setattr(j_ilqr, "_LADDER_INTERPRET", True)
    x = np.asarray(SCENARIOS[scenario][0], np.float32)
    jc = _jax_controller(kernels[0])
    js = _warm_state(jc, scenario)
    jres, jnew = jc.solve(jnp.asarray(x), js)

    tc = _port_of(jc, kernels[1])
    tres, tnew = tc.solve(_t(x), _port_state(js, tc), injected_noise=_t(eps))

    used = int(jres.nominal_state_used)
    assert used == (0 if scenario == "adopt" else 1)
    assert int(tres.nominal_state_used) == used
    # the acceptance must not hinge on a last-bit difference
    margin = float(jres.real.baseline) - float(jres.nominal.baseline) - THRESH
    assert abs(margin) > 1e-2
    for system in ("real", "nominal"):
        tr, jr = getattr(tres, system), getattr(jres, system)
        for field in ("control_mean", "costs", "baseline", "normalizer",
                      "state_trajectory", "output_trajectory"):
            _close(getattr(tr, field), getattr(jr, field), msg=f"{system}.{field}")
        # w = exp(-(J - baseline) / lambda) carries the costs' relative error
        # times |J| / lambda (crash terms make |J| reach hundreds)
        scale = float(np.max(np.abs(np.asarray(jr.costs)))) / LAM
        _close(tr.weights, jr.weights, rtol=RTOL * (1 + 2 * scale),
               msg=f"{system}.weights")
        assert np.array_equal(tr.crash.numpy(), np.asarray(jr.crash))
    for field in ("control_mean", "nominal_mean", "nominal_state",
                  "previous_baseline_real", "previous_baseline_nominal"):
        _close(getattr(tnew, field), getattr(jnew, field), msg=field)
    for field in ("gains", "x_traj", "u_traj", "total_cost"):
        _close(getattr(tnew.feedback_state, field),
               getattr(jnew.feedback_state, field), msg=f"feedback {field}")


@pytest.mark.parametrize("stride", [0, 1, 3])
def test_tube_slide_matches_jax(stride):
    jc = _jax_controller("pallas")
    js = _warm_state(jc, "adopt")
    tc = _port_of(jc, "fused")
    jn = jc.slide_control_sequence(js, stride)
    tn = tc.slide_control_sequence(_port_state(js, tc), stride)
    for field in ("control_mean", "nominal_mean", "nominal_state", "control_history"):
        _close(getattr(tn, field), getattr(jn, field), rtol=1e-6, atol=1e-7, msg=field)


def test_tube_systems_share_one_draw():
    """Without injected noise the two systems see the same standard
    normals: from the same state and mean, both iterations agree exactly
    (the published sequences differ: only the nominal one is smoothed)."""
    jc = _jax_controller("pallas")
    tc = _port_of(jc, "fused")
    state = tc.init_state(seed=3)
    x = torch.tensor([2.0, 0.0, 0.0, 2.0])
    state = state.replace(nominal_state=x.clone(), nominal_initialized=True)
    res, _ = tc.solve(x, state)
    for field in ("costs", "weights", "baseline", "normalizer"):
        assert torch.equal(getattr(res.real, field), getattr(res.nominal, field))


def test_tube_closed_loop_stays_on_the_track():
    """The bench configuration (bench.py:827-840) cut to K=512, T=32 on the
    CPU: 30 closed-loop steps inside the 1.5 < r < 2.5 band."""
    dyn = DoubleIntegratorDynamics.create()
    ctrl = TubeMPPI(
        dyn, DoubleIntegratorCircleCost(), GaussianDistribution.create(std_dev=[1.0, 1.0]),
        feedback=DDPFeedback.create(dyn, DT), dt=DT, lam=LAM, alpha=0.0,
        num_timesteps=32, num_rollouts=512, nominal_threshold=THRESH, device="cpu")
    cs = ctrl.init_state(seed=0)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0])
    for _ in range(30):
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        x, _ = ctrl.dynamics.step(x, res.real.control_mean[0], 0.0, ctrl.dt)
        assert 1.5 < float(torch.hypot(x[0], x[1])) < 2.5
    assert torch.isfinite(res.real.control_mean).all()
    assert torch.isfinite(cs.feedback_state.gains).all()
