"""The RMPPI path of the port against the JAX package: the RMPPI rollout
and the per-sample-x0 rollout (the plain versions of the port's CUDA
kernels, which the wrappers run for CPU tensors) against the JAX package's
Pallas kernels in interpret mode; the line-search weights, the feedback
cost and the device-stride history update; one full
``update_importance_sampling`` + ``solve`` against the JAX controller with
``kernel="pallas"`` and ``"combined"`` on the same injected noise; and a
short CPU closed loop.

Tolerances: rtol 1e-5 / atol 1e-5 (the two sides sum the likelihood and
free-energy terms in another order); crash flags, the best candidate and
the nominal stride exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import RobustMPPI as JRobust
from mppi_generic_tpu.controllers.robust import line_search_weights as j_lsw
from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.feedback import ilqr as j_ilqr
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.utils import math_utils as j_math
from mppi_generic_tpu_torch import DDPFeedback, GaussianDistribution, RobustMPPI, convert
from mppi_generic_tpu_torch.controllers.robust import line_search_weights
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.utils import math_utils

K, T, C, S = 256, 16, 2, 4
N_CAND, S_PER = 9, 16
DT, LAM, THRESH = 0.02, 2.0, 20.0
RTOL = ATOL = 1e-5
CONSTRAINTS = dict(control_ranges=[[-2.5, 2.5], [-2.0, 2.0]],
                   control_deadband=[0.05, 0.1])


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(t, j, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("n", [3, 5, 9])
def test_line_search_weights_match_jax(n):
    assert np.array_equal(line_search_weights(n), np.asarray(j_lsw(n)))


@pytest.mark.parametrize("stride", [0, 1, 2, 5])
def test_history_and_slide_take_a_device_stride(stride):
    rng = np.random.default_rng(stride)
    hist = rng.normal(size=(2, C)).astype(np.float32)
    seq = rng.normal(size=(T, C)).astype(np.float32)
    want_h = j_math.update_control_history(jnp.asarray(hist), jnp.asarray(seq),
                                           jnp.int32(stride))
    want_s = j_math.slide_control_sequence(jnp.asarray(seq), jnp.int32(stride))
    for s in (stride, torch.tensor(stride)):
        _close(math_utils.update_control_history(_t(hist), _t(seq), s), want_h,
               rtol=0, atol=0)
        _close(math_utils.slide_control_sequence(_t(seq), s), want_s, rtol=0, atol=0)


@pytest.mark.parametrize("time_specific", [False, True])
def test_feedback_cost_matches_jax(time_specific):
    rng = np.random.default_rng(3)
    std = (rng.uniform(0.5, 1.5, size=(T, C)) if time_specific
           else np.array([1.0, 0.8])).astype(np.float32)
    coeff = np.array([0.02, 0.5], np.float32)
    u_fb = rng.normal(size=(K, T, C)).astype(np.float32)
    js = JGaussian.create(std_dev=std, control_cost_coeff=coeff)
    ts = GaussianDistribution.create(std_dev=std, control_cost_coeff=coeff)
    _close(ts.feedback_cost(_t(u_fb), 1.3, 0.1),
           js.feedback_cost(jnp.asarray(u_fb), 1.3, 0.1))
    step = u_fb[:, 5].T  # (C, K)
    _close(ts.feedback_cost_step(_t(step), 5, 1.3, 0.1),
           js.feedback_cost_step(jnp.asarray(step), 5, 1.3, 0.1))


@pytest.mark.parametrize("K_", [256, 200])
def test_rmppi_rollout_plain_matches_pallas(K_):
    """Ragged K=200 pads the TPU kernel's 128-sample tile."""
    rng = np.random.default_rng(K_)
    x_nom = np.array([2.0, 0.0, 0.0, 1.0], np.float32)
    x_real = np.array([2.15, -0.05, 0.1, 0.9], np.float32)
    U = (1.2 * rng.normal(size=(K_, T, C))).astype(np.float32)
    gains = (-0.8 * rng.uniform(size=(T, C, S))).astype(np.float32)
    sigma = rng.uniform(0.6, 1.4, size=(T, C)).astype(np.float32)
    coeff = np.array([0.02, 0.5], np.float32)
    jout = pallas_rollout.fused_rmppi_rollout(
        JDI.create(**CONSTRAINTS), JCircle(), jnp.asarray(x_nom),
        jnp.asarray(x_real), jnp.asarray(U), jnp.asarray(gains),
        jnp.asarray(sigma), jnp.asarray(coeff), jnp.float32(DT), 1.3, 0.1,
        interpret=True)
    fr.reset_launch_counts()
    tout = fr.fused_rmppi_rollout(
        DoubleIntegratorDynamics.create(**CONSTRAINTS), DoubleIntegratorCircleCost(),
        _t(x_nom), _t(x_real), _t(U), _t(gains), _t(sigma), _t(coeff), DT, 1.3, 0.1)
    for name, t, j in zip(("s_nom", "j_real", "s_fb"), tout[:3], jout[:3]):
        _close(t, j, msg=name)
    assert np.array_equal(tout[3].numpy(), np.asarray(jout[3]))
    _close(tout[4], jout[4], atol=1e-6, msg="U_real")
    assert fr.launch_counts["rmppi_rollout_kernel"] == 0  # CPU: no launch


@pytest.mark.parametrize("K_", [N_CAND * S_PER, 256])
def test_rollout_costs_per_sample_x0_matches_pallas(K_):
    rng = np.random.default_rng(K_ + 1)
    x0 = (np.array([2.0, 0.0, 0.0, 1.0]) + 0.3 * rng.normal(size=(K_, S))
          ).astype(np.float32)
    U = rng.normal(size=(K_, T, C)).astype(np.float32)
    jc, jcrash = pallas_rollout.fused_rollout_costs(
        JDI.create(), JCircle(), jnp.asarray(x0), jnp.asarray(U), DT)
    tc, tcrash = fr.fused_rollout_costs(
        DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(), _t(x0),
        _t(U), DT)
    _close(tc, jc, atol=1e-6)
    assert np.array_equal(tcrash.numpy(), np.asarray(jcrash))


# --- the whole RMPPI path ------------------------------------------------
def _jax_controller(kernel):
    dyn = JDI.create()
    return JRobust(
        dynamics=dyn, cost=JCircle(),
        sampler=JGaussian.create(std_dev=[1.0, 0.8], control_cost_coeff=[0.5, 1.0]),
        dt=jnp.float32(DT), lam=jnp.float32(LAM), alpha=jnp.float32(0.0),
        num_timesteps=T, num_rollouts=K, num_candidates=N_CAND,
        samples_per_condition=S_PER, value_function_threshold=jnp.float32(THRESH),
        feedback=JDDP.create(dyn, DT), kernel=kernel)


def _params(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def _port_of(jc, kernel):
    return convert.robust_from_params(
        _params(jc.dynamics, ("control_ranges", "control_deadband",
                              "zero_control", "system_noise")),
        _params(jc.cost, DoubleIntegratorCircleCost.PARAM_NAMES),
        _params(jc.sampler, ("std_dev", "control_cost_coeff",
                             "pure_noise_percentage", "std_dev_decay")),
        dict(dt=jc.dt, lam=jc.lam, alpha=jc.alpha, num_timesteps=T,
             num_rollouts=K, num_iters=jc.num_iters,
             value_function_threshold=jc.value_function_threshold,
             num_candidates=N_CAND, samples_per_condition=S_PER),
        _params(jc.feedback, ("Q", "R", "Q_f", "dt", "num_iterations")),
        device="cpu", kernel=kernel)


_STATE_FIELDS = ("control_mean", "nominal_mean", "nominal_state", "nominal_traj",
                 "control_history", "nominal_control_history", "nominal_initialized",
                 "previous_baseline_real", "previous_baseline_nominal",
                 "best_index", "nominal_stride")


def _port_state(js, tc):
    p = _params(js, _STATE_FIELDS)
    p["feedback_state"] = _params(js.feedback_state,
                                  ("gains", "x_traj", "u_traj", "total_cost"))
    return convert.robust_state_from_params(p, tc)


# real state per scenario; the nominal trajectory runs on the circle from
# [2, 0, 0, 2]. "first" is the first call (no candidate evaluation);
# "on_track" puts every candidate below the threshold, "off_track" (real
# state outside the annulus) only those near the nominal state
SCENARIOS = {"first": [2.0, 0.05, -0.1, 1.9], "on_track": [1.98, 0.08, -0.1, 1.9],
             "off_track": [2.45, 0.3, 0.6, 1.2]}


def _warm_state(jc, scenario):
    rng = np.random.default_rng(len(scenario))
    js = jc.init_state(jax.random.PRNGKey(0))
    if scenario == "first":
        return js
    ang = 2.0 * DT * np.arange(T) / 2.0
    traj = np.stack([2 * np.cos(ang), 2 * np.sin(ang), -2 * np.sin(ang),
                     2 * np.cos(ang)], axis=1).astype(np.float32)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    return js.replace(
        control_mean=f32(rng.normal(scale=0.3, size=(T, C))),
        nominal_mean=f32(rng.normal(scale=0.3, size=(T, C))),
        nominal_state=f32(traj[0]), nominal_traj=f32(traj),
        control_history=f32(rng.normal(scale=0.3, size=(2, C))),
        nominal_control_history=f32(rng.normal(scale=0.3, size=(2, C))),
        nominal_initialized=jnp.bool_(True), best_index=jnp.int32(3),
        nominal_stride=jnp.int32(1))


@pytest.fixture
def fresh_jit_cache():
    """Both stages are jitted: a cached trace would ignore the patched
    noise and ladder flag, and the patched trace must not reach later
    tests."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("kernels", [("pallas", "fused"), ("combined", "combined")],
                         ids=["pallas", "combined"])
def test_rmppi_matches_jax(kernels, scenario, monkeypatch, fresh_jit_cache):
    rng = np.random.default_rng(11)
    eps = {n: rng.normal(size=(n, T, C)).astype(np.float32) for n in (S_PER, K)}
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, mean, n, stride=0: jnp.asarray(eps[n]))
    # the JAX package runs its DDP ladder kernel (interpret mode) off the
    # TPU only with this flag; the port's use_kernel path is its counterpart
    monkeypatch.setattr(j_ilqr, "_LADDER_INTERPRET", True)
    x = np.asarray(SCENARIOS[scenario], np.float32)
    jc = _jax_controller(kernels[0])
    js = _warm_state(jc, scenario)
    js1, jfe = jc.update_importance_sampling(jnp.asarray(x), js, 1)
    jres, jnew = jc.solve(jnp.asarray(x), js1)

    tc = _port_of(jc, kernels[1])
    ts = _port_state(js, tc)
    ts1, tfe = tc.update_importance_sampling(_t(x), ts, 1,
                                             injected_noise=_t(eps[S_PER]))
    tres, tnew = tc.solve(_t(x), ts1, injected_noise=_t(eps[K]))

    if scenario == "first":
        assert int(ts1.best_index) == 0 and int(ts1.nominal_stride) == 0
    else:
        # the chosen candidate must not hinge on a last-bit difference
        assert np.min(np.abs(np.asarray(jfe) - THRESH)) > 1e-2
        _close(tfe, jfe, msg="candidate free energy")
    assert int(ts1.best_index) == int(js1.best_index)
    assert int(ts1.nominal_stride) == int(js1.nominal_stride)
    for field in ("nominal_state", "nominal_mean", "nominal_traj",
                  "nominal_control_history", "control_history"):
        _close(getattr(ts1, field), getattr(js1, field), msg=field)
    _close(ts1.feedback_state.gains, js1.feedback_state.gains, msg="gains")
    for system in ("real", "nominal"):
        tr, jr = getattr(tres, system), getattr(jres, system)
        for field in ("control_mean", "costs", "baseline", "normalizer",
                      "state_trajectory"):
            _close(getattr(tr, field), getattr(jr, field), msg=f"{system}.{field}")
        # w = exp(-(J - baseline) / lambda) carries the costs' relative error
        # times |J| / lambda (crash terms make |J| reach hundreds)
        scale = float(np.max(np.abs(np.asarray(jr.costs)))) / LAM
        _close(tr.weights, jr.weights, rtol=RTOL * (1 + 2 * scale),
               msg=f"{system}.weights")
        assert np.array_equal(tr.crash.numpy(), np.asarray(jr.crash))
    _close(tnew.control_mean, jnew.control_mean)
    _close(tnew.nominal_mean, jnew.nominal_mean)
    assert int(tres.best_index) == int(jres.best_index)
    _close(tc.compute_df(tres), jc.compute_df(jres))


def test_rmppi_fused_matches_combined():
    jc = _jax_controller("pallas")
    fused, combined = _port_of(jc, "fused"), _port_of(jc, "combined")
    js = _warm_state(jc, "off_track")
    x = _t(SCENARIOS["off_track"])
    g = torch.Generator().manual_seed(4)
    e1, e2 = torch.randn((S_PER, T, C), generator=g), torch.randn((K, T, C), generator=g)
    outs = []
    for ctrl in (fused, combined):
        s1, fe = ctrl.update_importance_sampling(x, _port_state(js, ctrl), 1,
                                                 injected_noise=e1)
        res, _ = ctrl.solve(x, s1, injected_noise=e2)
        outs.append((s1, fe, res))
    (sf, fef, rf), (sc, fec, rc) = outs
    assert int(sf.best_index) == int(sc.best_index)
    _close(fef, fec)
    _close(sf.feedback_state.gains, sc.feedback_state.gains, rtol=0, atol=0)
    for system in ("real", "nominal"):
        for field in ("control_mean", "costs", "baseline"):
            _close(getattr(getattr(rf, system), field),
                   getattr(getattr(rc, system), field), msg=f"{system}.{field}")


def test_rmppi_closed_loop_stays_on_the_track():
    """The bench configuration (bench.py:809-825) cut to K=512, T=32, 9 x 32
    on the CPU: 30 closed-loop steps inside the 1.5 < r < 2.5 band."""
    dyn = DoubleIntegratorDynamics.create()
    ctrl = RobustMPPI(
        dyn, DoubleIntegratorCircleCost(), GaussianDistribution.create(std_dev=[1.0, 1.0]),
        feedback=DDPFeedback.create(dyn, DT), dt=DT, lam=LAM, alpha=0.0,
        num_timesteps=32, num_rollouts=512, num_candidates=9,
        samples_per_condition=32, value_function_threshold=THRESH, device="cpu")
    cs = ctrl.init_state(seed=0)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0])
    for _ in range(30):
        cs, fe = ctrl.update_importance_sampling(x, cs, 1)
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        x, _ = ctrl.dynamics.step(x, res.real.control_mean[0], 0.0, ctrl.dt)
        assert 1.5 < float(torch.hypot(x[0], x[1])) < 2.5
    assert torch.isfinite(res.real.control_mean).all() and torch.isfinite(fe).all()
    assert cs.nominal_initialized and cs.best_index.dtype == torch.int64
