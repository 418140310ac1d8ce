"""The robust controllers beyond the double integrator's circle cost, on
the CPU, against the JAX package on the same injected noise (the RNG
streams differ by design, docs/design.md section 6):

* one RMPPI cycle (``update_importance_sampling`` + ``solve``) on AutoRally
  with ``ARRobustCost`` on a 32^2 map where part of the samples crash
  (``bench.py:704-717`` cut to K=256, T=16, 9 candidates x 16 samples, the
  network at scale 1), the port's ``kernel="fused"`` against JAX
  ``kernel="pallas"`` with the DDP ladder kernel in interpret mode;
* one RMPPI cycle on the double integrator with ``DoubleIntegratorRobustCost``
  (the controller of tests/test_tube_robust.py:38-57 cut to K=256, T=24,
  9 x 64) from a real state off the nominal trajectory, with the value
  function threshold at 230 so that the candidates fall on both sides of
  it (their free energies are about 213-255 and, for the far ones, inf;
  the suite's 50 admits none of them here).

and ``kernel="fused_solve"``, which RMPPI runs as ``"fused"`` (the JAX
package's ``_equivalent_kernels``), to the last bit. Tube-MPPI's fused
solve on AutoRally is in ``test_torch_tube_fused_solve.py``.

Tolerances: costs rtol 2e-5 / atol 2e-4 on AutoRally (map products and the
network summed in other orders, as test_torch_autorally_kernels.py), rtol
1e-5 / atol 1e-5 on the double integrator; crash flags, the chosen
candidate and the stride exactly. Costs near 1e2-1e4 move a softmax weight
by 2 |dJ| / lambda, so the means are held to 2 max|dJ| / lambda times the
samples' spread plus 1e-5 (the rule of chip_smoke.py), the state
trajectories to T dt times that, the free energies to max|dJ| + 1e-5 and
the DDP gains, which track the re-rolled nominal trajectory, to rtol 1e-4 /
atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import RobustMPPI as JRobust
from mppi_generic_tpu.controllers import TubeMPPI as JTube
from mppi_generic_tpu.costs import ARRobustCost as JARRobust
from mppi_generic_tpu.costs import ARStandardCost as JARStandard
from mppi_generic_tpu.costs.double_integrator import DoubleIntegratorRobustCost as JRobustDI
from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.feedback import ilqr as j_ilqr
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.controllers.robust import RobustSolveResult
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import rollout_single
from test_torch_autorally import jax_cost_params, jax_dynamics_params
from test_torch_autorally_kernels import X0 as AR_X0
from test_torch_autorally_kernels import _jax_map, _setup

SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")
FEEDBACK_FIELDS = ("Q", "R", "Q_f", "dt", "num_iterations")
DT = 0.02


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(t, j, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


def _params(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


@pytest.fixture
def fresh_jit_cache():
    """Both packages' solves are jitted on the JAX side: a cached trace
    would ignore the patched noise and ladder flag, and the patched trace
    must not reach later tests."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patch_noise(monkeypatch, eps):
    """JAX draws ``eps[n]`` for a draw of n samples; the DDP ladder kernel
    runs in interpret mode (the port's plain ladder is its counterpart)."""
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, mean, n, stride=0: jnp.asarray(eps[n]))
    monkeypatch.setattr(j_ilqr, "_LADDER_INTERPRET", True)


def _mean_atol(tres, jres, U, lam):
    """2 max|dJ| / lambda times the samples' spread around the mean, + 1e-5."""
    dJ = float(np.max(np.abs(tres.costs.numpy() - np.asarray(jres.costs))))
    spread = float((U - tres.control_mean[None]).abs().max())
    return 2 * dJ / lam * spread + 1e-5, dJ


def _compare_system(tr, jr, U, lam, T, cost_tol, what):
    _close(tr.costs, jr.costs, *cost_tol, f"{what} costs")
    np.testing.assert_array_equal(tr.crash.numpy(), np.asarray(jr.crash))
    _close(tr.baseline, jr.baseline, *cost_tol, f"{what} baseline")
    atol, dJ = _mean_atol(tr, jr, U, lam)
    _close(tr.control_mean, jr.control_mean, 0, atol, f"{what} control_mean")
    _close(tr.state_trajectory, jr.state_trajectory, 0, T * DT * atol + 1e-5,
           f"{what} state_trajectory")
    return dJ


# --- RMPPI on AutoRally ------------------------------------------------------
K_AR, T_AR, N_CAND, S_PER = 256, 16, 9, 16


def _rmppi_autorally(port_kernel):
    (jdyn, _, jsamp), _ = _setup("32")
    jc = JRobust(dynamics=jdyn, cost=JARRobust(costmap=_jax_map("32")), sampler=jsamp,
                 dt=jnp.float32(DT), lam=jnp.float32(1.0), alpha=jnp.float32(0.0),
                 num_timesteps=T_AR, num_rollouts=K_AR, num_candidates=N_CAND,
                 samples_per_condition=S_PER, feedback=JDDP.create(jdyn, DT),
                 kernel="pallas")
    tc = convert.robust_from_params(
        jax_dynamics_params(jdyn), jax_cost_params(jc.cost), _params(jsamp, SAMPLER_FIELDS),
        dict(dt=DT, lam=1.0, alpha=0.0, num_timesteps=T_AR, num_rollouts=K_AR,
             num_iters=1, value_function_threshold=jc.value_function_threshold,
             num_candidates=N_CAND, samples_per_condition=S_PER),
        _params(jc.feedback, FEEDBACK_FIELDS), device="cpu", kernel=port_kernel,
        dynamics_kind="autorally", cost_kind="ar_robust")
    return jc, tc


def _robust_warm_state(jc, tc, x0, T, C, seed):
    """An initialized nominal system on the mean's trajectory from x0, so
    that stage 1 evaluates its candidates."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    nominal_mean = f32(0.2 * rng.normal(size=(T, C)))
    traj = rollout_single(tc.dynamics, _t(x0), _t(nominal_mean), tc.dt)[0][:-1].numpy()
    js = jc.init_state(jax.random.PRNGKey(0)).replace(
        control_mean=jnp.asarray(f32(0.2 * rng.normal(size=(T, C)))),
        nominal_mean=jnp.asarray(nominal_mean), nominal_state=jnp.asarray(traj[0]),
        nominal_traj=jnp.asarray(traj),
        control_history=jnp.asarray(f32(0.1 * rng.normal(size=(2, C)))),
        nominal_control_history=jnp.asarray(f32(0.1 * rng.normal(size=(2, C)))),
        nominal_initialized=jnp.bool_(True), best_index=jnp.int32(3),
        nominal_stride=jnp.int32(1))
    p = _params(js, ("control_mean", "nominal_mean", "nominal_state", "nominal_traj",
                     "control_history", "nominal_control_history",
                     "nominal_initialized", "previous_baseline_real",
                     "previous_baseline_nominal", "best_index", "nominal_stride"))
    p["feedback_state"] = _params(js.feedback_state,
                                  ("gains", "x_traj", "u_traj", "total_cost"))
    return js, convert.robust_state_from_params(p, tc), traj


def _rmppi_cycle(jc, tc, js, ts, x, eps):
    js1, jfe = jc.update_importance_sampling(jnp.asarray(x), js, 1)
    jres, jnew = jc.solve(jnp.asarray(x), js1)
    ts1, tfe = tc.update_importance_sampling(_t(x), ts, 1,
                                             injected_noise=_t(eps[tc.samples_per_condition]))
    tres, tnew = tc.solve(_t(x), ts1, injected_noise=_t(eps[tc.num_rollouts]))
    return (js1, jfe, jres, jnew), (ts1, tfe, tres, tnew)


def test_rmppi_autorally_matches_jax(monkeypatch, fresh_jit_cache, one_thread):
    rng = np.random.default_rng(31)
    eps = {n: rng.normal(size=(n, T_AR, 2)).astype(np.float32) for n in (S_PER, K_AR)}
    _patch_noise(monkeypatch, eps)
    jc, tc = _rmppi_autorally("fused")
    js, ts, traj = _robust_warm_state(jc, tc, AR_X0, T_AR, 2, 32)
    x = traj[1] + np.array([0.03, -0.02, 0.02, 0.0, 0.1, 0.02, 0.01], np.float32)
    (js1, jfe, jres, jnew), (ts1, tfe, tres, tnew) = _rmppi_cycle(jc, tc, js, ts, x, eps)

    # the default threshold (1e8) admits every candidate: the last, the real state
    assert int(ts1.best_index) == int(js1.best_index) == N_CAND - 1
    assert int(ts1.nominal_stride) == int(js1.nominal_stride)
    for field in ("nominal_state", "nominal_mean", "nominal_traj"):
        _close(getattr(ts1, field), getattr(js1, field), 1e-5, 1e-5, field)
    _close(ts1.feedback_state.gains, js1.feedback_state.gains, 1e-4, 1e-4, "gains")
    U = _t(eps[K_AR]) * tc.sampler.std_dev + ts1.nominal_mean  # the shared samples
    dJ = 0.0
    for system in ("real", "nominal"):
        dJ = max(dJ, _compare_system(getattr(tres, system), getattr(jres, system), U,
                                     1.0, T_AR, (2e-5, 2e-4), system))
    _close(tfe, jfe, 0, dJ + 1e-5, "candidate free energy")
    crashed = np.asarray(jres.real.crash)
    assert 0 < int(crashed.sum()) < K_AR  # the robust track term and the crash
    assert isinstance(tres, RobustSolveResult) and tres.candidate_free_energy is None
    assert jres.candidate_free_energy is None
    assert torch.isfinite(tnew.nominal_mean).all()


# --- RMPPI on the DI robust cost ---------------------------------------------
K_DI, T_DI, S_PER_DI, THRESH_DI = 256, 24, 64, 230.0


def test_rmppi_di_robust_matches_jax(monkeypatch, fresh_jit_cache):
    """The far candidates exceed the threshold, and the choice is the last
    one below it."""
    rng = np.random.default_rng(51)
    eps = {n: rng.normal(size=(n, T_DI, 2)).astype(np.float32) for n in (S_PER_DI, K_DI)}
    _patch_noise(monkeypatch, eps)
    jdyn = JDI.create()
    jc = JRobust(dynamics=jdyn, cost=JRobustDI(),
                 sampler=JGaussian.create(std_dev=[1.0, 1.0],
                                          control_cost_coeff=[0.01, 0.01]),
                 dt=jnp.float32(DT), lam=jnp.float32(1.0), alpha=jnp.float32(0.0),
                 num_timesteps=T_DI, num_rollouts=K_DI, num_candidates=9,
                 samples_per_condition=S_PER_DI,
                 value_function_threshold=jnp.float32(THRESH_DI),
                 feedback=JDDP.create(jdyn, DT), kernel="pallas")
    tc = convert.robust_from_params(
        _params(jdyn, ("control_ranges", "control_deadband", "zero_control",
                       "system_noise")),
        _params(jc.cost, DoubleIntegratorCircleCost.PARAM_NAMES),
        _params(jc.sampler, SAMPLER_FIELDS),
        dict(dt=DT, lam=1.0, alpha=0.0, num_timesteps=T_DI, num_rollouts=K_DI,
             num_iters=1, value_function_threshold=THRESH_DI, num_candidates=9,
             samples_per_condition=S_PER_DI),
        _params(jc.feedback, FEEDBACK_FIELDS), device="cpu", kernel="fused",
        cost_kind="di_robust")
    x0 = np.array([2.0, 0.0, 0.0, 2.0], np.float32)
    js, ts, traj = _robust_warm_state(jc, tc, x0, T_DI, 2, 52)
    x = traj[1] + np.array([0.35, 0.1, 0.4, -0.3], np.float32)
    (js1, jfe, jres, jnew), (ts1, tfe, tres, tnew) = _rmppi_cycle(jc, tc, js, ts, x, eps)

    jfe = np.asarray(jfe)
    assert (jfe < THRESH_DI).any() and (jfe > THRESH_DI).any()  # the threshold decides
    assert np.min(np.abs(jfe - THRESH_DI)) > 1e-2  # and not on a last-bit difference
    assert 0 < int(ts1.best_index) < 8
    assert int(ts1.best_index) == int(js1.best_index)
    assert int(ts1.nominal_stride) == int(js1.nominal_stride)
    _close(tfe, jfe, 1e-5, 1e-5, "candidate free energy")
    _close(ts1.feedback_state.gains, js1.feedback_state.gains, 1e-5, 1e-5, "gains")
    U = _t(eps[K_DI]) + ts1.nominal_mean
    for system in ("real", "nominal"):
        _compare_system(getattr(tres, system), getattr(jres, system), U, 1.0, T_DI,
                        (1e-5, 1e-5), system)
    _close(tnew.nominal_mean, jnew.nominal_mean, 1e-5, 1e-5, "new nominal mean")


def test_rmppi_fused_solve_runs_the_fused_path():
    """``kernel="fused_solve"`` is the same program as ``"fused"``."""
    jdyn = JDI.create()
    parts = (_params(jdyn, ("control_ranges", "control_deadband", "zero_control",
                            "system_noise")),
             _params(JRobustDI(), DoubleIntegratorCircleCost.PARAM_NAMES),
             _params(JGaussian.create(std_dev=[1.0, 1.0]), SAMPLER_FIELDS),
             dict(dt=DT, lam=1.0, alpha=0.0, num_timesteps=12, num_rollouts=64,
                  num_iters=1, value_function_threshold=THRESH_DI, num_candidates=3,
                  samples_per_condition=16),
             _params(JDDP.create(jdyn, DT), FEEDBACK_FIELDS))
    outs = []
    for kernel in ("fused", "fused_solve"):
        tc = convert.robust_from_params(*parts, device="cpu", kernel=kernel,
                                        cost_kind="di_robust")
        assert tc.kernel == "fused"
        x = torch.tensor([2.0, 0.0, 0.0, 2.0])
        cs = tc.init_state(seed=3)
        for _ in range(2):
            cs, fe = tc.update_importance_sampling(x, cs, 1)
            res, cs = tc.solve(x, cs)
        outs.append((fe, res.real.control_mean, res.nominal.costs))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
