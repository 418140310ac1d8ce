"""The split form of B1 and B3 for the pairs that gained it, on the CPU: the
plain versions of the port's split kernels (what the wrappers run on CPU
tensors) against the JAX package's split mode of the same kernels
(``split_cost=True``, its Pallas kernels in interpret mode) on the same
inputs, for the cartpole, the quadrotor with its quadratic cost, the double
integrator and the Dubins car with a fixed-goal ``QuadraticCost`` and the
bicycle slip with the AutoRally cost (its sticky crash by dual evaluation):
B1 in its costs mode for each (the cartpole in all four modes: costs,
costs + LR, the exp epilogue + LR, Tsallis pass 1 + LR) and B3 (Gaussian)
for each. Then B1's split form from one x0 per sample (RMPPI's candidates)
for the double integrator with its robust cost and for AutoRally, and one
RMPPI stage 1 + solve on the robust cost with the split forced, against
JAX's ``pallas_split_cost=True``. ``split_cost=True`` still raises
ValueError for the costs that declare neither ``time_parallel_cost`` nor
``time_parallel_crash``. The racer LSTM pairs are in
test_torch_split_racer.py, through ``check_split_b1`` and
``check_split_b3``.

Sizes: K = 128, T = 16 (B1) and T = 10 (B3), the pairs' configurations of
test_torch_sample_pairs.py (``pair_parts``). Tolerances: JAX's split pass
sums blocks of 8 steps, the port's chunks of ceil(T / 8), so the sums
differ in order: costs rtol 2e-5 / atol 1e-5 for the analytic pairs and
rtol 3e-5 / atol 3e-3 for the AutoRally family (test_torch_split_kernels.py:
costs up to 1e4); U rtol 1e-5 / atol 1e-6; crash flags exactly; new means,
baselines and eta rtol 2e-4 / atol 3e-3, widened by what the measured cost
differences move the weights (``_weight_slack``). Each split plain version
is also held against the port's combined plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import RobustMPPI as JRobust
from mppi_generic_tpu.costs.double_integrator import DoubleIntegratorRobustCost as JRobustDI
from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.ops.pallas_solve import fused_solve_iteration as jax_solve
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve
from test_torch_sample_pairs import AR_FAMILY, pair_parts, samplers
from test_torch_zoo import port_of, zoo_pair
from test_torch_zoo_kernels import _weight_slack

DT, LAM, ALPHA, STRIDE = 0.02, 1.2, 0.1, 2
GAMMA, R_TS = 10.0, 2.0
MODES = ("costs", "costs+lr", "epilogue+lr", "tsallis+lr")
TOL = {"analytic": (2e-5, 1e-5), "ar": (3e-5, 3e-3)}
B1_SHAPE, B3_SHAPE = (128, 16), (128, 10)


def _tol(name):
    return TOL["ar" if name in AR_FAMILY else "analytic"]


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rollout_inputs(name, K, T, seed=13):
    """Clamped samples around a mean and the LR tables of B1's cases."""
    jdyn, *_, std, off = pair_parts(name)
    C = jdyn.CONTROL_DIM
    rng = np.random.default_rng(seed)
    mean = (0.2 * rng.normal(size=(T, C)) + off).astype(np.float32)
    sigma = np.tile(np.asarray(std, np.float32)[None], (T, 1))
    U = (mean + sigma * rng.normal(size=(K, T, C))).astype(np.float32)
    U = np.asarray(jdyn.enforce_constraints(None, jnp.asarray(U).transpose(2, 0, 1))
                   ).transpose(1, 2, 0).copy()
    coeff = np.full((C,), 0.5, np.float32)
    thresh = float(np.float32(0.9) * np.float32(K))
    return U, (mean, sigma, coeff, LAM, ALPHA, thresh)


def check_split_b1(name, mode, K=None, T=None, x0=None):
    """B1's split plain version against JAX's split kernel in ``mode``, then
    against the port's combined plain version."""
    jdyn, jcost, dyn, cost, x0_pair, *_ = pair_parts(name)
    K, T = K or B1_SHAPE[0], T or B1_SHAPE[1]
    x0 = x0_pair if x0 is None else x0
    U, lr = rollout_inputs(name, K, T)
    with_lr = mode.endswith("+lr")
    jlr = (tuple(jnp.asarray(a) for a in lr[:3]) + tuple(jnp.float32(v) for v in lr[3:])
           if with_lr else None)
    tlr = tuple(torch.from_numpy(a) for a in lr[:3]) + lr[3:] if with_lr else None
    jx0, jU, tx0, tU = jnp.asarray(x0), jnp.asarray(U), torch.from_numpy(x0), torch.from_numpy(U)
    rtol, atol = _tol(name)
    if mode.startswith("costs"):
        jc, jcrash = pallas_rollout.fused_rollout_costs(
            jdyn, jcost, jx0, jU, DT, tile_k=128, lr_params=jlr, split_cost=True)
        tc, tcrash = fr.fused_rollout_costs(dyn, cost, tx0, tU, DT, lr_params=tlr,
                                            split_cost=True)
    else:
        kind = "exp" if mode.startswith("epilogue") else "tsallis"
        jout = pallas_rollout.fused_weighted_rollout(
            jdyn, jcost, jx0, jU, DT, LAM, lr_params=jlr, tile_k=128, split_cost=True,
            weight_kind=kind, weight_params=(GAMMA, R_TS))
        tout = fr.fused_weighted_rollout(dyn, cost, tx0, tU, DT, LAM, lr_params=tlr,
                                         weight_kind=kind, weight_params=(GAMMA, R_TS),
                                         split_cost=True)
        jc, jcrash, tc, tcrash = jout[0], jout[1], tout[0], tout[1]
        n = None
        if kind == "tsallis":  # the weighted samples; eta is their weight sum
            n = int(np.sum(np.asarray(jc) - float(jout[3]) < GAMMA))
        eta_rtol, mean_atol = _weight_slack(tc, jc, U, jout[2], GAMMA if n else LAM, n)
        if n is not None:
            eta_rtol = eta_rtol / float(jout[4])
        _close(tout[2], jout[2], 2e-4, max(3e-3, mean_atol), "new mean")
        _close(tout[3], jout[3], 2e-4, 3e-3, "baseline")
        _close(tout[4], jout[4], max(2e-4, eta_rtol), 3e-3, "eta")
    _close(tc, jc, rtol, atol, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    # the port's combined plain version on the same inputs
    cc, ccrash = fr.fused_rollout_costs(dyn, cost, tx0, tU, DT, lr_params=tlr,
                                        split_cost=False)
    assert torch.equal(ccrash, tcrash)
    _close(tc, cc, rtol, atol, "split vs combined costs")
    return tcrash


def check_split_b3(name, K=None, T=None):
    """B3's split plain version (Gaussian, 25 % pure noise) against JAX's
    split kernel, then against the port's combined plain version."""
    jdyn, jcost, dyn, cost, x0, *_ = pair_parts(name)
    K, T = K or B3_SHAPE[0], T or B3_SHAPE[1]
    jsamp, samp = samplers(name, "gaussian", 0.25, T)
    C = jdyn.CONTROL_DIM
    rng = np.random.default_rng(len(name))
    Z = rng.normal(size=(K, T, C)).astype(np.float32)
    mean = (0.2 * rng.normal(size=(T, C)) + pair_parts(name)[6]).astype(np.float32)
    jout = jax_solve(jdyn, jcost, jsamp, jnp.asarray(x0), jnp.asarray(mean), jnp.int32(0),
                     DT, LAM, ALPHA, K, optimization_stride=STRIDE, tile_k=128,
                     return_samples=True, injected_noise=jnp.asarray(Z), split_cost=True)
    args = (dyn, cost, samp, torch.from_numpy(x0), torch.from_numpy(mean), 0, DT, LAM,
            ALPHA, K)
    kw = dict(optimization_stride=STRIDE, return_samples=True,
              injected_noise=torch.from_numpy(Z))
    costs, crash, new_mean, baseline, eta, U = fused_solve.fused_solve_iteration(
        *args, split_cost=True, **kw)
    j_costs, j_crash, j_mean, j_base, j_eta, j_U = (np.asarray(a) for a in jout)
    rtol, atol = _tol(name)
    _close(U, j_U, 1e-5, 1e-6, "U")
    _close(costs, j_costs, rtol, atol, "costs")
    np.testing.assert_array_equal(crash.numpy(), j_crash)
    eta_rtol, mean_atol = _weight_slack(costs, j_costs, j_U, j_mean, LAM)
    _close(baseline, j_base, 2e-4, 3e-3, "baseline")
    _close(eta, j_eta, max(2e-4, eta_rtol), 3e-3, "eta")
    _close(new_mean, j_mean, 2e-4, max(3e-3, mean_atol), "new mean")
    comb = fused_solve.fused_solve_iteration(*args, split_cost=False, **kw)
    assert torch.equal(comb[5], U) and torch.equal(comb[1], crash)
    _close(costs, comb[0], rtol, atol, "split vs combined costs")


SPLIT_ANALYTIC = ("cartpole", "quadrotor_quadratic", "di_quadratic", "dubins_quadratic")
B1_CASES = ([("cartpole", mode) for mode in MODES]
            + [(name, "costs") for name in SPLIT_ANALYTIC[1:] + ("bicycle_ar",)])


@pytest.mark.parametrize("name,mode", B1_CASES)
def test_b1_split_plain_matches_jax_split(name, mode, one_thread):
    crash = check_split_b1(name, mode)
    if name == "bicycle_ar":
        assert 0 < int(crash.sum()) < crash.numel()  # a mixed crash population


@pytest.mark.parametrize("name", SPLIT_ANALYTIC + ("bicycle_ar",))
def test_b3_split_plain_matches_jax_split(name, one_thread):
    check_split_b3(name)


def _candidates(x_a, x_b, n, s_per):
    """n candidate states on the segment x_a -> x_b, each repeated for its
    s_per samples: RMPPI's stage-1 layout (K, S)."""
    w = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
    return np.repeat((1 - w) * x_a + w * x_b, s_per, axis=0).astype(np.float32)


@pytest.mark.parametrize("name", ["di_robust", "ar_nn"])
def test_b1_x0_split_plain_matches_jax_split(name, one_thread):
    """9 candidates x 16 samples, each sample from its candidate's x0: the
    split form against JAX's per-sample-x0 split and the port's combined
    plain version."""
    jdyn, jcost, dyn, cost, x0, *_ = pair_parts(name)
    x_b = x0 + (np.array([0.4, 0.2, 0.3, -0.4], np.float32) if name == "di_robust"
                else np.array([0.5, 0.3, 0.1, 0.0, -0.5, 0.0, 0.0], np.float32))
    X0 = _candidates(x0, x_b, 9, 16)
    U, _ = rollout_inputs(name, X0.shape[0], B1_SHAPE[1])
    jc, jcrash = pallas_rollout.fused_rollout_costs(jdyn, jcost, jnp.asarray(X0),
                                                    jnp.asarray(U), DT, split_cost=True)
    tX0, tU = torch.from_numpy(X0), torch.from_numpy(U)
    tc, tcrash = fr.fused_rollout_costs(dyn, cost, tX0, tU, DT, split_cost=True)
    rtol, atol = _tol(name)
    _close(tc, jc, rtol, atol, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    cc, ccrash = fr.fused_rollout_costs(dyn, cost, tX0, tU, DT, split_cost=False)
    assert torch.equal(ccrash, tcrash)
    _close(tc, cc, rtol, atol, "split vs combined costs")
    if name == "ar_nn":
        assert 0 < int(tcrash.sum()) < tcrash.numel()  # a mixed crash population
    else:  # the barrier and the off-track penalty both ran
        assert float(tc.max()) > float(cost.crash_cost) / B1_SHAPE[1] > float(tc.min())
    assert fr._entry(dyn, cost, "split_dynamics_x0")[1] == f"split_dynamics_x0_{name}"


K_DI, T_DI, S_PER_DI, THRESH_DI = 256, 24, 64, 230.0


def test_rmppi_stage1_split_matches_jax(monkeypatch, one_thread):
    """One RMPPI cycle on the DI robust cost (the configuration of
    test_torch_robust_family_solve.py) with stage 1's split forced in both
    packages: the candidates' free energies, the choice and both systems'
    solves agree."""
    from test_torch_robust_family_solve import (
        FEEDBACK_FIELDS,
        SAMPLER_FIELDS,
        _compare_system,
        _params,
        _patch_noise,
        _rmppi_cycle,
        _robust_warm_state,
    )
    jax.clear_caches()
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
                 feedback=JDDP.create(jdyn, DT), kernel="pallas", pallas_split_cost=True)
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
    tc.split_cost = True
    x0 = np.array([2.0, 0.0, 0.0, 2.0], np.float32)
    js, ts, traj = _robust_warm_state(jc, tc, x0, T_DI, 2, 52)
    x = traj[1] + np.array([0.35, 0.1, 0.4, -0.3], np.float32)
    try:
        (js1, jfe, jres, jnew), (ts1, tfe, tres, tnew) = _rmppi_cycle(jc, tc, js, ts, x, eps)
    finally:
        jax.clear_caches()
    jfe = np.asarray(jfe)
    assert (jfe < THRESH_DI).any() and (jfe > THRESH_DI).any()  # the threshold decides
    assert int(ts1.best_index) == int(js1.best_index)
    assert int(ts1.nominal_stride) == int(js1.nominal_stride)
    _close(tfe, jfe, 2e-5, 1e-4, "candidate free energy")
    U = torch.from_numpy(eps[K_DI]) + ts1.nominal_mean
    for system in ("real", "nominal"):
        _compare_system(getattr(tres, system), getattr(jres, system), U, 1.0, T_DI,
                        (2e-5, 1e-4), system)
    _close(tnew.nominal_mean, jnew.nominal_mean, 1e-5, 1e-4, "new nominal mean")


def test_split_still_refuses_ineligible_costs():
    """``QuadrotorMapCost`` and a ``QuadraticCost`` goal trajectory declare
    neither time_parallel_cost nor time_parallel_crash: split_cost=True
    raises ValueError on every device, as in JAX (costs/quadratic.py:38-41),
    and AUTO keeps them combined."""
    for name in ("quadrotor_map", "dubins_trajectory"):
        dyn, cost = port_of(*zoo_pair(name)[:2])
        with pytest.raises(ValueError, match="time_parallel"):
            fr.resolve_split(dyn, cost, True)
        assert not fr.resolve_split(dyn, cost, None)
        K, T = 64, 8
        U = torch.zeros((K, T, dyn.CONTROL_DIM))
        with pytest.raises(ValueError, match="time_parallel"):
            fr.fused_rollout_costs(dyn, cost, torch.from_numpy(zoo_pair(name)[2]), U, DT,
                                   split_cost=True)
