"""The split form's eager side in the port against the JAX package, on the
CPU: the costs' split declarations, ``rollout_outputs`` and
``trajectory_state_costs`` (a sequential, a time-parallel and a batched
crash pass), one ``kernel="split"`` iteration of ``VanillaMPPI`` and of
``TubeMPPI`` on the same injected noise, and the refusal of
``split_cost=True`` for a cost that declares neither form.

The double integrator runs at K=256, T=24; AutoRally at K=128, T=24: the
6-32-32-4 network at scale 0.5 (JAX key 0, as the other AutoRally tests
draw it) from a rolling start at x = 2.65, v_x = 4, on the 32 x 32
stripe map of tests/test_pallas_fused.py:294-306 (boundary at world
x >= 5), where about half the samples cross the stripe late in the horizon.

Tolerances: outputs rtol 1e-5 / atol 1e-5 (the eager network's matmul and
XLA's dot sum in other orders); costs rtol 1e-5 / atol 1e-5 for the double
integrator, rtol 2e-5 / atol 2e-4 for AutoRally (as
tests/test_torch_autorally_kernels.py); crash flags exactly; the solves as
tests/test_torch_vanilla.py and tests/test_torch_tube.py hold them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu import costs as jcosts
from mppi_generic_tpu.costs.base import Cost as JCost
from mppi_generic_tpu.feedback import ilqr as j_ilqr
from mppi_generic_tpu.maps.texture import MapTexture2D as JTex
from mppi_generic_tpu.models import AutorallyNNDynamics as JAutorally
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.nn.fnn import FNN as JFNN
from mppi_generic_tpu.ops import rollout as jrollout
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu_torch import convert, costs
from mppi_generic_tpu_torch.costs.base import Cost
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve
from mppi_generic_tpu_torch.ops import rollout as trollout
from test_torch_autorally import jax_cost_params, jax_dynamics_params

DT = 0.02
AR_K, AR_T = 128, 24
AR_X0 = np.array([2.65, 0.0, 0.0, 0.0, 4.0, 0.0, 0.0], np.float32)
DI_K, DI_T = 256, 24
DI_X0 = np.array([2.0, 0.05, -0.1, 1.0], np.float32)

# (port cost, JAX cost) with default parameters: the declarations are
# properties of the class (and of QuadraticCost's goal form)
COSTS = {
    "di_circle": (lambda: costs.DoubleIntegratorCircleCost(),
                  lambda: jcosts.DoubleIntegratorCircleCost()),
    "di_robust": (lambda: costs.DoubleIntegratorRobustCost(),
                  lambda: jcosts.DoubleIntegratorRobustCost()),
    "quadratic_goal": (lambda: costs.QuadraticCost(np.zeros(4)),
                       lambda: jcosts.QuadraticCost.create(goal=jnp.zeros(4))),
    "quadratic_trajectory": (lambda: costs.QuadraticCost(np.zeros((7, 4))),
                             lambda: jcosts.QuadraticCost.create(goal=jnp.zeros((7, 4)))),
    "cartpole": (lambda: costs.CartpoleQuadraticCost(),
                 lambda: jcosts.CartpoleQuadraticCost()),
    "quadrotor_quadratic": (lambda: costs.QuadrotorQuadraticCost(),
                            lambda: jcosts.QuadrotorQuadraticCost()),
    "quadrotor_map": (lambda: costs.QuadrotorMapCost(),
                      lambda: jcosts.QuadrotorMapCost()),
    "ar_standard": (lambda: costs.ARStandardCost(), lambda: jcosts.ARStandardCost()),
    "ar_robust": (lambda: costs.ARRobustCost(), lambda: jcosts.ARRobustCost()),
    "base": (Cost, JCost),
}


@pytest.fixture
def one_thread():
    """Thousands of small operations per solve: one intra-op thread, so the
    suite's parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_jit_cache():
    """solve is jitted: a cached trace would ignore the patched noise, and
    the patched trace must not reach later tests."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", sorted(COSTS))
def test_cost_declarations_match_jax(name):
    port, jax_cost = (make() for make in COSTS[name])
    assert port.time_parallel_cost() == jax_cost.time_parallel_cost()
    assert port.time_parallel_crash() == jax_cost.time_parallel_crash()
    assert fr.split_eligible(port) == (jax_cost.time_parallel_cost()
                                       or jax_cost.time_parallel_crash())


# (cost, O, C) of each eligible cost, evaluated over a leading time axis
ELIGIBLE = {"di_circle": (4, 2), "di_robust": (4, 2), "quadratic_goal": (4, 2),
            "cartpole": (4, 1), "quadrotor_quadratic": (13, 4), "ar_standard": (7, 2),
            "ar_robust": (7, 2)}


@pytest.mark.parametrize("name", sorted(ELIGIBLE))
def test_eligible_costs_take_a_time_axis(name):
    """An eligible cost evaluated on (O, Tc, K) blocks with a (Tc, 1) float t
    equals its evaluation one step at a time (JAX
    test_time_parallel_cost_declarations): bit for bit, the same
    elementwise operations."""
    cost = COSTS[name][0]()
    O, C = ELIGIBLE[name]
    rng = np.random.default_rng(len(name))
    Tc, K = 6, 5
    y = torch.from_numpy(rng.normal(size=(O, Tc, K)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(C, Tc, K)).astype(np.float32))
    t = torch.arange(Tc, dtype=torch.float32)[:, None]
    zero = torch.zeros((), dtype=torch.int32)
    c_vec, crash_vec = cost.running_cost(y, u, t, zero)
    for i in range(Tc):
        c_i, crash_i = cost.running_cost(y[:, i], u[:, i], i, torch.zeros((K,), dtype=torch.int32))
        assert torch.equal(c_vec.expand(Tc, K)[i], c_i.expand(K))
        assert torch.equal(torch.as_tensor(crash_vec).expand(Tc, K)[i], crash_i.expand(K))


@functools.lru_cache(maxsize=None)
def _stripe_map():
    data = np.zeros((32, 32), np.float32)
    data[:, 21:] = 1.0  # the boundary stripe at world x >= 5
    return JTex.create(data, origin=(-16, -16, 0), resolution=1.0)


def _pair(kind):
    """(JAX dynamics, JAX cost, port dynamics, port cost, x0, K, T, std)."""
    if kind == "di":
        jd, jc = JDI.create(), jcosts.DoubleIntegratorCircleCost()
        return (jd, jc, convert.double_integrator_from_params(
                    {n: np.asarray(getattr(jd, n)) for n in
                     ("control_ranges", "control_deadband", "zero_control", "system_noise")}),
                costs.DoubleIntegratorCircleCost(), DI_X0, DI_K, DI_T, (1.0, 0.8))
    jd = JAutorally.create(nn=JFNN.create([6, 32, 32, 4], key=jax.random.PRNGKey(0), scale=0.5),
                           control_ranges=[[-0.9, 0.9], [-0.6, 1.0]])
    jc = jcosts.ARStandardCost(costmap=_stripe_map())
    return (jd, jc, convert.autorally_from_params(jax_dynamics_params(jd)),
            convert.ar_cost_from_params(jax_cost_params(jc)), AR_X0, AR_K, AR_T, (0.3, 0.5))


def _controls(K, T, std, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(K, T, 2)) * np.asarray(std)
    return np.clip(U, -0.9, 0.9).astype(np.float32)


def _tol(kind):
    return (2e-5, 2e-4) if kind == "ar" else (1e-5, 1e-5)


@pytest.mark.parametrize("kind", ["di", "ar"])
def test_rollout_outputs_match_jax(kind, one_thread):
    jd, _, td, tc, x0, K, T, std = _pair(kind)
    U = _controls(K, T, std)
    jY = jrollout.rollout_outputs(jd, jnp.asarray(x0), jnp.asarray(U), DT)
    tY = trollout.rollout_outputs(td, torch.from_numpy(x0), torch.from_numpy(U), DT)
    assert tY.shape == (K, T, td.OUTPUT_DIM)
    np.testing.assert_allclose(tY.numpy(), np.asarray(jY), rtol=1e-5, atol=1e-5)
    # the combined rollout's outputs are the same trajectory
    _, tY_comb, _ = trollout.rollout_combined(td, tc, torch.from_numpy(x0),
                                              torch.from_numpy(U), DT)
    assert torch.equal(tY, tY_comb)


@pytest.mark.parametrize("kind", ["di", "ar"])
@pytest.mark.parametrize("mode", ["sequential", "parallel", "batched"])
def test_trajectory_state_costs_match_jax(kind, mode, one_thread):
    """The cost pass on the same outputs (JAX's), against JAX's, and
    against the port's combined rollout."""
    jd, jc, td, tc, x0, K, T, std = _pair(kind)
    U = _controls(K, T, std)
    Y = np.array(jrollout.rollout_outputs(jd, jnp.asarray(x0), jnp.asarray(U), DT))
    kw = dict(sequential_crash=mode != "parallel", batched_crash=mode == "batched")
    j_costs, j_crash = jrollout.trajectory_state_costs(jc, jnp.asarray(Y), jnp.asarray(U), **kw)
    t_costs, t_crash = trollout.trajectory_state_costs(tc, torch.from_numpy(Y),
                                                       torch.from_numpy(U), **kw)
    rtol, atol = _tol(kind)
    np.testing.assert_allclose(t_costs.numpy(), np.asarray(j_costs), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(t_crash.numpy(), np.asarray(j_crash))
    if kind == "ar" and mode != "parallel":
        assert 0 < int(t_crash.sum()) < K  # a mixed crash population
        comb, _, comb_crash = trollout.rollout_combined(td, tc, torch.from_numpy(x0),
                                                        torch.from_numpy(U), DT)
        assert torch.equal(comb_crash, t_crash)
        np.testing.assert_allclose(t_costs.numpy(), comb.numpy(), rtol=rtol, atol=atol)


def _vanilla_split_solve(monkeypatch, name):
    from test_torch_vanilla import CONFIGS, X0, _jax_controller, _params, _port_of, _warm_state
    from test_torch_vanilla import C as VC
    from test_torch_vanilla import K as VK
    from test_torch_vanilla import T as VT

    cfg = CONFIGS[name]
    eps = np.random.default_rng(17).normal(size=(VK, VT, VC)).astype(np.float32)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, mean, n, stride=0: jnp.asarray(eps))
    jc = _jax_controller(cfg, kernel="split")
    js = _warm_state(jc)
    jres, jnew = jc.solve(jnp.asarray(X0), js, cfg["stride"])
    tc = _port_of(jc, kernel="split")
    ts = convert.state_from_params(
        _params(js, ("control_mean", "control_history", "previous_baseline")), tc)
    tres, tnew = tc.solve(torch.from_numpy(X0), ts, cfg["stride"],
                          injected_noise=torch.from_numpy(eps))
    return jres, jnew, tres, tnew


@pytest.mark.parametrize("name", ["flagship", "carveouts"])
def test_vanilla_split_matches_jax(name, monkeypatch, fresh_jit_cache, one_thread):
    """One kernel="split" solve (JAX tests/test_vanilla_mppi.py:66) against
    JAX's on the same noise: rtol 1e-5 / atol 1e-5 as the fused solve."""
    jres, jnew, tres, tnew = _vanilla_split_solve(monkeypatch, name)

    def close(t, j, rtol=1e-5, atol=1e-5):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)

    for field in ("control_mean", "costs", "weights", "baseline", "normalizer",
                  "state_trajectory", "output_trajectory"):
        close(getattr(tres, field), getattr(jres, field))
    assert np.array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    close(tnew.control_mean, jnew.control_mean)


@pytest.mark.parametrize("scenario", ["adopt", "refuse"])
def test_tube_split_matches_jax(scenario, monkeypatch, fresh_jit_cache, one_thread):
    """One Tube-MPPI kernel="split" solve (JAX
    tests/test_review_regressions.py:31) against JAX's on the same noise, as
    tests/test_torch_tube.py holds the other paths."""
    from test_torch_tube import (
        C as TC_,
        K as TK,
        SCENARIOS,
        T as TT,
        _close,
        _jax_controller,
        _port_of,
        _port_state,
        _warm_state,
    )

    eps = np.random.default_rng(19).normal(size=(TK, TT, TC_)).astype(np.float32)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, mean, n, stride=0: jnp.asarray(eps))
    monkeypatch.setattr(j_ilqr, "_LADDER_INTERPRET", True)
    x = np.asarray(SCENARIOS[scenario][0], np.float32)
    jc = _jax_controller("split")
    js = _warm_state(jc, scenario)
    jres, jnew = jc.solve(jnp.asarray(x), js)
    tc = _port_of(jc, "split")
    tres, tnew = tc.solve(torch.from_numpy(x), _port_state(js, tc),
                          injected_noise=torch.from_numpy(eps))
    assert int(tres.nominal_state_used) == int(jres.nominal_state_used)
    for system in ("real", "nominal"):
        tr, jr = getattr(tres, system), getattr(jres, system)
        for field in ("control_mean", "costs", "baseline", "normalizer",
                      "state_trajectory"):
            _close(getattr(tr, field), getattr(jr, field), msg=f"{system}.{field}")
        assert np.array_equal(tr.crash.numpy(), np.asarray(jr.crash))
    for field in ("control_mean", "nominal_mean", "nominal_state"):
        _close(getattr(tnew, field), getattr(jnew, field), msg=field)


def test_split_matches_combined_in_the_port(one_thread):
    """kernel="split" and kernel="combined" of the port on the same noise:
    the same rollout, summed in another order."""
    from test_torch_vanilla import CONFIGS, X0, _jax_controller, _port_of

    jc = _jax_controller(CONFIGS["carveouts"])
    split, combined = _port_of(jc, "split"), _port_of(jc, "combined")
    eps = torch.from_numpy(np.random.default_rng(9).normal(
        size=(jc.num_rollouts, jc.num_timesteps, 2)).astype(np.float32))
    state = split.init_state(seed=0)
    rs, _ = split.solve(torch.from_numpy(X0), state, 2, injected_noise=eps)
    rc, _ = combined.solve(torch.from_numpy(X0), state, 2, injected_noise=eps)
    for field in ("control_mean", "costs", "weights", "baseline", "state_trajectory"):
        np.testing.assert_allclose(getattr(rs, field).numpy(), getattr(rc, field).numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    assert torch.equal(rs.crash, rc.crash)


def test_split_cost_true_raises_for_an_ineligible_cost():
    """split_cost=True on a cost that declares neither time_parallel_cost nor
    time_parallel_crash raises, as JAX's _arbitrate_split does; False and
    None (AUTO) keep the combined kernel."""
    from mppi_generic_tpu_torch import GaussianDistribution, VanillaMPPI
    from mppi_generic_tpu_torch.models import QuadrotorDynamics

    dyn, cost = QuadrotorDynamics.create(), costs.QuadrotorMapCost()
    x0, U = torch.zeros(13), torch.zeros((8, 4, 4))
    with pytest.raises(ValueError, match="time_parallel"):
        fr.fused_rollout_costs(dyn, cost, x0, U, DT, split_cost=True)
    with pytest.raises(ValueError, match="time_parallel"):
        fr.fused_weighted_rollout(dyn, cost, x0, U, DT, 1.0, split_cost=True)
    samp = GaussianDistribution.create(std_dev=[1.0] * 4)
    with pytest.raises(ValueError, match="time_parallel"):
        fused_solve.fused_solve_iteration(dyn, cost, samp, x0, torch.zeros((4, 4)), 0,
                                          DT, 1.0, 0.0, 8, split_cost=True)
    assert not fr.resolve_split(dyn, cost, None)
    assert not fr.resolve_split(dyn, cost, False)
    with pytest.raises(ValueError, match="split_cost"):
        fr.resolve_split(dyn, cost, "yes")
    with pytest.raises(ValueError, match="split_cost"):
        VanillaMPPI(dyn, cost, samp, num_timesteps=4, num_rollouts=8, device="cpu",
                    split_cost="yes")
