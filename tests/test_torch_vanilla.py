"""The vanilla-MPPI path as a whole: one solve of the port against the JAX
package's ``kernel="pallas"`` solve (its Pallas kernel in interpret mode)
with the same injected noise, the port's two rollout paths against each
other, the control-sequence services, and a CPU closed loop on the
double-integrator circle task."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu_torch import GaussianDistribution, VanillaMPPI, convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics

K, T, C = 300, 24, 2
RTOL = ATOL = 1e-5
X0 = np.array([2.0, 0.05, -0.1, 1.0], np.float32)

CONFIGS = {
    # the flagship configuration (bench.py build_controller)
    "flagship": dict(p=0.0, lam=1.0, alpha=0.0, stride=0, iters=1),
    # pure-noise tail, alpha, a frozen head and two iterations
    "carveouts": dict(p=0.25, lam=1.3, alpha=0.1, stride=2, iters=2),
}


def _jax_controller(cfg, kernel="pallas"):
    return JVanilla(
        dynamics=JDI.create(),
        cost=JCircle(),
        sampler=JGaussian.create(std_dev=[1.0, 0.8],
                                 control_cost_coeff=[0.01, 0.02],
                                 pure_noise_percentage=cfg["p"]),
        dt=jnp.float32(0.02), lam=jnp.float32(cfg["lam"]),
        alpha=jnp.float32(cfg["alpha"]), num_timesteps=T, num_rollouts=K,
        num_iters=cfg["iters"], kernel=kernel,
    )


def _params(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def _port_of(jc, kernel="fused"):
    """The port's controller with the JAX controller's parameters."""
    return convert.vanilla_from_params(
        _params(jc.dynamics, ("control_ranges", "control_deadband",
                              "zero_control", "system_noise")),
        _params(jc.cost, DoubleIntegratorCircleCost.PARAM_NAMES),
        _params(jc.sampler, ("std_dev", "control_cost_coeff",
                             "pure_noise_percentage", "std_dev_decay")),
        dict(dt=jc.dt, lam=jc.lam, alpha=jc.alpha,
             num_timesteps=jc.num_timesteps, num_rollouts=jc.num_rollouts,
             num_iters=jc.num_iters),
        device="cpu", kernel=kernel,
    )


def _warm_state(jc, seed=0):
    rng = np.random.default_rng(seed)
    return jc.init_state(jax.random.PRNGKey(0)).replace(
        control_mean=jnp.asarray(rng.normal(scale=0.3, size=(T, C)), jnp.float32),
        control_history=jnp.asarray(rng.normal(scale=0.3, size=(2, C)),
                                    jnp.float32),
    )


@pytest.fixture
def fresh_jit_cache():
    """solve is jitted: a cached trace would ignore the patched noise, and
    the patched trace must not reach later tests."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_solve_matches_jax_pallas(name, monkeypatch, fresh_jit_cache):
    cfg = CONFIGS[name]
    eps = np.random.default_rng(7).normal(size=(K, T, C)).astype(np.float32)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, mean, n, stride=0: jnp.asarray(eps))
    jc = _jax_controller(cfg)
    js = _warm_state(jc)
    jres, jnew = jc.solve(jnp.asarray(X0), js, cfg["stride"])

    tc = _port_of(jc)
    ts = convert.state_from_params(
        _params(js, ("control_mean", "control_history", "previous_baseline")), tc)
    tres, tnew = tc.solve(torch.from_numpy(X0), ts, cfg["stride"],
                          injected_noise=torch.from_numpy(eps))

    def close(t, j, rtol=RTOL, atol=ATOL):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)

    close(tres.control_mean, jres.control_mean)
    close(tres.costs, jres.costs)
    close(tres.weights, jres.weights)
    close(tres.baseline, jres.baseline)
    close(tres.normalizer, jres.normalizer)
    close(tres.state_trajectory, jres.state_trajectory)
    close(tres.output_trajectory, jres.output_trajectory)
    assert np.array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    for field in ("free_energy_mean", "free_energy_variance",
                  "free_energy_modified_variance", "baseline",
                  "normalizer_percent", "previous_baseline", "increase"):
        close(getattr(tres.free_energy, field),
              getattr(jres.free_energy, field), rtol=1e-5, atol=1e-4)
    close(tnew.control_mean, jnew.control_mean)
    close(tnew.previous_baseline, jnew.previous_baseline)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_combined_matches_fused(name):
    cfg = CONFIGS[name]
    jc = _jax_controller(cfg)
    fused, combined = _port_of(jc, "fused"), _port_of(jc, "combined")
    eps = torch.from_numpy(
        np.random.default_rng(8).normal(size=(K, T, C)).astype(np.float32))
    state = fused.init_state(seed=0)
    rf, _ = fused.solve(torch.from_numpy(X0), state, cfg["stride"], injected_noise=eps)
    rc, _ = combined.solve(torch.from_numpy(X0), state, cfg["stride"], injected_noise=eps)
    for field in ("control_mean", "costs", "weights", "baseline", "normalizer",
                  "state_trajectory"):
        np.testing.assert_allclose(getattr(rf, field).numpy(),
                                   getattr(rc, field).numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    assert torch.equal(rf.crash, rc.crash)


@pytest.mark.parametrize("stride", [0, 1, 3])
def test_slide_control_sequence_matches_jax(stride):
    jc = _jax_controller(CONFIGS["flagship"])
    js = _warm_state(jc, seed=stride)
    tc = _port_of(jc)
    ts = convert.state_from_params(
        _params(js, ("control_mean", "control_history", "previous_baseline")), tc)
    jn = jc.slide_control_sequence(js, stride)
    tn = tc.slide_control_sequence(ts, stride)
    np.testing.assert_allclose(tn.control_mean.numpy(), np.asarray(jn.control_mean))
    np.testing.assert_allclose(tn.control_history.numpy(),
                               np.asarray(jn.control_history))


def test_get_current_control_matches_jax():
    jc = _jax_controller(CONFIGS["flagship"])
    tc = _port_of(jc)
    mean = np.random.default_rng(9).normal(size=(T, C)).astype(np.float32)

    class Result:
        control_mean = None

    jr, tr = Result(), Result()
    jr.control_mean, tr.control_mean = jnp.asarray(mean), torch.from_numpy(mean)
    for rel_time in (0.0, 0.013, 0.1, 5.0):
        np.testing.assert_allclose(
            tc.get_current_control(tr, rel_time).numpy(),
            np.asarray(jc.get_current_control(jr, rel_time)), rtol=1e-5, atol=1e-6)


def test_closed_loop_settles_on_the_circle():
    """SKILL surface 4 on the CPU: the flagship configuration at K=1024,
    T=100 settles on radius ~2 with a baseline below 2 within 60 steps."""
    ctrl = VanillaMPPI(
        DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
        GaussianDistribution.create(std_dev=[1.0, 1.0],
                                    control_cost_coeff=[0.01, 0.01]),
        dt=0.02, lam=1.0, alpha=0.0, num_timesteps=100, num_rollouts=1024,
        num_iters=1, device="cpu")
    cs = ctrl.init_state(seed=0)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0])
    for _ in range(60):
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        x, _ = ctrl.dynamics.step(x, res.control_mean[0], 0.0, ctrl.dt)
    radius = float(torch.hypot(x[0], x[1]))
    assert 1.8 <= radius <= 2.2, radius
    assert float(res.baseline) < 2.0
    assert torch.isfinite(res.control_mean).all()
