"""The bicycle-slip + track-map configuration on the CPU: the port's
bicycle-slip step against the JAX package's, the plain versions of the
rollout kernel's bicycle entry (every mode) against the JAX Pallas kernel in
interpret mode, and one colored-noise ``VanillaMPPI`` solve against JAX
``kernel="pallas"``.

The configuration is ``bench.py:641-665`` cut to K=256, T=16, on a 32^2 map
(0.1 m texels) with ``output_indices=(0, 1, 2, 8, 5, 6)``: 0.15 |z| with a
hot band ahead of the car, which starts at 2 m/s, so some samples crash
late in the horizon and the crash flags are worth comparing.

Tolerances: the step rtol 1e-5 / atol 1e-6; costs rtol 2e-5 / atol 2e-4 (as
tests/test_windowed_maps.py:260: the JAX kernel's tent-mask map products sum
in another order); crash flags exactly; new means rtol 1e-4 / atol 1e-5;
baselines rtol 1e-5; eta rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.costs import ARStandardCost as JStandard
from mppi_generic_tpu.maps.texture import MapTexture2D as JTex
from mppi_generic_tpu.models.bicycle_slip import BicycleSlipDynamics as JBicycle
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.sampling import ColoredNoiseDistribution as JColored
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.models import BicycleSlipDynamics
from mppi_generic_tpu_torch.models.bicycle_slip import PARAM_NAMES
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_autorally import jax_cost_params
from test_torch_colored import jax_normals, jax_sampler_params

K, T, C = 256, 16, 2
DT, LAM, ALPHA = 0.02, 1.0, 0.0
OUT = (0, 1, 2, 8, 5, 6)
X0 = np.array([0.0, 0.0, 0.1, 0.2, 0.0, 2.0, 0.0, 0.3, 0.0, 0.0], np.float32)


def jax_bicycle_params(dyn):
    names = ("control_ranges", "control_deadband", "zero_control") + PARAM_NAMES
    return {n: np.asarray(getattr(dyn, n)) for n in names}


@functools.lru_cache(maxsize=None)
def _jax_map():
    rng = np.random.default_rng(31)
    m = (0.15 * np.abs(rng.normal(size=(32, 32)))).astype(np.float32)
    m[:, 28] = 1.3  # texel centres x = 1.25 m: the front point of some
    m[:, 29:] = 3.0  # samples crosses the 0.65 threshold late in the horizon
    return JTex.create(m, origin=(-1.6, -1.6, 0.0), resolution=0.1)


def _setup():
    jdyn = JBicycle.create(control_ranges=[[-0.8, 1.0], [-1.0, 1.0]])
    jcost = JStandard(costmap=_jax_map(), output_indices=OUT)
    return (jdyn, jcost), (convert.bicycle_slip_from_params(jax_bicycle_params(jdyn)),
                           convert.ar_cost_from_params(jax_cost_params(jcost)))


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def test_bicycle_step_matches_jax():
    """Braking and throttle, steering against its rate clamp and past its
    angle clamp, a yaw that wraps, the brake state past its limit."""
    (jdyn, _), (tdyn, _) = _setup()
    rng = np.random.default_rng(3)
    n = 300
    x = rng.normal(size=(10, n)).astype(np.float32)
    x[2] = rng.uniform(-3.2, 3.2, size=n)
    x[3] = rng.uniform(-0.6, 0.6, size=n)
    x[4] = rng.uniform(0.0, 0.85, size=n)
    x[4, 0] = -0.05  # a brake state below 0, clamped back
    x[5] = rng.uniform(-1.0, 6.0, size=n)
    x[7] = 60.0 * x[7]  # the Euler step carries some yaws across pi
    u = rng.uniform(-1.2, 1.2, size=(2, n)).astype(np.float32)
    jx, jy = jdyn.step(jnp.asarray(x), jnp.asarray(u), 0.0, DT)
    tx, ty = tdyn.step(torch.from_numpy(x), torch.from_numpy(u), 0.0, DT)
    _close(tx, jx, 1e-5, 1e-6, "state")
    _close(ty, jy, 1e-5, 1e-6, "output")
    _close(tdyn.state_deriv(torch.from_numpy(x), torch.from_numpy(u)),
           jdyn.state_deriv(jnp.asarray(x), jnp.asarray(u)), 1e-5, 1e-5, "deriv")
    assert bool((np.abs(x[2] + DT * x[7]) > np.pi).any())  # some yaw wrapped
    assert float(tx[3].abs().max()) == np.float32(0.5)  # the steer clamp
    assert float(tx[4].max()) == np.float32(0.8) and float(tx[4].min()) == 0.0
    tv, _ = tdyn.step(torch.from_numpy(x[:, 0]), torch.from_numpy(u[:, 0]), 0.0, DT)
    _close(tv, jx[:, 0], 1e-5, 1e-6, "one vector")
    m = {"POS_X": 1.0, "VEL_X": 2.0, "PITCH": 0.1}
    _close(tdyn.state_from_map(m), jdyn.state_from_map(m), 0, 0, "state_from_map")
    assert float(tdyn.c_sliding[0]) == float(jdyn.c_sliding[0])
    with pytest.raises(TypeError, match="unknown"):
        BicycleSlipDynamics(wheelbase=0.3)


def _rollout_inputs(seed=13):
    rng = np.random.default_rng(seed)
    mean = (0.3 * rng.normal(size=(T, C))).astype(np.float32)
    sigma = np.tile(np.array([[0.3, 0.5]], np.float32), (T, 1))
    U = np.clip(mean + sigma * rng.normal(size=(K, T, C)), -0.8, 1.0).astype(np.float32)
    coeff = np.array([0.5, 1.0], np.float32)
    thresh = float(np.float32(0.9) * np.float32(K))
    return U, (mean, sigma, coeff, LAM, ALPHA, thresh)


@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue", "epilogue+lr",
                                  "tsallis+lr"])
def test_bicycle_entry_plain_matches_jax_kernel(mode):
    (jdyn, jcost), (dyn, cost) = _setup()
    U, lr = _rollout_inputs()
    with_lr = mode.endswith("+lr")
    jlr = (tuple(jnp.asarray(a) for a in lr[:3]) + tuple(jnp.float32(v) for v in lr[3:])
           if with_lr else None)
    tlr = tuple(torch.from_numpy(a) for a in lr[:3]) + lr[3:] if with_lr else None
    x0, Ut = torch.from_numpy(X0), torch.from_numpy(U)
    if mode.startswith("costs"):
        jc, jcrash = pallas_rollout.fused_rollout_costs(
            jdyn, jcost, jnp.asarray(X0), jnp.asarray(U), DT, tile_k=128, lr_params=jlr)
        tc, tcrash = fr.fused_rollout_costs(dyn, cost, x0, Ut, DT, lr_params=tlr)
    else:
        kind = "tsallis" if mode.startswith("tsallis") else "exp"
        jc, jcrash, jmean, jbase, jeta = pallas_rollout.fused_weighted_rollout(
            jdyn, jcost, jnp.asarray(X0), jnp.asarray(U), DT, LAM, lr_params=jlr,
            tile_k=128, weight_kind=kind,
            weight_params=(jnp.float32(2000.0), jnp.float32(2.0)))
        tc, tcrash, tmean, tbase, teta = fr.fused_weighted_rollout(
            dyn, cost, x0, Ut, DT, LAM, lr_params=tlr, weight_kind=kind,
            weight_params=(2000.0, 2.0))
        _close(tmean, jmean, 1e-4, 1e-5, "new mean")
        _close(tbase, jbase, 1e-5, 0, "baseline")
        _close(teta, jeta, 1e-4, 0, "eta")
    _close(tc, jc, 2e-5, 2e-4, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    assert 0 < int(np.asarray(jcrash).sum()) < K


@pytest.fixture
def fresh_jit_cache():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bicycle_colored_solve_matches_jax(monkeypatch, fresh_jit_cache, one_thread):
    """One solve of the configuration (colored std [0.3, 0.5], exponents
    [1, 1]; a warm mean, stride 1) on kernel="fused" against JAX pallas on
    the same frequency normals."""
    key = jax.random.PRNGKey(29)
    orig = JColored._draw_noise
    monkeypatch.setattr(JColored, "_draw_noise",
                        lambda self, k, m, n, s=0: orig(self, key, m, n, s))
    (jdyn, jcost), _ = _setup()
    jsamp = JColored.create(std_dev=[0.3, 0.5], exponents=[1.0, 1.0])
    jc = JVanilla(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(DT),
                  lam=jnp.float32(LAM), alpha=jnp.float32(ALPHA), num_timesteps=T,
                  num_rollouts=K, num_iters=1, kernel="pallas", pallas_tile_k=128)
    tc = convert.vanilla_from_params(
        jax_bicycle_params(jdyn), jax_cost_params(jcost), jax_sampler_params(jsamp),
        dict(dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T, num_rollouts=K, num_iters=1),
        device="cpu", kernel="fused", sampler_kind="colored",
        dynamics_kind="bicycle_slip", cost_kind="ar_standard")
    mean = (0.3 * np.random.default_rng(12).normal(size=(T, C))).astype(np.float32)
    js = jc.init_state(jax.random.PRNGKey(0)).replace(control_mean=jnp.asarray(mean))
    ts = convert.state_from_params(
        {n: np.asarray(getattr(js, n))
         for n in ("control_mean", "control_history", "previous_baseline")}, tc)
    jres, jnew = jc.solve(jnp.asarray(X0), js, 1)
    tres, tnew = tc.solve(torch.from_numpy(X0), ts, 1,
                          injected_noise=torch.from_numpy(jax_normals(key, K, C, T)))
    _close(tres.costs, jres.costs, 2e-5, 2e-4, "costs")
    np.testing.assert_array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    assert 0 < int(np.asarray(jres.crash).sum()) < K
    _close(tres.baseline, jres.baseline, 1e-5, 0, "baseline")
    _close(tres.control_mean, jres.control_mean, 1e-4, 1e-5, "control mean")
    _close(tnew.control_mean, jnew.control_mean, 1e-4, 1e-5, "new control mean")
    _close(tres.state_trajectory, jres.state_trajectory, 1e-4, 1e-5, "state trajectory")


def test_bicycle_entry_refuses_another_output_layout():
    _, (dyn, cost) = _setup()
    moved = convert.ar_cost_from_params({**jax_cost_params(_setup()[0][1]),
                                         "output_indices": (0, 1, 2, 3, 4, 5)})
    with pytest.raises(NotImplementedError, match="output"):
        fr._model_args(dyn, moved, torch.device("cpu"))
    fr._model_args(dyn, cost, torch.device("cpu"))
    assert fr._entry(dyn, cost, "rollout") == ("pair_bicycle_ar", "rollout_costs_bicycle_ar")
