"""``VanillaMPPI(kernel="fused_solve")`` on the pairs that gained the fused
sampling kernel (B4), on the CPU (the kernels' plain versions, injected
noise), against the JAX package's ``kernel="pallas_fused"`` solve, which off
the TPU takes its XLA sampling path with the patched ``_draw_noise``: the
AutoRally configuration with Tsallis and with CEM weights (both take B4,
not B3) and the bicycle slip with the Smooth-MPPI sampler (B4 with its
epilogue over the derivative samples).

Configurations: AutoRally as test_torch_autorally_kernels.py (its network at
scale 1 on the 32^2 map where part of the samples crash, K = 256, T = 16, a
warm mean, stride 1); the bicycle as test_torch_bicycle.py (the 32^2 map,
K = 256, T = 16). Tsallis at gamma 10, r 2; CEM at an elite fraction of 0.1
on a noise seed whose elite threshold is clear of its neighbours (ROADMAP.md
section 3). Tolerances: costs rtol / atol 1e-4 (the AutoRally family's),
crash flags exactly, baselines rtol 1e-5, control means rtol 1e-4 / atol
1e-5 widened by what the measured cost differences can move the weights
(``_weight_slack`` of test_torch_zoo_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import SmoothMPPIDistribution as JSmooth
from mppi_generic_tpu_torch import convert
from test_torch_autorally import jax_cost_params, jax_dynamics_params
from test_torch_autorally_kernels import X0 as AR_X0
from test_torch_autorally_kernels import _setup as ar_setup
from test_torch_bicycle import X0 as BI_X0
from test_torch_bicycle import _setup as bi_setup
from test_torch_bicycle import jax_bicycle_params
from test_torch_zoo_kernels import _weight_slack

K, T, C = 256, 16, 2
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")
GAMMA, R_TS, ELITE = 10.0, 2.0, 0.1
CEM_SEED = 3  # a noise seed whose CEM threshold is clear of its neighbours


@pytest.fixture
def one_thread():
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


def _controllers(pair, transform, sampler_kind):
    """(JAX controller, port controller, x0) of one configuration."""
    if pair == "ar_nn":
        (jdyn, jcost, _), _ = ar_setup("32")
        dyn_params, dyn_kind, cost_kind, x0 = jax_dynamics_params(jdyn), "autorally", \
            "ar_standard", AR_X0
    else:
        (jdyn, jcost), _ = bi_setup()
        dyn_params, dyn_kind, cost_kind, x0 = jax_bicycle_params(jdyn), "bicycle_slip", \
            "ar_standard", BI_X0
    kw = dict(std_dev=[0.3, 0.5], control_cost_coeff=[0.5, 1.0])
    # a wide Smooth-MPPI step spreads the samples, so that part of them crash
    jsamp = (JSmooth.create(num_timesteps=T, dt=0.5, **kw) if sampler_kind == "smooth"
             else JGaussian.create(**kw))
    jc = JVanilla(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(0.02),
                  lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T,
                  num_rollouts=K, num_iters=1, kernel="pallas_fused",
                  weight_transform=transform, tsallis_gamma=jnp.float32(GAMMA),
                  tsallis_r=jnp.float32(R_TS), cem_elite_fraction=jnp.float32(ELITE))
    sampler = {n: np.asarray(getattr(jsamp, n)) for n in SAMPLER_FIELDS}
    if sampler_kind == "smooth":
        sampler.update(dt_smooth=np.asarray(jsamp.dt_smooth), num_timesteps=T)
    tc = convert.vanilla_from_params(
        dyn_params, jax_cost_params(jcost), sampler,
        dict(dt=0.02, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K, num_iters=1,
             tsallis_gamma=GAMMA, tsallis_r=R_TS, cem_elite_fraction=ELITE),
        device="cpu", kernel="fused_solve", sampler_kind=sampler_kind,
        weight_transform=transform, dynamics_kind=dyn_kind, cost_kind=cost_kind,
        return_samples=True)
    return jc, tc, x0


def _solve(pair, transform, sampler_kind, seed, monkeypatch):
    eps = np.random.default_rng(seed).normal(size=(K, T, C)).astype(np.float32)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, m, n, s=0: jnp.asarray(eps))
    jc, tc, x0 = _controllers(pair, transform, sampler_kind)
    rng = np.random.default_rng(seed + 100)
    mean = 0.2 * rng.normal(size=(T, C))
    if pair == "bicycle_ar":
        mean[:, 0] += 0.1  # throttle: part of the samples reach the hot band
    js = jc.init_state(jax.random.PRNGKey(0)).replace(
        control_mean=jnp.asarray(mean, jnp.float32))
    if sampler_kind == "smooth":
        js = js.replace(sampler_state=jnp.asarray(rng.normal(scale=0.5, size=(T, C)),
                                                  jnp.float32))
    p = {n: np.asarray(getattr(js, n))
         for n in ("control_mean", "control_history", "previous_baseline")}
    p["sampler_state"] = None if js.sampler_state is None else np.asarray(js.sampler_state)
    ts = convert.state_from_params(p, tc)
    jres, jnew = jc.solve(jnp.asarray(x0), js, 1)
    tres, tnew = tc.solve(torch.from_numpy(x0), ts, 1, injected_noise=torch.from_numpy(eps))
    return jres, jnew, tres, tnew


def _close(t, j, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def _compare(jres, jnew, tres, tnew, scale, n=None):
    _close(tres.costs, jres.costs, 1e-4, 1e-4, "costs")
    np.testing.assert_array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    assert 0 < int(np.asarray(jres.crash).sum()) < K  # some samples crash, some do not
    _close(tres.baseline, jres.baseline, 1e-5, 0, "baseline")
    # the samples the weights average: U, or Smooth-MPPI's W behind the mean
    X = tres.sampled_controls.numpy()
    _, mean_atol = _weight_slack(tres.costs, jres.costs, X, jres.control_mean, scale, n)
    _close(tres.control_mean, jres.control_mean, 1e-4, mean_atol, "control mean")
    _close(tnew.control_mean, jnew.control_mean, 1e-4, mean_atol, "new control mean")


def test_autorally_tsallis_solve_matches_jax(monkeypatch, one_thread, fresh_jit_cache):
    jres, jnew, tres, tnew = _solve("ar_nn", "tsallis", "gaussian", 21, monkeypatch)
    n = int(np.sum(np.asarray(jres.costs) - float(jres.baseline) < GAMMA))
    assert n > 1  # more than one sample weighs
    _compare(jres, jnew, tres, tnew, GAMMA, n)


def test_autorally_cem_solve_matches_jax(monkeypatch, one_thread, fresh_jit_cache):
    jres, jnew, tres, tnew = _solve("ar_nn", "cem", "gaussian", CEM_SEED, monkeypatch)
    jcosts = np.sort(np.asarray(jres.costs))
    n_elite = max(int(np.floor(np.float32(ELITE) * K)), 1)
    gap = min(jcosts[n_elite] - jcosts[n_elite - 1], jcosts[n_elite - 1] - jcosts[n_elite - 2])
    assert gap > 2 * (1e-4 + 1e-4 * abs(jcosts[n_elite])), gap
    _compare(jres, jnew, tres, tnew, 1.0)
    assert float(tres.weights.sum()) == n_elite


def test_bicycle_smooth_solve_matches_jax(monkeypatch, one_thread, fresh_jit_cache):
    jres, jnew, tres, tnew = _solve("bicycle_ar", "exp", "smooth", 5, monkeypatch)
    _compare(jres, jnew, tres, tnew, 1.0)
    _close(tnew.sampler_state, jnew.sampler_state, 1e-4, 1e-4, "derivative mean")
