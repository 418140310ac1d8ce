"""Smooth-MPPI in Tube-MPPI and RMPPI, on the CPU: the port's controllers
carry the sampler's state (the derivative mean) as the JAX controllers do,
checked over a few closed-loop steps against the JAX package on the same
injected noise (``_draw_noise`` patched on the JAX side, ``injected_noise``
on the port's; the RNG streams differ by design).

The configuration: the double integrator with its circle cost, Smooth-MPPI
std [1, 1] in derivative units, dt_smooth 0.05, coefficients 0.01, K = 128,
T = 12, lambda 1; Tube with DDP feedback and the nominal threshold 100;
RMPPI with DDP feedback, 9 candidates x 16 samples. Tube runs ``fused``
(B1 with the eager Smooth update) against JAX ``pallas`` and ``fused_solve``
(B4 with Smooth-MPPI's flash epilogue) against JAX ``pallas_fused`` (off
the TPU its XLA path); RMPPI runs ``fused`` against JAX ``pallas`` (the
ladder kernel in interpret mode). Three steps each. Tolerances: the means,
the derivative means and the nominal states rtol 1e-4 / atol 1e-5, the
baselines rtol 1e-5 / atol 1e-5, the chosen candidate exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import RobustMPPI as JRobust
from mppi_generic_tpu.controllers import TubeMPPI as JTube
from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.feedback import ilqr as j_ilqr
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import SmoothMPPIDistribution as JSmooth
from mppi_generic_tpu_torch import DDPFeedback, RobustMPPI, TubeMPPI
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.sampling import SmoothMPPIDistribution

K, T, DT, STEPS = 128, 12, 0.02, 3
N_CAND, S_PER = 9, 16
X0 = np.array([2.0, 0.0, 0.0, 1.0], np.float32)
SMOOTH = dict(std_dev=[1.0, 1.0], control_cost_coeff=[0.01, 0.01])


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.fixture
def noise(monkeypatch):
    """eps[n] for each draw of n samples, in both packages; JAX's DDP ladder
    kernel in interpret mode; fresh jit caches around the case."""
    rng = np.random.default_rng(71)
    eps = {n: rng.normal(size=(n, T, 2)).astype(np.float32) for n in (S_PER, K)}
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, mean, n, stride=0: jnp.asarray(eps[n]))
    monkeypatch.setattr(j_ilqr, "_LADDER_INTERPRET", True)
    jax.clear_caches()
    yield eps
    jax.clear_caches()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth_pair():
    jsamp = JSmooth.create(num_timesteps=T, dt=0.05, **SMOOTH)
    return jsamp, SmoothMPPIDistribution.create(num_timesteps=T, dt=0.05, **SMOOTH)


@pytest.mark.parametrize("port_kernel,jax_kernel", [("fused", "pallas"),
                                                    ("fused_solve", "pallas_fused")])
def test_tube_with_smooth_mppi_matches_jax(port_kernel, jax_kernel, noise, one_thread):
    jsamp, tsamp = _smooth_pair()
    jdyn = JDI.create()
    jc = JTube(dynamics=jdyn, cost=JCircle(), sampler=jsamp, dt=jnp.float32(DT),
               lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T,
               num_rollouts=K, num_iters=1, kernel=jax_kernel,
               feedback=JDDP.create(jdyn, DT))
    dyn = DoubleIntegratorDynamics.create()
    tc = TubeMPPI(dyn, DoubleIntegratorCircleCost(), tsamp, feedback=DDPFeedback.create(dyn, DT),
                  dt=DT, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K,
                  kernel=port_kernel, device="cpu")
    js, ts = jc.init_state(jax.random.PRNGKey(0)), tc.init_state(0)
    jx, tx = jnp.asarray(X0), torch.from_numpy(X0)
    for step in range(STEPS):
        js = jc.slide_control_sequence(js, 1)
        ts = tc.slide_control_sequence(ts, 1)
        jres, js = jc.solve(jx, js)
        tres, ts = tc.solve(tx, ts, injected_noise=torch.from_numpy(noise[K]))
        for what in ("control_mean", "nominal_mean", "nominal_state", "sampler_state"):
            _close(getattr(ts, what), getattr(js, what), 1e-4, 1e-5, f"step {step} {what}")
        _close(tres.real.baseline, jres.real.baseline, 1e-5, 1e-5, f"step {step} baseline")
        _close(tres.nominal.baseline, jres.nominal.baseline, 1e-5, 1e-5,
               f"step {step} nominal baseline")
        jx = jdyn.step(jx, jres.real.control_mean[0], 0.0, DT)[0]
        tx = dyn.step(tx, tres.real.control_mean[0], 0.0, DT)[0]
        _close(tx, jx, 1e-4, 1e-5, f"step {step} state")
    assert float(ts.sampler_state.abs().max()) > 0  # the derivative mean moved


def test_rmppi_with_smooth_mppi_matches_jax(noise, one_thread):
    jsamp, tsamp = _smooth_pair()
    jdyn = JDI.create()
    jc = JRobust(dynamics=jdyn, cost=JCircle(), sampler=jsamp, dt=jnp.float32(DT),
                 lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T,
                 num_rollouts=K, num_candidates=N_CAND, samples_per_condition=S_PER,
                 feedback=JDDP.create(jdyn, DT), kernel="pallas")
    dyn = DoubleIntegratorDynamics.create()
    tc = RobustMPPI(dyn, DoubleIntegratorCircleCost(), tsamp,
                    feedback=DDPFeedback.create(dyn, DT), dt=DT, lam=1.0, alpha=0.0,
                    num_timesteps=T, num_rollouts=K, num_candidates=N_CAND,
                    samples_per_condition=S_PER, device="cpu")
    js, ts = jc.init_state(jax.random.PRNGKey(0)), tc.init_state(0)
    jx, tx = jnp.asarray(X0), torch.from_numpy(X0)
    for step in range(STEPS):
        js, jfe = jc.update_importance_sampling(jx, js, 1)
        ts, tfe = tc.update_importance_sampling(tx, ts, 1,
                                                injected_noise=torch.from_numpy(noise[S_PER]))
        assert int(ts.best_index) == int(js.best_index)
        _close(ts.sampler_state, js.sampler_state, 1e-4, 1e-5, f"step {step} stage 1 state")
        jres, js = jc.solve(jx, js)
        tres, ts = tc.solve(tx, ts, injected_noise=torch.from_numpy(noise[K]))
        for what in ("control_mean", "nominal_mean", "nominal_state", "sampler_state"):
            _close(getattr(ts, what), getattr(js, what), 1e-4, 1e-5, f"step {step} {what}")
        _close(tres.real.baseline, jres.real.baseline, 1e-5, 1e-5, f"step {step} baseline")
        jx = jdyn.step(jx, jres.real.control_mean[0], 0.0, DT)[0]
        tx = dyn.step(tx, tres.real.control_mean[0], 0.0, DT)[0]
        _close(tx, jx, 1e-4, 1e-5, f"step {step} state")
    assert float(ts.sampler_state.abs().max()) > 0
