"""The robust family's slice as a whole, on the CPU: a few closed-loop RMPPI
steps on the cartpole and on the Dubins car against the JAX package's
``kernel="pallas"`` on the same injected noise, each step stage 1 (the
candidates through B1 from one x0 per sample), stage 2 (B8) and DDP on the
ladder (B7; JAX's in interpret mode), then the plant.

The cartpole is the bench row cartpole_example_K8192's model and cost
(control range +-5, coefficients (100, 10, 200, 20), std 5) cut to K = 128,
T = 12, 9 candidates x 16 samples; the Dubins car tracks a fixed goal with
``QuadraticCost`` from a yaw of 3.0, so that its trajectory turns through
pi. Tolerances: the costs rtol 2e-5 / atol 2e-4 (the cartpole's costs are
about 1e3), the means within 2 max|dJ| / lambda of the samples' spread
(test_torch_robust_family_solve.py's rule), the candidates' free energies
within max|dJ| + 1e-4, the plant state rtol 1e-4 /
atol 1e-4, the chosen candidate and its stride exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import RobustMPPI as JRobust
from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_robust_family_solve import (
    FEEDBACK_FIELDS,
    SAMPLER_FIELDS,
    _compare_system,
    _params,
    _patch_noise,
)
from test_torch_zoo import jax_cost_params, jax_model_params, zoo_pair

K, T, N_CAND, S_PER, DT, STEPS = 128, 12, 9, 16, 0.02, 3
CASES = {"cartpole": ("cartpole", "cartpole", [5.0]),
         "dubins_quadratic": ("dubins", "quadratic", [1.0, 1.0])}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rmppi_closed_loop_matches_jax(name, monkeypatch, one_thread):
    dyn_kind, cost_kind, std = CASES[name]
    C = len(std)
    rng = np.random.default_rng(61)
    eps = {n: rng.normal(size=(n, T, C)).astype(np.float32) for n in (S_PER, K)}
    _patch_noise(monkeypatch, eps)
    jax.clear_caches()
    jdyn, jcost, x0, *_ = zoo_pair(name)
    jsamp = JGaussian.create(std_dev=std, control_cost_coeff=[0.5] * C)
    jc = JRobust(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(DT),
                 lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T,
                 num_rollouts=K, num_candidates=N_CAND, samples_per_condition=S_PER,
                 feedback=JDDP.create(jdyn, DT), kernel="pallas")
    tc = convert.robust_from_params(
        jax_model_params(jdyn), jax_cost_params(jcost), _params(jsamp, SAMPLER_FIELDS),
        dict(dt=DT, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K, num_iters=1,
             value_function_threshold=jc.value_function_threshold,
             num_candidates=N_CAND, samples_per_condition=S_PER),
        _params(jc.feedback, FEEDBACK_FIELDS), device="cpu", kernel="fused",
        dynamics_kind=dyn_kind, cost_kind=cost_kind)
    assert fr._entry(tc.dynamics, tc.cost, "rmppi")[1] == f"rmppi_rollout_{name}"
    js, ts = jc.init_state(jax.random.PRNGKey(0)), tc.init_state(0)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    try:
        for step in range(STEPS):
            js, jfe = jc.update_importance_sampling(jx, js, 1)
            ts, tfe = tc.update_importance_sampling(
                tx, ts, 1, injected_noise=torch.from_numpy(eps[S_PER]))
            assert int(ts.best_index) == int(js.best_index)
            assert int(ts.nominal_stride) == int(js.nominal_stride)
            # stage 2's samples, around the nominal mean stage 1 left
            U = tc._clamp_controls(torch.from_numpy(eps[K]) * tc.sampler.std_dev
                                   + ts.nominal_mean)
            jres, js = jc.solve(jx, js)
            tres, ts = tc.solve(tx, ts, injected_noise=torch.from_numpy(eps[K]))
            dJ = 0.0
            for system in ("real", "nominal"):
                dJ = max(dJ, _compare_system(getattr(tres, system), getattr(jres, system),
                                             U, 1.0, T, (2e-5, 2e-4), f"step {step} {system}"))
            np.testing.assert_allclose(tfe.numpy(), np.asarray(jfe), rtol=0, atol=dJ + 1e-4,
                                       err_msg=f"step {step} candidate free energy")
            jx = jdyn.step(jx, jres.real.control_mean[0], 0.0, DT)[0]
            tx = tc.dynamics.step(tx, tres.real.control_mean[0], 0.0, DT)[0]
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {step} plant state")
    finally:
        jax.clear_caches()
