"""The fused sampling kernel (B4) in its recurrent mode, on the CPU: the
racer LSTM-steering model (elevation map, settling, track map) and the
racer LSTM-uncertainty model (three LSTMs, the covariance, flat ground),
each with ``ARStandardCost`` on the racer output layout. The plain version
of the port's ``fused_sample_rollout_costs`` against JAX's Pallas kernel in
interpret mode (``check_b4`` of test_torch_sample_pairs.py: sizes,
tolerances, the mixed crash population), and one ``VanillaMPPI`` solve of
the racer steering row on ``kernel="fused_solve"`` with CEM weights (B4)
against JAX ``pallas_fused``, which off the TPU takes its XLA path with
``_draw_noise`` patched.

The solve: the racer steering row of test_torch_racer_solve.py (K = 256,
T = 20, the 32^2 maps, a warm mean, stride 1) with CEM at an elite
fraction of 0.1, on a noise seed whose elite threshold is clear of its
neighbours (ROADMAP.md section 3: CEM weights are a step function of the
costs). Tolerances: costs rtol / atol 1e-4, crash flags exactly, baseline
rtol 1e-5, control means rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu_torch import convert
from test_torch_racer import jax_racer_params
from test_torch_autorally import jax_cost_params
from test_torch_racer_kernels import SAMPLER_FIELDS, _mean, _setup, _x0
from test_torch_sample_pairs import check_b4
from mppi_generic_tpu_torch.models import RacerDubinsElevationLSTMSteering


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_jit_cache():
    """solve is jitted: a cached trace would ignore the patched noise."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", ["racer_steering_ar", "racer_unc_ar"])
@pytest.mark.parametrize("kind", ["gaussian", "smooth"])
def test_racer_b4_plain_matches_jax_kernel(name, kind, one_thread):
    check_b4(name, kind, 0.0)


K, T, C = 256, 20, 2
CEM_SEED = 14


def test_racer_steering_cem_solve_matches_jax(monkeypatch, one_thread, fresh_jit_cache):
    eps = np.random.default_rng(CEM_SEED).normal(size=(K, T, C)).astype(np.float32)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, m, n, s=0: jnp.asarray(eps))
    (jdyn, jcost, jsamp), _ = _setup("steering")
    jc = JVanilla(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(0.02),
                  lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T,
                  num_rollouts=K, num_iters=1, kernel="pallas_fused",
                  weight_transform="cem")
    tc = convert.vanilla_from_params(
        jax_racer_params(jdyn, RacerDubinsElevationLSTMSteering), jax_cost_params(jcost),
        {n: np.asarray(getattr(jsamp, n)) for n in SAMPLER_FIELDS},
        dict(dt=0.02, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K, num_iters=1,
             cem_elite_fraction=jc.cem_elite_fraction),
        device="cpu", kernel="fused_solve", weight_transform="cem",
        dynamics_kind="racer_steering", cost_kind="ar_standard")
    mean = _mean(T)
    js = jc.init_state(jax.random.PRNGKey(0)).replace(control_mean=jnp.asarray(mean))
    ts = convert.state_from_params(
        {n: np.asarray(getattr(js, n))
         for n in ("control_mean", "control_history", "previous_baseline")}, tc)
    x0 = _x0("steering")
    jres, jnew = jc.solve(jnp.asarray(x0), js, 1)
    tres, tnew = tc.solve(torch.from_numpy(x0), ts, 1, injected_noise=torch.from_numpy(eps))
    jcosts = np.sort(np.asarray(jres.costs))
    n_elite = max(int(np.floor(np.float32(jc.cem_elite_fraction) * K)), 1)
    gap = min(jcosts[n_elite] - jcosts[n_elite - 1], jcosts[n_elite - 1] - jcosts[n_elite - 2])
    assert gap > 2 * (1e-4 + 1e-4 * abs(jcosts[n_elite])), gap

    def close(t, j, rtol, atol, what):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol,
                                   err_msg=what)

    close(tres.costs, jres.costs, 1e-4, 1e-4, "costs")
    assert np.array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    assert 0 < int(np.asarray(jres.crash).sum()) < K  # some samples crash, some do not
    close(tres.baseline, jres.baseline, 1e-5, 0, "baseline")
    close(tres.control_mean, jres.control_mean, 1e-4, 1e-5, "control mean")
    close(tnew.control_mean, jnew.control_mean, 1e-4, 1e-5, "new control mean")
    assert float(tres.weights.sum()) == n_elite
