"""The port's counterpart of JAX's kernel fallbacks, on the CPU: where the
JAX package's kernels raise ``PallasIncompatible`` and its controllers run
XLA, the port's wrappers raise ``ops.KernelIncompatible`` and its
controllers run their eager path. Each catch site's configuration against
the JAX package's result on the same injected noise:

* the colored sampler on ``fused_solve`` against JAX ``pallas_fused``
  (both kernels refuse it; the eager draw and ``rollout_combined``);
* ``split_cost=True`` with a cost that is not time-parallel (the Dubins car
  with a ``QuadraticCost`` goal trajectory) on ``fused`` against JAX
  ``pallas`` with ``pallas_split_cost=True`` (B1 refuses it; the eager
  rollout);
* RMPPI on the racer LSTM-steering model against JAX ``pallas``: stage 1 in
  B1's per-sample-x0 mode (the plain version here), stage 2's B8 refusing
  the recurrent model in both packages, the eager augmented rollout.

It also holds that the port raises where JAX raises (each condition checked
before any launch), that a pair without an entry still raises a plain
``NotImplementedError``, and that the kernel tuner still skips what the
kernels refuse. Tolerances: the colored and Dubins solves rtol 1e-5 / atol
1e-5 (costs) and 1e-4 / 1e-5 (weights, means); the racer's costs rtol / atol
1e-4 (its LSTM and head sums in other orders, as
test_torch_racer_kernels.py), its means within 2 max|dJ| / lambda of the
samples' spread (the rule of test_torch_robust_family_solve.py); crash
flags, the chosen candidate and its stride exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import RobustMPPI as JRobust
from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.ops.pallas_rollout import PallasIncompatible
from mppi_generic_tpu.sampling import ColoredNoiseDistribution as JColored
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import SmoothMPPIDistribution as JSmooth
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.ops import KernelIncompatible, autotune
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.sampling import ColoredNoiseDistribution, SmoothMPPIDistribution
from test_torch_colored import X0 as COLORED_X0
from test_torch_colored import _jax_controller, _port_of, jax_normals
from test_torch_racer_kernels import _setup as racer_setup
from test_torch_racer_kernels import _x0 as racer_x0
from test_torch_robust_family_solve import (
    SAMPLER_FIELDS,
    _compare_system,
    _params,
    _patch_noise,
)
from test_torch_zoo import jax_cost_params, jax_fields, jax_model_params, port_of, zoo_pair

DT = 0.02


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


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


def test_colored_fused_solve_matches_jax_pallas_fused(monkeypatch, fresh_jit_cache,
                                                      one_thread):
    K, T, stride = 256, 16, 1
    key = jax.random.PRNGKey(23)
    orig = JColored._draw_noise
    monkeypatch.setattr(JColored, "_draw_noise",
                        lambda self, k, m, n, s=0: orig(self, key, m, n, s))
    jc = _jax_controller("pallas_fused", "exp", K=K, T=T)
    mean = np.random.default_rng(3).normal(scale=0.3, size=(T, 2)).astype(np.float32)
    js = jc.init_state(jax.random.PRNGKey(0)).replace(control_mean=jnp.asarray(mean))
    jres, jnew = jc.solve(jnp.asarray(COLORED_X0), js, stride)
    tc = _port_of(jc, "fused_solve")
    ts = convert.state_from_params(
        {n: np.asarray(getattr(js, n))
         for n in ("control_mean", "control_history", "previous_baseline")}, tc)
    fr.reset_launch_counts()
    tres, tnew = tc.solve(torch.from_numpy(COLORED_X0), ts, stride,
                          injected_noise=torch.from_numpy(jax_normals(key, K, 2, T)))
    assert not any(fr.launch_counts.values())
    _close(tres.costs, jres.costs, 1e-5, 1e-5, "costs")
    np.testing.assert_array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    _close(tres.weights, jres.weights, 1e-4, 1e-5, "weights")
    _close(tres.control_mean, jres.control_mean, 1e-4, 1e-5, "control mean")
    _close(tnew.control_mean, jnew.control_mean, 1e-4, 1e-5, "new control mean")


def test_split_true_on_an_ineligible_cost_falls_back_as_jax(monkeypatch, fresh_jit_cache,
                                                            one_thread):
    """The Dubins car tracking a goal trajectory (not time-parallel) with
    split_cost=True: B1 refuses it in both packages and both controllers
    run the eager rollout with the LR cost."""
    K, T = 128, 12
    eps = np.random.default_rng(8).normal(size=(K, T, 2)).astype(np.float32)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, m, n, s=0: jnp.asarray(eps))
    jdyn, jcost, x0, std, _ = zoo_pair("dubins_trajectory")
    dyn, cost = port_of(jdyn, jcost)
    with pytest.raises(KernelIncompatible, match="time_parallel"):
        fr.fused_rollout_costs(dyn, cost, torch.from_numpy(x0), torch.zeros((K, T, 2)), DT,
                               split_cost=True)
    with pytest.raises(PallasIncompatible):
        pallas_rollout.fused_rollout_costs(jdyn, jcost, jnp.asarray(x0),
                                           jnp.zeros((K, T, 2)), DT, split_cost=True)
    jsamp = JGaussian.create(std_dev=std, control_cost_coeff=[0.5, 0.5])
    jc = JVanilla(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(DT),
                  lam=jnp.float32(1.0), alpha=jnp.float32(0.1), num_timesteps=T,
                  num_rollouts=K, num_iters=1, kernel="pallas", pallas_split_cost=True)
    tc = convert.vanilla_from_params(
        jax_model_params(jdyn), jax_cost_params(jcost), jax_fields(jsamp, SAMPLER_FIELDS),
        dict(dt=DT, lam=1.0, alpha=0.1, num_timesteps=T, num_rollouts=K, num_iters=1,
             pallas_split_cost=True),
        device="cpu", kernel="fused", dynamics_kind="dubins", cost_kind="quadratic")
    assert tc.split_cost is True
    mean = np.random.default_rng(9).normal(scale=0.3, size=(T, 2)).astype(np.float32)
    jres, _ = jc.solve(jnp.asarray(x0), jc.init_state(jax.random.PRNGKey(0),
                                                      initial_mean=jnp.asarray(mean)))
    tres, _ = tc.solve(torch.from_numpy(x0), tc.init_state(0, initial_mean=mean),
                       injected_noise=torch.from_numpy(eps))
    _close(tres.costs, jres.costs, 1e-5, 1e-5, "costs")
    _close(tres.weights, jres.weights, 1e-4, 1e-5, "weights")
    _close(tres.control_mean, jres.control_mean, 1e-4, 1e-5, "control mean")


def test_rmppi_on_the_racer_matches_jax(monkeypatch, fresh_jit_cache, one_thread):
    """One RMPPI cycle on the racer LSTM-steering model (its elevation map,
    the track map with a hot block): K = 32, T = 6, 3 candidates x 8
    samples, DDP on its eager scan (S = 9) in both packages."""
    K, T, n_cand, s_per = 32, 6, 3, 8
    rng = np.random.default_rng(41)
    eps = {n: rng.normal(size=(n, T, 2)).astype(np.float32) for n in (s_per, K)}
    _patch_noise(monkeypatch, eps)
    (jdyn, jcost, jsamp), (dyn, cost, _) = racer_setup("steering")
    jc = JRobust(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(DT),
                 lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T,
                 num_rollouts=K, num_candidates=n_cand, samples_per_condition=s_per,
                 feedback=JDDP.create(jdyn, DT), kernel="pallas")
    from mppi_generic_tpu_torch import DDPFeedback, RobustMPPI
    tc = RobustMPPI(dyn, cost, convert.gaussian_from_params(_params(jsamp, SAMPLER_FIELDS)),
                    feedback=DDPFeedback.create(dyn, DT), dt=DT, lam=1.0, alpha=0.0,
                    num_timesteps=T, num_rollouts=K, num_candidates=n_cand,
                    samples_per_condition=s_per, device="cpu")
    x = racer_x0("steering")
    with pytest.raises(KernelIncompatible, match="recurrent"):
        fr.fused_rmppi_rollout(dyn, cost, torch.from_numpy(x), torch.from_numpy(x),
                               torch.zeros((K, T, 2)), torch.zeros((T, 2, 9)),
                               torch.ones((T, 2)), torch.ones(2), DT, 1.0, 0.0)
    js, ts = jc.init_state(jax.random.PRNGKey(0)), tc.init_state(0)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for cycle in range(2):  # the first initialises the nominal system
        js, jfe = jc.update_importance_sampling(jx, js, 1)
        jres, js = jc.solve(jx, js)
        ts, tfe = tc.update_importance_sampling(tx, ts, 1,
                                                injected_noise=torch.from_numpy(eps[s_per]))
        tres, ts = tc.solve(tx, ts, injected_noise=torch.from_numpy(eps[K]))
        assert int(ts.best_index) == int(js.best_index)
        assert int(ts.nominal_stride) == int(js.nominal_stride)
        _close(tfe, jfe, 1e-4, 1e-3, f"cycle {cycle} candidate free energy")
        U = tc._clamp_controls(torch.from_numpy(eps[K]) * tc.sampler.std_dev
                               + ts.nominal_mean)
        for system in ("real", "nominal"):
            _compare_system(getattr(tres, system), getattr(jres, system), U, 1.0, T,
                            (1e-4, 1e-4), f"cycle {cycle} {system}")


def test_the_port_raises_where_jax_raises():
    """Each of JAX's semantic conditions, checked before any launch: the
    weight kind the epilogue does not take, Smooth-MPPI without its state,
    a sampler the in-kernel draw does not take; the split refusal and the
    recurrent B8 are in the tests above. A missing pair entry is a plain
    NotImplementedError, never a KernelIncompatible, and KernelIncompatible
    is what the tuner skips."""
    from test_torch_sample_pairs import pair_parts
    jdyn, jcost, dyn, cost, x0, *_ = pair_parts("di_quadratic")
    K, T = 64, 8
    U = torch.zeros((K, T, 2))
    with pytest.raises(KernelIncompatible, match="weight_kind"):
        fr.fused_weighted_rollout(dyn, cost, torch.from_numpy(x0), U, DT, 1.0,
                                  weight_kind="cem")
    with pytest.raises(PallasIncompatible):
        pallas_rollout.fused_weighted_rollout(jdyn, jcost, jnp.asarray(x0),
                                              jnp.zeros((K, T, 2)), DT, 1.0,
                                              weight_kind="cem")
    smooth = SmoothMPPIDistribution.create(std_dev=[1.0, 1.0], num_timesteps=T)
    with pytest.raises(KernelIncompatible, match="sampler_state"):
        fr.fused_sample_rollout_costs(dyn, cost, smooth, torch.from_numpy(x0),
                                      torch.zeros((T, 2)), 0, DT, 1.0, 0.0, K)
    with pytest.raises(PallasIncompatible):
        pallas_rollout.fused_sample_rollout_costs(
            jdyn, jcost, JSmooth.create(std_dev=[1.0, 1.0], num_timesteps=T),
            jnp.asarray(x0), jnp.zeros((T, 2)), jnp.int32(0), DT, 1.0, 0.0, K,
            injected_noise=jnp.zeros((K, T, 2)))
    colored = ColoredNoiseDistribution.create(exponents=[1.0, 1.0], std_dev=[1.0, 1.0])
    with pytest.raises(KernelIncompatible, match="ColoredNoiseDistribution"):
        fr.fused_sample_rollout_costs(dyn, cost, colored, torch.from_numpy(x0),
                                      torch.zeros((T, 2)), 0, DT, 1.0, 0.0, K)
    assert issubclass(KernelIncompatible, NotImplementedError)

    class Unknown(type(cost)):
        pass

    with pytest.raises(NotImplementedError, match="no CUDA") as e:
        fr._entry(dyn, object.__new__(Unknown), "rmppi")
    assert not isinstance(e.value, KernelIncompatible)


def test_the_tuner_still_skips_what_the_kernels_refuse(monkeypatch, tmp_path):
    """The tuner's gate refuses fused_solve for a sampler the kernels do not
    draw, and a candidate whose timing raises KernelIncompatible is skipped
    as any NotImplementedError is."""
    from mppi_generic_tpu_torch import GaussianDistribution, VanillaMPPI
    from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
    from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
    monkeypatch.setenv("MPPI_TUNE_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_DISK", None)
    parts = (DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost())
    colored = ColoredNoiseDistribution.create(exponents=[1.0, 1.0], std_dev=[1.0, 1.0])
    ctrl = VanillaMPPI(*parts, colored, num_timesteps=8, num_rollouts=32, device="cpu")
    assert not autotune._kernel_supported(ctrl, "fused_solve")
    gauss = VanillaMPPI(*parts, GaussianDistribution.create(std_dev=[1.0, 1.0]),
                        num_timesteps=8, num_rollouts=32, device="cpu")
    real = autotune.time_solve

    def time_solve(c, *args, **kw):
        if c.kernel == "fused":
            raise KernelIncompatible("refused")
        return real(c, *args, **kw)

    monkeypatch.setattr(autotune, "time_solve", time_solve)
    timings = {}
    tuned = autotune.choose_appropriate_kernel(gauss, torch.tensor([2.0, 0.0, 0.0, 1.0]),
                                               num_evaluations=1,
                                               candidates=("fused", "combined"),
                                               timings=timings)
    assert set(timings) == {"combined"} and tuned.kernel == "combined"


@pytest.mark.parametrize("kind", ["steering", "unc"])
def test_racer_batched_step_starts_each_column_from_the_warm_state(kind):
    """The racer models' stateless ``step`` of a batch (S, K), which RMPPI's
    eager augmented rollout takes on every sample: each column from the warm
    (h, c), equal to the JAX model's step of that column alone (the JAX
    rollout vmaps it). Before the port broadcast the warm state, a batch
    raised in the LSTM (the fault of ROADMAP.md section 3 this slice fixed).
    rtol / atol 1e-5 (the LSTM's matmul in another order)."""
    (jdyn, _, _), (dyn, _, _) = racer_setup(kind)
    rng = np.random.default_rng(17)
    x0 = racer_x0(kind)
    X = (x0[:, None] + 0.1 * rng.normal(size=(x0.shape[0], 3))).astype(np.float32)
    U = (0.3 * rng.normal(size=(2, 3))).astype(np.float32)
    tx, ty = dyn.step(torch.from_numpy(X), torch.from_numpy(U), 0.0, DT)
    # each column alone, as the JAX augmented rollout vmaps its samples
    jx, jy = jax.jit(jax.vmap(lambda x, u: jdyn.step(x, u, 0.0, DT), in_axes=1,
                              out_axes=1))(jnp.asarray(X), jnp.asarray(U))
    _close(tx, jx, 1e-5, 1e-5, "states")
    _close(ty, jy, 1e-5, 1e-5, "outputs")
