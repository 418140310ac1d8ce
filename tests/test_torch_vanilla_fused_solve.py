"""The slice as a whole: ``VanillaMPPI(kernel="fused_solve")`` of the port
(the kernels' plain versions, injected noise) against the JAX package's
``kernel="pallas_fused"`` solve for the Gaussian, NLN and Smooth-MPPI
samplers, with normExp and CEM weights. Off the TPU the JAX controller takes
its XLA sampling path with the patched ``_draw_noise``; both packages get
the same standard normals. Also: Smooth-MPPI's derivative mean carried
through a slide -> solve loop, a CPU closed loop of the NLN configuration,
and the refusals of paths that are not ported."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import NLNDistribution as JNLN
from mppi_generic_tpu.sampling import SmoothMPPIDistribution as JSmooth
from mppi_generic_tpu_torch import (
    ColoredNoiseDistribution,
    NLNDistribution,
    SmoothMPPIDistribution,
    TubeMPPI,
    VanillaMPPI,
    convert,
)
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics

K, T, C = 300, 24, 2
RTOL = ATOL = 1e-5
X0 = np.array([2.0, 0.05, -0.1, 1.0], np.float32)
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")
DYN_FIELDS = ("control_ranges", "control_deadband", "zero_control", "system_noise")

# noise seeds whose CEM threshold is clear of its neighbours (see the test)
CEM_SEEDS = {"gaussian": 30, "nln": 32, "smooth": 30}

CONFIGS = {
    "flagship": dict(p=0.0, lam=1.0, alpha=0.0, stride=0, iters=1),
    # pure-noise tail, alpha, a frozen head and two iterations
    "carveouts": dict(p=0.25, lam=1.3, alpha=0.1, stride=2, iters=2),
}


def _jax_sampler(kind, p, dt_smooth):
    kw = dict(std_dev=[1.0, 0.8], control_cost_coeff=[0.01, 0.02],
              pure_noise_percentage=p)
    if kind == "nln":
        return JNLN.create(**kw)
    if kind == "smooth":
        return JSmooth.create(num_timesteps=T, dt=dt_smooth, **kw)
    return JGaussian.create(**kw)


def _jax_controller(kind, cfg, transform, dt_smooth=0.05):
    return JVanilla(
        dynamics=JDI.create(control_ranges=[[-2.5, 2.5], [-2.0, 2.0]]),
        cost=JCircle(), sampler=_jax_sampler(kind, cfg["p"], dt_smooth),
        dt=jnp.float32(0.02), lam=jnp.float32(cfg["lam"]),
        alpha=jnp.float32(cfg["alpha"]), num_timesteps=T, num_rollouts=K,
        num_iters=cfg["iters"], kernel="pallas_fused", weight_transform=transform,
    )


def _params(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def _port_of(jc, kind, transform, kernel="fused_solve"):
    sampler = _params(jc.sampler, SAMPLER_FIELDS)
    if kind == "smooth":
        sampler.update(dt_smooth=np.asarray(jc.sampler.dt_smooth), num_timesteps=T)
    return convert.vanilla_from_params(
        _params(jc.dynamics, DYN_FIELDS),
        _params(jc.cost, DoubleIntegratorCircleCost.PARAM_NAMES), sampler,
        dict(dt=jc.dt, lam=jc.lam, alpha=jc.alpha, num_timesteps=T, num_rollouts=K,
             num_iters=jc.num_iters, cem_elite_fraction=jc.cem_elite_fraction),
        device="cpu", kernel=kernel, sampler_kind=kind, weight_transform=transform)


def _noise(kind, seed):
    """(numpy normals for the port, the JAX sampler class to patch, the eps
    its _draw_noise returns)."""
    rng = np.random.default_rng(seed)
    if kind == "nln":
        Z = rng.normal(size=(2, K, T, C)).astype(np.float32)
        eps = jnp.asarray(Z[0]) * jnp.exp(jnp.asarray([1.0, 0.8]) * jnp.asarray(Z[1]))
        return Z, JNLN, eps
    Z = rng.normal(size=(K, T, C)).astype(np.float32)
    return Z, JGaussian, jnp.asarray(Z)


def _states(jc, tc, kind, seed=0):
    rng = np.random.default_rng(seed)
    js = jc.init_state(jax.random.PRNGKey(0)).replace(
        control_mean=jnp.asarray(rng.normal(scale=0.3, size=(T, C)), jnp.float32),
        control_history=jnp.asarray(rng.normal(scale=0.3, size=(2, C)), jnp.float32))
    if kind == "smooth":
        js = js.replace(sampler_state=jnp.asarray(rng.normal(scale=0.5, size=(T, C)),
                                                  jnp.float32))
    p = _params(js, ("control_mean", "control_history", "previous_baseline"))
    p["sampler_state"] = None if js.sampler_state is None else np.asarray(js.sampler_state)
    return js, convert.state_from_params(p, tc)


@pytest.fixture
def fresh_jit_cache():
    """solve is jitted: a cached trace would ignore the patched noise, and
    the patched trace must not reach later tests."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _compare(tres, tnew, jres, jnew, lam):
    def close(t, j, rtol=RTOL, atol=ATOL, what=""):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol,
                                   err_msg=what)

    close(tres.control_mean, jres.control_mean, what="control_mean")
    close(tres.costs, jres.costs, what="costs")
    # a weight moves by |dJ| / lambda: the costs' tolerance times |J| / lambda
    w_tol = RTOL * float(np.abs(np.asarray(jres.costs)).max()) / lam
    close(tres.weights, jres.weights, rtol=w_tol, atol=w_tol, what="weights")
    close(tres.baseline, jres.baseline, what="baseline")
    close(tres.normalizer, jres.normalizer, rtol=w_tol, what="normalizer")
    close(tres.state_trajectory, jres.state_trajectory, what="state_trajectory")
    assert np.array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    close(tnew.control_mean, jnew.control_mean, what="new control_mean")
    if jnew.sampler_state is None:
        assert tnew.sampler_state is None
    else:
        close(tnew.sampler_state, jnew.sampler_state, what="sampler_state")


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["gaussian", "nln", "smooth"])
def test_fused_solve_matches_jax_pallas_fused(kind, name, monkeypatch, fresh_jit_cache):
    cfg = CONFIGS[name]
    Z, patched, eps = _noise(kind, seed=len(kind) + cfg["stride"])
    monkeypatch.setattr(patched, "_draw_noise", lambda self, key, m, n, s=0: eps)
    jc = _jax_controller(kind, cfg, "exp")
    tc = _port_of(jc, kind, "exp")
    js, ts = _states(jc, tc, kind)
    jres, jnew = jc.solve(jnp.asarray(X0), js, cfg["stride"])
    tres, tnew = tc.solve(torch.from_numpy(X0), ts, cfg["stride"],
                          injected_noise=torch.from_numpy(Z))
    _compare(tres, tnew, jres, jnew, cfg["lam"])


@pytest.mark.parametrize("kind", ["gaussian", "nln", "smooth"])
def test_fused_solve_cem_matches_jax_pallas_fused(kind, monkeypatch, fresh_jit_cache):
    """CEM weights are a step function of the costs: the solves agree where
    the elite threshold is further from its neighbours than the costs'
    tolerance, which the test checks before it compares (one iteration,
    since the first one's threshold would be out of sight)."""
    cfg = dict(CONFIGS["carveouts"], iters=1)
    Z, patched, eps = _noise(kind, seed=CEM_SEEDS[kind])
    monkeypatch.setattr(patched, "_draw_noise", lambda self, key, m, n, s=0: eps)
    # a wide Smooth-MPPI step spreads the costs apart
    jc = _jax_controller(kind, cfg, "cem", dt_smooth=0.5)
    tc = _port_of(jc, kind, "cem")
    js, ts = _states(jc, tc, kind, seed=1)
    jres, jnew = jc.solve(jnp.asarray(X0), js, cfg["stride"])
    tres, tnew = tc.solve(torch.from_numpy(X0), ts, cfg["stride"],
                          injected_noise=torch.from_numpy(Z))
    jcosts = np.sort(np.asarray(jres.costs))
    n_elite = max(int(np.floor(np.float32(0.1) * K)), 1)
    gap = min(jcosts[n_elite] - jcosts[n_elite - 1],
              jcosts[n_elite - 1] - jcosts[n_elite - 2])
    assert gap > 2 * (ATOL + RTOL * abs(jcosts[n_elite])), gap
    _compare(tres, tnew, jres, jnew, cfg["lam"])
    assert float(tres.weights.sum()) == n_elite


def test_smooth_loop_carries_the_derivative_mean(monkeypatch, fresh_jit_cache):
    """Three slide -> solve steps: the derivative mean is slid with the
    control mean and carried from one solve to the next, as in JAX."""
    cfg = CONFIGS["flagship"]
    Z, patched, eps = _noise("smooth", seed=40)
    monkeypatch.setattr(patched, "_draw_noise", lambda self, key, m, n, s=0: eps)
    jc = _jax_controller("smooth", cfg, "exp")
    tc = _port_of(jc, "smooth", "exp")
    js, ts = _states(jc, tc, "smooth", seed=2)
    jx, tx = jnp.asarray(X0), torch.from_numpy(X0)
    seen = []
    for _ in range(3):
        js = jc.slide_control_sequence(js, 1)
        ts = tc.slide_control_sequence(ts, 1)
        np.testing.assert_allclose(ts.sampler_state.numpy(),
                                   np.asarray(js.sampler_state), rtol=1e-5, atol=1e-5)
        jres, js = jc.solve(jx, js, 0)
        tres, ts = tc.solve(tx, ts, 0, injected_noise=torch.from_numpy(Z))
        np.testing.assert_allclose(tres.control_mean.numpy(),
                                   np.asarray(jres.control_mean), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ts.sampler_state.numpy(),
                                   np.asarray(js.sampler_state), rtol=1e-5, atol=1e-5)
        seen.append(ts.sampler_state.clone())
        jx, _ = jc.dynamics.step(jx, jres.control_mean[0], 0.0, jc.dt)
        tx, _ = tc.dynamics.step(tx, tres.control_mean[0], 0.0, tc.dt)
    assert not torch.equal(seen[0], seen[1]) and bool(seen[-1].abs().sum() > 0)


@pytest.fixture
def one_thread():
    """The plain versions run thousands of small operations per solve; with
    the suite's parallel workers, PyTorch's intra-op threads would contend
    for the cores on each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_nln_closed_loop_stays_on_the_band(one_thread):
    """The nln_logmppi_di_K8192 configuration (bench.py:619-628) at K=1024
    on the CPU: 50 slide -> solve -> step iterations of the fused solve's
    plain version stay inside 1.5 < r < 2.5."""
    ctrl = VanillaMPPI(
        DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
        NLNDistribution.create(std_dev=[1.0, 1.0]), dt=0.02, lam=1.0, alpha=0.0,
        num_timesteps=100, num_rollouts=1024, kernel="fused_solve", device="cpu")
    cs = ctrl.init_state(seed=0)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0])
    radii = []
    for _ in range(50):
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        x, _ = ctrl.dynamics.step(x, res.control_mean[0], 0.0, ctrl.dt)
        radii.append(float(torch.hypot(x[0], x[1])))
    assert all(1.5 < r < 2.5 for r in radii), radii
    assert torch.isfinite(res.control_mean).all() and res.costs.shape == (1024,)


def test_paths_not_ported_raise():
    """The configurations the port refused before JAX's fallbacks were
    ported now run: the colored sampler and a sampler the kernels do not
    draw (a subclass) on ``fused_solve`` take the eager draw and rollout, so
    with the same normals they give ``kernel="combined"``'s solve to the
    last bit (JAX pallas_fused falls back to XLA there, vanilla.py:187-253);
    Tube-MPPI takes Smooth-MPPI's state."""
    parts = (DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost())
    x = torch.tensor([2.0, 0.0, 0.0, 1.0])
    colored = ColoredNoiseDistribution.create(exponents=[1.0, 1.0], std_dev=[1.0, 1.0])

    class OtherSampler(NLNDistribution):
        pass

    other = OtherSampler.create(std_dev=[1.0, 1.0])
    z = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 16, 2, 9)).astype("f"))
    for samp, noise in ((colored, z), (other, z[:, :, :, :8].transpose(2, 3))):
        res = {}
        for kernel in ("fused_solve", "combined"):
            ctrl = VanillaMPPI(*parts, samp, kernel=kernel, num_timesteps=8,
                               num_rollouts=16, device="cpu")
            res[kernel], _ = ctrl.solve(x, ctrl.init_state(), injected_noise=noise)
        assert torch.equal(res["fused_solve"].control_mean, res["combined"].control_mean)
        assert torch.equal(res["fused_solve"].costs, res["combined"].costs)
    tube = TubeMPPI(*parts, SmoothMPPIDistribution.create(std_dev=[1.0, 1.0],
                                                          num_timesteps=8),
                    num_timesteps=8, num_rollouts=16, device="cpu")
    cs = tube.init_state()
    res, cs = tube.solve(x, tube.slide_control_sequence(cs, 1))
    assert cs.sampler_state.shape == (8, 2) and torch.isfinite(res.real.control_mean).all()


def test_return_samples_keeps_the_clamped_samples():
    ctrl = VanillaMPPI(
        DoubleIntegratorDynamics.create(control_ranges=[[-0.5, 0.5], [-0.5, 0.5]]),
        DoubleIntegratorCircleCost(), NLNDistribution.create(std_dev=[1.0, 1.0]),
        num_timesteps=8, num_rollouts=64, kernel="fused_solve", return_samples=True,
        device="cpu")
    res, _ = ctrl.solve(torch.tensor([2.0, 0.0, 0.0, 1.0]), ctrl.init_state(seed=3))
    U = res.sampled_controls
    assert U.shape == (64, 8, 2) and float(U.abs().max()) <= 0.5
    assert bool((U.abs() == 0.5).any())
