"""The colored-noise slice on the CPU: the port's power-law noise, colored
sampler, shaping functions, risk measures, state leash and one
``VanillaMPPI`` / ``ColoredMPPI`` solve per path and weight transform,
against the JAX package.

The JAX draws are made in the test from a fixed key, split as
``powerlaw_psd_gaussian`` splits it (colored.py:73-75), and handed to the
port as its injected frequency normals (2, K, C, F); drawn samples are never
compared across packages. For the solves JAX's
``ColoredNoiseDistribution._draw_noise`` is patched to that fixed key.

Tolerances: the noise rtol 0 / atol 2e-6 relative to max |y| (the two sides
sum the F = T + 1 frequencies in another order, and XLA's and PyTorch's CPU
cos, sin and pow may differ by an ulp; measured below 5e-7); shaping and
risk rtol 1e-6; the solves as tests/test_torch_vanilla.py (rtol / atol 1e-5)
for normExp and the Tsallis costs, the Tsallis weights and means rtol 1e-4 /
atol 1e-5 (a weight (1 - dJ / gamma)^(1 / (r - 1)) near the cut moves by
dJ / gamma relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import ColoredMPPI as JColoredMPPI
from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.sampling import ColoredNoiseDistribution as JColored
from mppi_generic_tpu.sampling.colored import powerlaw_psd_gaussian as j_powerlaw
from mppi_generic_tpu.shaping import CEMShapingFunction as JCEM
from mppi_generic_tpu.shaping import ShapingFunction as JNormExp
from mppi_generic_tpu.shaping import TsallisShapingFunction as JTsallis
from mppi_generic_tpu.utils import risk as jrisk
from mppi_generic_tpu_torch import ColoredMPPI, ColoredNoiseDistribution, VanillaMPPI, convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.sampling.colored import frequency_count, powerlaw_psd_gaussian
from mppi_generic_tpu_torch.utils import risk

SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay", "exponents", "offset_decay_rate", "fmin")
X0 = np.array([2.0, 0.05, -0.1, 1.0], np.float32)


def jax_normals(key, K, C, T):
    """The (2, K, C, F) normals ``powerlaw_psd_gaussian`` draws from ``key``."""
    kr, ki = jax.random.split(key)
    F = frequency_count(T)
    return np.stack([np.asarray(jax.random.normal(kr, (K, C, F))),
                     np.asarray(jax.random.normal(ki, (K, C, F)))])


def jax_sampler_params(s):
    return {n: np.asarray(getattr(s, n)) for n in SAMPLER_FIELDS}


def _noise_close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= 2e-6 * np.abs(want).max(), (err, np.abs(want).max())


# --- power-law noise ----------------------------------------------------------
NOISE_CASES = {
    # name: (exponents, T, K, fmin, offset_t, offset_decay)
    "white pink, even T": ([0.0, 1.0], 16, 64, 0.0, 0, 0.0),
    "brown, odd T, offset": ([2.0, 2.0], 15, 64, 0.0, 3, 0.97),
    "fmin above the first frequency": ([1.0, 2.0], 16, 48, 0.1, 2, 0.5),
    "three channels, offset past T": ([1.0, 0.0, 2.0], 9, 32, 0.0, 20, 0.97),
    "long horizon (irfft)": ([1.0], 2100, 3, 0.0, 5, 0.97),
}


@pytest.mark.parametrize("name", sorted(NOISE_CASES))
def test_powerlaw_psd_gaussian_matches_jax(name):
    exps, T, K, fmin, off, decay = NOISE_CASES[name]
    key = jax.random.PRNGKey(len(name))
    want = jax.jit(j_powerlaw, static_argnums=(2, 3))(
        key, jnp.asarray(exps), T, K, fmin=fmin, offset_t=off,
        offset_decay=jnp.float32(decay))
    z = torch.from_numpy(jax_normals(key, K, len(exps), T))
    got = powerlaw_psd_gaussian(None, exps, T, K, fmin=fmin, offset_t=off,
                                offset_decay=decay, normals=z)
    assert got.shape == (K, T, len(exps)) and got.is_contiguous()
    _noise_close(got, want)


def test_powerlaw_draw_is_unit_variance_and_reproducible():
    g = torch.Generator().manual_seed(3)
    y = powerlaw_psd_gaussian(g, [1.0, 2.0], 64, 4096)
    again = powerlaw_psd_gaussian(torch.Generator().manual_seed(3), [1.0, 2.0], 64, 4096)
    assert torch.equal(y, again)
    std = y.std(dim=(0, 1))
    assert bool(((std > 0.8) & (std < 1.2)).all()), std
    with pytest.raises(ValueError, match="normals"):
        powerlaw_psd_gaussian(None, [1.0], 8, 4, normals=torch.zeros(2, 4, 1, 8))


# --- the sampler --------------------------------------------------------------
@pytest.mark.parametrize("stride,iteration", [(0, 0), (2, 1)])
def test_colored_sample_matches_jax(stride, iteration):
    """Carve-outs (sample 0 and the frozen head are the mean, a pure-noise
    tail), the decayed sigma and the re-anchoring at the stride."""
    K, T, C = 96, 12, 2
    js = JColored.create(exponents=[1.0, 2.0], std_dev=[1.0, 0.7],
                         control_cost_coeff=[0.02, 0.5], pure_noise_percentage=0.25,
                         std_dev_decay=0.9, offset_decay_rate=0.9)
    ts = convert.colored_from_params(jax_sampler_params(js))
    mean = np.random.default_rng(1).normal(scale=0.4, size=(T, C)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jU, jaux = jax.jit(js.sample, static_argnums=2, static_argnames="iteration")(
        key, jnp.asarray(mean), K, iteration=iteration, optimization_stride=stride)
    tU, taux = ts.sample(None, torch.from_numpy(mean), K, iteration=iteration,
                         optimization_stride=stride,
                         injected_noise=torch.from_numpy(jax_normals(key, K, C, T)))
    assert jaux is None and taux is None
    _noise_close(tU, jU)
    assert torch.equal(tU[0], torch.from_numpy(mean))
    if stride:
        assert torch.equal(tU[5, :stride], torch.from_numpy(mean[:stride]))
    lr_t = ts.likelihood_ratio_cost(tU, torch.from_numpy(mean), 1.3, 0.1, iteration)
    lr_j = js.likelihood_ratio_cost(jnp.asarray(tU.numpy()), jnp.asarray(mean), 1.3,
                                    0.1, iteration=iteration)
    np.testing.assert_allclose(lr_t.numpy(), np.asarray(lr_j), rtol=1e-5, atol=1e-5)


# --- shaping and risk ---------------------------------------------------------
SHAPING = {
    "norm_exp": (lambda: JNormExp(lam=jnp.float32(1.3)), {"lam": 1.3}),
    "tsallis": (lambda: JTsallis(gamma=jnp.float32(5.0), r=jnp.float32(2.4)),
                {"gamma": 5.0, "r": 2.4}),
    "tsallis small gamma": (lambda: JTsallis(gamma=jnp.float32(0.3), r=jnp.float32(2.0)),
                            {"gamma": 0.3, "r": 2.0}),
    "cem": (lambda: JCEM(elite_fraction=jnp.float32(0.1)), {"elite_fraction": 0.1}),
}


@pytest.mark.parametrize("name", sorted(SHAPING))
@pytest.mark.parametrize("with_baseline", [False, True])
def test_shaping_functions_match_jax(name, with_baseline):
    make, params = SHAPING[name]
    costs = np.random.default_rng(4).uniform(0.0, 8.0, size=(300,)).astype(np.float32)
    base = np.float32(costs.min() - 0.25) if with_baseline else None
    want = make().compute_weights(jnp.asarray(costs),
                                  None if base is None else jnp.asarray(base))
    shaping = convert.shaping_from_params(params, name.split(" ")[0])
    got = shaping.compute_weights(torch.from_numpy(costs),
                                  None if base is None else torch.tensor(base))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    if name == "tsallis small gamma":
        assert bool((got == 0).any()) and bool((got > 0).any())


@pytest.mark.parametrize("kind", ["mean", "median", "min", "max", "var", "cvar"])
@pytest.mark.parametrize("K", [255, 256])
def test_risk_measures_match_jax(kind, K):
    """An even K too: the median averages the two middle costs, as jnp.median."""
    costs = np.random.default_rng(K).exponential(2.0, size=(3, K)).astype(np.float32)
    for alpha in (0.5, 0.9):
        want = jrisk.risk_measure(jnp.asarray(costs), kind, alpha)
        got = risk.risk_measure(torch.from_numpy(costs), kind, alpha)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if kind == "median" and K % 2 == 0:
        srt = np.sort(costs, axis=-1)
        mid = 0.5 * (srt[:, K // 2 - 1] + srt[:, K // 2])
        np.testing.assert_allclose(got.numpy(), mid, rtol=1e-6)
    with pytest.raises(ValueError, match="risk"):
        risk.risk_measure(torch.from_numpy(costs), "mode")


# --- leash --------------------------------------------------------------------
def _jax_controller(kernel="pallas", transform="exp", gamma=10.0, r=2.0, K=256, T=16,
                    leash=None, iters=1):
    return JColoredMPPI(
        dynamics=JDI.create(), cost=JCircle(),
        sampler=JColored.create(exponents=[1.0, 2.0], std_dev=[1.0, 0.8],
                                control_cost_coeff=[0.02, 0.01],
                                pure_noise_percentage=0.1),
        dt=jnp.float32(0.02), lam=jnp.float32(1.0), alpha=jnp.float32(0.0),
        num_timesteps=T, num_rollouts=K, num_iters=iters, kernel=kernel,
        weight_transform=transform, tsallis_gamma=jnp.float32(gamma),
        tsallis_r=jnp.float32(r), pallas_tile_k=128,
        state_leash_dist=None if leash is None else jnp.asarray(leash, jnp.float32))


def _port_of(jc, kernel, transform="exp"):
    dyn_names = ("control_ranges", "control_deadband", "zero_control", "system_noise")
    leash = jc.state_leash_dist
    return convert.colored_mppi_from_params(
        {n: np.asarray(getattr(jc.dynamics, n)) for n in dyn_names},
        {n: np.asarray(getattr(jc.cost, n)) for n in DoubleIntegratorCircleCost.PARAM_NAMES},
        jax_sampler_params(jc.sampler),
        dict(dt=jc.dt, lam=jc.lam, alpha=jc.alpha, num_timesteps=jc.num_timesteps,
             num_rollouts=jc.num_rollouts, num_iters=jc.num_iters,
             tsallis_gamma=jc.tsallis_gamma, tsallis_r=jc.tsallis_r,
             state_leash_dist=None if leash is None else np.asarray(leash)),
        device="cpu", kernel=kernel, weight_transform=transform)


def test_enforce_leash_and_apply_leash_match_jax():
    leash = [0.1, 0.2, 0.05, 0.3]
    jc = _jax_controller(leash=leash)
    tc = _port_of(jc, "fused")
    rng = np.random.default_rng(5)
    traj = rng.normal(size=(17, 4)).astype(np.float32)
    state = (traj[3] + rng.normal(scale=0.2, size=4)).astype(np.float32)
    for jump in (0, 3, 40, -2):
        want = jc.apply_leash(jnp.asarray(state), jnp.asarray(traj), jump)
        got = tc.apply_leash(torch.from_numpy(state), torch.from_numpy(traj), jump)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got_t = tc.apply_leash(torch.from_numpy(state), torch.from_numpy(traj),
                               torch.tensor(jump))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))
    no_leash = _port_of(_jax_controller(), "fused")
    assert no_leash.apply_leash(torch.from_numpy(state), None, 3) is not None
    x = torch.from_numpy(traj[:, :4].T.copy())
    nominal = x + 0.5
    got = tc.dynamics.enforce_leash(x, nominal, torch.tensor(leash)[:, None])
    want = jc.dynamics.enforce_leash(jnp.asarray(x.numpy()), jnp.asarray(nominal.numpy()),
                                     jnp.asarray(leash)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tc.dynamics.get_stopping_control(x).numpy(),
                                  np.asarray(jc.dynamics.get_stopping_control(None)))


# --- one solve per path -------------------------------------------------------
@pytest.fixture
def fresh_jit_cache():
    """solve is jitted: a cached trace would ignore the patched noise, and
    the patched trace must not reach later tests."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SOLVES = {
    # name: (port kernel, JAX kernel, transform, gamma, r)
    "fused exp": ("fused", "pallas", "exp", 10.0, 2.0),
    "combined exp": ("combined", "combined", "exp", 10.0, 2.0),
    "fused tsallis": ("fused", "pallas", "tsallis", 5.0, 2.0),
    "fused tsallis r 2.4": ("fused", "pallas", "tsallis", 5.0, 2.4),
    "fused tsallis small gamma": ("fused", "pallas", "tsallis", 0.05, 2.4),
    "combined tsallis small gamma": ("combined", "combined", "tsallis", 0.05, 2.0),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_colored_solve_matches_jax(name, monkeypatch, fresh_jit_cache, one_thread):
    port_kernel, jax_kernel, transform, gamma, r = SOLVES[name]
    K, T, stride = 256, 16, 1
    key = jax.random.PRNGKey(17)
    orig = JColored._draw_noise
    monkeypatch.setattr(JColored, "_draw_noise",
                        lambda self, k, m, n, s=0: orig(self, key, m, n, s))
    jc = _jax_controller(jax_kernel, transform, gamma, r, K, T)
    rng = np.random.default_rng(2)
    js = jc.init_state(jax.random.PRNGKey(0)).replace(
        control_mean=jnp.asarray(rng.normal(scale=0.3, size=(T, 2)), jnp.float32))
    jres, jnew = jc.solve(jnp.asarray(X0), js, stride)

    tc = _port_of(jc, port_kernel, transform)
    assert isinstance(tc, ColoredMPPI)
    ts = convert.state_from_params(
        {n: np.asarray(getattr(js, n))
         for n in ("control_mean", "control_history", "previous_baseline")}, tc)
    z = torch.from_numpy(jax_normals(key, K, 2, T))
    tres, tnew = tc.solve(torch.from_numpy(X0), ts, stride, injected_noise=z)

    def close(t, j, rtol=1e-5, atol=1e-5, what=""):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol,
                                   err_msg=what)

    loose = (1e-4, 1e-5) if transform == "tsallis" else (1e-5, 1e-5)
    close(tres.costs, jres.costs, what="costs")
    assert np.array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    close(tres.baseline, jres.baseline, what="baseline")
    close(tres.weights, jres.weights, *loose, what="weights")
    close(tres.normalizer, jres.normalizer, *loose, what="eta")
    close(tres.control_mean, jres.control_mean, *loose, what="control mean")
    close(tnew.control_mean, jnew.control_mean, *loose, what="new control mean")
    close(tres.state_trajectory, jres.state_trajectory, *loose, what="trajectory")
    if "small gamma" in name:
        w = tres.weights.numpy()
        assert (w == 0).any() and (w > 0).sum() > 1


def test_fused_tsallis_matches_combined_and_counts_no_launch():
    """The port's fused Tsallis path equals its eager oracle on the same
    normals; on the CPU no kernel launches."""
    from mppi_generic_tpu_torch.ops import fused_rollout as fr

    jc = _jax_controller("pallas", "tsallis", 2.0, 2.4, K=300, T=12, iters=2)
    fused, combined = _port_of(jc, "fused", "tsallis"), _port_of(jc, "combined", "tsallis")
    z = torch.from_numpy(jax_normals(jax.random.PRNGKey(3), 300, 2, 12))
    state = fused.init_state(seed=0)
    fr.reset_launch_counts()
    rf, _ = fused.solve(torch.from_numpy(X0), state, 2, injected_noise=z)
    rc, _ = combined.solve(torch.from_numpy(X0), state, 2, injected_noise=z)
    assert all(v == 0 for v in fr.launch_counts.values())
    for field in ("costs", "weights", "baseline", "normalizer", "control_mean"):
        np.testing.assert_allclose(getattr(rf, field).numpy(), getattr(rc, field).numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=field)


def test_shaping_function_overrides_the_transform(monkeypatch, fresh_jit_cache):
    """A CEM shaping function on kernel="fused" (the rollout kernel's
    plain-costs mode, then the shaping weights) against JAX's."""
    K, T = 256, 16
    key = jax.random.PRNGKey(23)
    orig = JColored._draw_noise
    monkeypatch.setattr(JColored, "_draw_noise",
                        lambda self, k, m, n, s=0: orig(self, key, m, n, s))
    jc = _jax_controller("pallas", K=K, T=T).replace(
        shaping_function=JTsallis(gamma=jnp.float32(3.0), r=jnp.float32(2.0)))
    jres, _ = jc.solve(jnp.asarray(X0), jc.init_state(jax.random.PRNGKey(0)), 0)
    dyn_names = ("control_ranges", "control_deadband", "zero_control", "system_noise")
    tc = convert.vanilla_from_params(
        {n: np.asarray(getattr(jc.dynamics, n)) for n in dyn_names},
        {n: np.asarray(getattr(jc.cost, n)) for n in DoubleIntegratorCircleCost.PARAM_NAMES},
        jax_sampler_params(jc.sampler),
        dict(dt=0.02, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K, num_iters=1),
        device="cpu", sampler_kind="colored", shaping=({"gamma": 3.0, "r": 2.0}, "tsallis"))
    assert type(tc) is VanillaMPPI
    tres, _ = tc.solve(torch.from_numpy(X0), tc.init_state(0),
                       injected_noise=torch.from_numpy(jax_normals(key, K, 2, T)))
    np.testing.assert_allclose(tres.weights.numpy(), np.asarray(jres.weights), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tres.control_mean.numpy(), np.asarray(jres.control_mean),
                               rtol=1e-4, atol=1e-5)


def test_colored_sampler_refuses_the_in_kernel_draw():
    """The kernels refuse to draw colored noise (``KernelIncompatible``, JAX's
    ``PallasIncompatible``), and ``fused_solve`` then draws it eagerly and
    takes the eager rollout, as JAX pallas_fused falls back to XLA."""
    from mppi_generic_tpu_torch.ops import KernelIncompatible, fused_solve

    parts = (DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
             ColoredNoiseDistribution.create(exponents=[1.0, 1.0], std_dev=[1.0, 1.0]))
    with pytest.raises(KernelIncompatible, match="ColoredNoiseDistribution"):
        fused_solve.fused_solve_iteration(*parts, torch.zeros(4), torch.zeros((8, 2)), 0,
                                          0.02, 1.0, 0.0, 16)
    ctrl = VanillaMPPI(*parts, kernel="fused_solve", num_timesteps=8, num_rollouts=16,
                       device="cpu")
    res, _ = ctrl.solve(torch.tensor([2.0, 0.0, 0.0, 1.0]), ctrl.init_state(seed=1))
    assert torch.isfinite(res.control_mean).all() and res.costs.shape == (16,)
    with pytest.raises(ValueError, match="exponent"):
        ColoredNoiseDistribution.create(exponents=[1.0], std_dev=[1.0, 1.0])


def test_colored_closed_loop_stays_on_the_circle(one_thread):
    """The colored Tsallis configuration of bench.py:689-700, cut to K=512
    and T=50, 30 steps on the CPU: the radius stays inside 1.5 < r < 2.5."""
    ctrl = ColoredMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                       ColoredNoiseDistribution.create(exponents=[1.0, 2.0],
                                                       std_dev=[1.0, 1.0]),
                       num_timesteps=50, num_rollouts=512, weight_transform="tsallis",
                       tsallis_gamma=10.0, tsallis_r=2.0, device="cpu")
    cs = ctrl.init_state(seed=0)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0])
    for _ in range(30):
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        x, _ = ctrl.dynamics.step(x, res.control_mean[0], 0.0, ctrl.dt)
        assert 1.5 < float(torch.hypot(x[0], x[1])) < 2.5
    assert torch.isfinite(res.control_mean).all()
