"""The port's NLN (log-MPPI) and Smooth-MPPI samplers, the Tsallis and CEM
weight transforms and their converters, against the JAX package with the
same injected standard normals (the RNG streams differ by design)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.ops import weights as jweights
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import NLNDistribution as JNLN
from mppi_generic_tpu.sampling import SmoothMPPIDistribution as JSmooth
from mppi_generic_tpu_torch import NLNDistribution, SmoothMPPIDistribution, convert
from mppi_generic_tpu_torch.ops import weights

K, T, C = 300, 24, 2
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")


def _fields(j, smooth=False):
    p = {n: np.asarray(getattr(j, n)) for n in SAMPLER_FIELDS}
    if smooth:
        p.update(dt_smooth=np.asarray(j.dt_smooth), num_timesteps=j.num_timesteps)
    return p


def _nln():
    j = JNLN.create(std_dev=[0.5, 0.3], control_cost_coeff=[0.01, 0.5],
                    pure_noise_percentage=0.25, std_dev_decay=0.9)
    return j, convert.nln_from_params(_fields(j))


def _smooth():
    j = JSmooth.create(std_dev=[0.6, 0.8], num_timesteps=T, dt=0.05,
                       control_cost_coeff=[0.02, 0.1], pure_noise_percentage=0.25)
    return j, convert.smooth_from_params(_fields(j, smooth=True))


def _inputs(seed, n_z=1):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n_z, K, T, C)).astype(np.float32)
    mean = rng.normal(scale=0.5, size=(T, C)).astype(np.float32)
    dmean = rng.normal(scale=0.3, size=(T, C)).astype(np.float32)
    return Z, mean, dmean


def _close(t, j, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_converters_carry_the_jax_fields():
    jn, tn = _nln()
    js, ts = _smooth()
    assert type(tn) is NLNDistribution and type(ts) is SmoothMPPIDistribution
    for j, t in ((jn, tn), (js, ts)):
        _close(t.std_dev, j.std_dev, 0, 0)
        _close(t.control_cost_coeff, j.control_cost_coeff, 0, 0)
        assert t.pure_noise_percentage == float(j.pure_noise_percentage)
        assert t.std_dev_decay == float(j.std_dev_decay)
    assert ts.dt_smooth == float(js.dt_smooth) and ts.num_timesteps == js.num_timesteps
    assert ts.init_state().shape == (T, C) and not ts.init_state().any()
    assert tn.init_state() is None


@pytest.mark.parametrize("iteration,stride", [(0, 0), (2, 3)])
def test_nln_sample_matches_jax(iteration, stride):
    j, t = _nln()
    Z, mean, _ = _inputs(iteration + stride, n_z=2)
    eps = jnp.asarray(Z[0]) * jnp.exp(j.std_dev * jnp.asarray(Z[1]))
    want = j._apply_carveouts(eps, jnp.asarray(mean), K, iteration, stride)
    got, aux = t.sample(None, torch.from_numpy(mean), K, iteration=iteration,
                        optimization_stride=stride, injected_noise=torch.from_numpy(Z))
    _close(got, want, rtol=1e-5, atol=1e-6)
    assert aux is None


def test_nln_draws_from_the_generator():
    _, t = _nln()
    mean = torch.zeros((T, C))
    a, _ = t.sample(torch.Generator().manual_seed(3), mean, K)
    b, _ = t.sample(torch.Generator().manual_seed(3), mean, K)
    assert torch.equal(a, b) and a.shape == (K, T, C)
    assert torch.equal(a[0], mean)


@pytest.mark.parametrize("iteration,stride", [(0, 0), (1, 2)])
def test_smooth_sample_matches_jax(iteration, stride, monkeypatch):
    j, t = _smooth()
    Z, mean, dmean = _inputs(10 + stride)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, m, n, s=0: jnp.asarray(Z[0]))
    jU, jW = j.sample(jax.random.PRNGKey(0), jnp.asarray(mean), K,
                      iteration=iteration, optimization_stride=stride,
                      state=jnp.asarray(dmean))
    U, W = t.sample(None, torch.from_numpy(mean), K, iteration=iteration,
                    optimization_stride=stride, state=torch.from_numpy(dmean),
                    injected_noise=torch.from_numpy(Z[0]))
    _close(U, jU)
    _close(W, jW)
    # the pinned samples sit on the derivative mean
    assert torch.equal(W[0], torch.from_numpy(dmean))
    with pytest.raises(ValueError, match="derivative mean"):
        t.sample(None, torch.from_numpy(mean), K)


def test_smooth_update_mean_and_shift_match_jax():
    j, t = _smooth()
    Z, mean, dmean = _inputs(20)
    W = Z[0] * 0.4
    U = mean + W * 0.05
    w = np.random.default_rng(4).uniform(size=(K,)).astype(np.float32)
    eta = np.float32(w.sum())
    jm, jdm = j.update_mean(jnp.asarray(U), jnp.asarray(W), jnp.asarray(w),
                            jnp.asarray(eta), jnp.asarray(mean), jnp.asarray(dmean))
    tm, tdm = t.update_mean(torch.from_numpy(U), torch.from_numpy(W),
                            torch.from_numpy(w), torch.tensor(eta),
                            torch.from_numpy(mean), torch.from_numpy(dmean))
    _close(tm, jm, rtol=1e-5, atol=1e-6)
    _close(tdm, jdm, rtol=1e-5, atol=1e-6)
    for stride in (0, 1, 3):
        jm2, jdm2 = j.shift(jnp.asarray(mean), stride, None, jnp.asarray(dmean))
        tm2, tdm2 = t.shift(torch.from_numpy(mean), stride, torch.from_numpy(dmean))
        _close(tm2, jm2, 0, 0)
        _close(tdm2, jdm2, 0, 0)


@pytest.mark.parametrize("gamma,r", [(10.0, 2.0), (0.5, 3.0)])
def test_tsallis_weights_match_jax(gamma, r):
    costs = np.random.default_rng(5).uniform(0.0, 2.0, size=(K,)).astype(np.float32)
    base = np.float32(costs.min())
    want = jweights.tsallis_weights(jnp.asarray(costs), jnp.float32(gamma),
                                    jnp.float32(r), jnp.asarray(base))
    got = weights.tsallis_weights(torch.from_numpy(costs), gamma, r,
                                  torch.tensor(base))
    _close(got, want, rtol=1e-5, atol=1e-7)
    assert (got == 0).any() == bool((costs - base >= gamma).any())


@pytest.mark.parametrize("fraction", [0.1, 0.25, 0.001])
def test_cem_weights_match_jax(fraction):
    costs = np.random.default_rng(6).uniform(size=(K,)).astype(np.float32)
    costs[10:14] = costs[:4]  # ties
    want = jweights.cem_weights(jnp.asarray(costs), jnp.float32(fraction))
    got = weights.cem_weights(torch.from_numpy(costs), fraction)
    _close(got, want, 0, 0)
    assert int(got.sum()) >= max(int(np.floor(np.float32(fraction) * K)), 1)
