"""Parity of the port's Gaussian sampler with the JAX package, with the same
injected standard normals (the RNG streams differ by design)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.sampling import GaussianDistribution

K, T, C = 300, 24, 2
RTOL, ATOL = 1e-6, 1e-6
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")


def _pair(p=0.25, decay=1.0):
    j = JGaussian.create(std_dev=[0.8, 1.3], control_cost_coeff=[0.01, 0.5],
                         pure_noise_percentage=p, std_dev_decay=decay)
    t = convert.gaussian_from_params(
        {n: np.asarray(getattr(j, n)) for n in SAMPLER_FIELDS})
    return j, t


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(K, T, C)).astype(np.float32)
    mean = rng.normal(scale=0.5, size=(T, C)).astype(np.float32)
    return eps, mean


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("iteration", [0, 2])
def test_apply_carveouts_matches_jax(iteration):
    eps, mean = _inputs()
    j, t = _pair(p=0.25, decay=0.8)
    want = j._apply_carveouts(jnp.asarray(eps), jnp.asarray(mean), K,
                              iteration, 2)
    got = t._apply_carveouts(torch.from_numpy(eps), torch.from_numpy(mean), K,
                             iteration, 2)
    _close(got, want)
    # sample 0 and the frozen head are the mean; the tail is pure noise
    assert torch.equal(got[0], torch.from_numpy(mean))
    assert torch.equal(got[:, :2], torch.from_numpy(mean)[None, :2].expand(K, -1, -1))
    n_pure = int(np.sum(np.arange(K) >= t.pure_threshold(K)))
    assert n_pure == K - int(np.ceil(0.75 * K))


def test_sample_with_injected_noise_equals_carveouts():
    eps, mean = _inputs(1)
    _, t = _pair()
    got = t.sample(None, torch.from_numpy(mean), K, optimization_stride=2,
                   injected_noise=torch.from_numpy(eps))
    _close(got, t._apply_carveouts(torch.from_numpy(eps), torch.from_numpy(mean),
                                   K, 0, 2), rtol=0, atol=0)


def test_sample_draws_from_generator():
    _, t = _pair(p=0.0)
    mean = torch.zeros((T, C))
    a = t.sample(torch.Generator().manual_seed(3), mean, K)
    b = t.sample(torch.Generator().manual_seed(3), mean, K)
    assert torch.equal(a, b) and a.shape == (K, T, C)
    assert torch.equal(a[0], mean)


@pytest.mark.parametrize("iteration", [0, 1])
def test_likelihood_ratio_cost_matches_jax(iteration):
    eps, mean = _inputs(2)
    j, t = _pair(p=0.25, decay=0.9)
    U = np.array(j._apply_carveouts(jnp.asarray(eps), jnp.asarray(mean), K,
                                      iteration, 0))
    want = j.likelihood_ratio_cost(jnp.asarray(U), jnp.asarray(mean), 1.3, 0.1,
                                   iteration=iteration)
    got = t.likelihood_ratio_cost(torch.from_numpy(U), torch.from_numpy(mean),
                                  1.3, 0.1, iteration=iteration)
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_update_mean_matches_jax():
    eps, mean = _inputs(3)
    j, t = _pair()
    U = np.array(j._apply_carveouts(jnp.asarray(eps), jnp.asarray(mean), K, 0, 0))
    w = np.random.default_rng(4).uniform(size=(K,)).astype(np.float32)
    eta = np.float32(w.sum())
    want, _ = j.update_mean(jnp.asarray(U), None, jnp.asarray(w), jnp.asarray(eta),
                            jnp.asarray(mean))
    got = t.update_mean(torch.from_numpy(U), torch.from_numpy(w), torch.tensor(eta))
    _close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stride", [0, 1, 3])
def test_shift_matches_jax(stride):
    _, mean = _inputs(5)
    j, t = _pair()
    want, _ = j.shift(jnp.asarray(mean), stride)
    _close(t.shift(torch.from_numpy(mean), stride), want)
