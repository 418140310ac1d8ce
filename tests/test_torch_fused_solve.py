"""The fused solve iteration (kernel B3) of the port: its plain version
(what the wrapper runs on CPU tensors) against the JAX package's
``fused_solve_iteration`` (its Pallas kernel in interpret mode) on the same
injected standard normals, and the port's own in-kernel draw through the
same function, checked for its carve-outs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops.pallas_solve import fused_solve_iteration as jax_solve
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import NLNDistribution as JNLN
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.ops import fused_solve, philox

# the sizes of tests/test_injected_noise.py:38
K, T, C = 256, 10, 2
DT, LAM, ALPHA, STRIDE = 0.02, 1.2, 0.1, 2
X0 = np.array([2.0, 0.05, -0.1, 1.0], np.float32)  # on the track: J of a few units
RANGES = [[-0.9, 0.9], [-0.8, 0.8]]
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")
DYN_FIELDS = ("control_ranges", "control_deadband", "zero_control", "system_noise")


def _params(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def _mean():
    t = np.arange(T, dtype=np.float32)[:, None]
    return (0.3 * np.sin(np.concatenate([t, 2 * t], axis=1))).astype(np.float32)


def _setup(kind, p, decay=1.0):
    """JAX and port (dynamics, cost, sampler) with the same parameters."""
    cls = JNLN if kind == "nln" else JGaussian
    std = [0.5, 0.3] if kind == "nln" else [0.7, 0.4]
    jsamp = cls.create(std_dev=std, control_cost_coeff=[0.02, 0.5],
                       pure_noise_percentage=p, std_dev_decay=decay)
    jdyn, jcost = JDI.create(control_ranges=RANGES), JCircle()
    make = convert.nln_from_params if kind == "nln" else convert.gaussian_from_params
    port = (convert.double_integrator_from_params(_params(jdyn, DYN_FIELDS)),
            convert.circle_cost_from_params(
                _params(jcost, DoubleIntegratorCircleCost.PARAM_NAMES)),
            make(_params(jsamp, SAMPLER_FIELDS)))
    return (jdyn, jcost, jsamp), port


def _normals(kind, seed):
    n_z = 2 if kind == "nln" else 1
    z = np.random.default_rng(seed).normal(size=(n_z, K, T, C)).astype(np.float32)
    return z if kind == "nln" else z[0]


@pytest.mark.parametrize("kind", ["gaussian", "nln"])
@pytest.mark.parametrize("p", [0.0, 0.25])
def test_fused_solve_plain_matches_jax_kernel(kind, p):
    (jdyn, jcost, jsamp), (dyn, cost, samp) = _setup(kind, p)
    Z = _normals(kind, seed=int(p * 100) + len(kind))
    mean = _mean()
    jout = jax_solve(jdyn, jcost, jsamp, jnp.asarray(X0), jnp.asarray(mean),
                     jnp.int32(0), DT, LAM, ALPHA, K, optimization_stride=STRIDE,
                     tile_k=128, return_samples=True, injected_noise=jnp.asarray(Z))
    costs, crash, new_mean, baseline, eta, U = fused_solve.fused_solve_iteration(
        dyn, cost, samp, torch.from_numpy(X0), torch.from_numpy(mean), 0, DT, LAM,
        ALPHA, K, optimization_stride=STRIDE, return_samples=True,
        injected_noise=torch.from_numpy(Z))
    j_costs, j_crash, j_mean, j_base, j_eta, j_U = (np.asarray(a) for a in jout)
    # the tolerances of tests/test_injected_noise.py:185-204
    np.testing.assert_allclose(U.numpy(), j_U, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(costs.numpy(), j_costs, rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(crash.numpy(), j_crash)
    np.testing.assert_allclose(float(baseline), float(j_base), rtol=1e-5)
    np.testing.assert_allclose(float(eta), float(j_eta), rtol=1e-4)
    np.testing.assert_allclose(new_mean.numpy(), j_mean, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["gaussian", "nln"])
def test_fused_solve_own_draw_carve_outs(kind):
    """The in-kernel draw (plain Philox) through the same function: sample 0
    and the frozen head are the clamped mean, the pure tail carries no mean,
    the rest is mean + sigma * eps of the documented draw."""
    _, (dyn, cost, samp) = _setup(kind, 0.25, decay=0.8)
    mean = torch.from_numpy(_mean())
    seed = torch.tensor(4242, dtype=torch.int32)
    it = 1
    costs, crash, new_mean, baseline, eta, U = fused_solve.fused_solve_iteration(
        dyn, cost, samp, torch.from_numpy(X0), mean, seed, DT, LAM, ALPHA, K,
        iteration=it, optimization_stride=STRIDE, return_samples=True)
    def clamp(u):
        return dyn.enforce_constraints(None, u.movedim(-1, 0)).movedim(0, -1)

    clamped_mean = clamp(mean)
    assert torch.equal(U[0], clamped_mean)
    assert torch.equal(U[:, :STRIDE], clamped_mean[None, :STRIDE].expand(K, -1, -1))
    z = philox.normals(seed, K, T, C, streams=2 if kind == "nln" else 1)
    eps = z[0] * torch.exp(samp.std_dev * z[1]) if kind == "nln" else z[0]
    noise = samp._sigma(T, it) * eps
    n_pure = K - int(np.ceil(0.75 * K))
    tail = slice(K - n_pure, K)
    np.testing.assert_allclose(U[tail, STRIDE:].numpy(),
                               clamp(noise[tail, STRIDE:]).numpy(),
                               rtol=1e-6, atol=1e-7)
    body = slice(1, K - n_pure)
    np.testing.assert_allclose(
        U[body, STRIDE:].numpy(),
        clamp(mean[None, STRIDE:] + noise[body, STRIDE:]).numpy(),
        rtol=1e-6, atol=1e-7)
    # the flash epilogue's outputs are the normExp statistics of the costs
    w = torch.exp(-(costs - baseline) / LAM)
    np.testing.assert_allclose(float(baseline), float(costs.min()), rtol=1e-6)
    np.testing.assert_allclose(float(eta), float(w.sum()), rtol=1e-5)
    np.testing.assert_allclose(new_mean.numpy(),
                               (torch.einsum("k,ktc->tc", w, U) / w.sum()).numpy(),
                               rtol=1e-4, atol=1e-5)
    assert torch.isfinite(costs).all() and crash.dtype == torch.int32


def test_fused_solve_refuses_smooth():
    from mppi_generic_tpu_torch import SmoothMPPIDistribution
    _, (dyn, cost, _) = _setup("gaussian", 0.0)
    smooth = SmoothMPPIDistribution.create(std_dev=[1.0, 1.0], num_timesteps=T)
    with pytest.raises(NotImplementedError, match="Smooth-MPPI"):
        fused_solve.fused_solve_iteration(
            dyn, cost, smooth, torch.from_numpy(X0), torch.from_numpy(_mean()), 0,
            DT, LAM, ALPHA, K)


@pytest.fixture(autouse=True)
def _fresh_jit_cache():
    yield
    jax.clear_caches()
