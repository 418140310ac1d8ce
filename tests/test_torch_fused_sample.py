"""The fused sample + rollout (kernel B4) of the port: its plain version
(what the wrapper runs on CPU tensors) against the JAX package's
``fused_sample_rollout_costs`` (its Pallas kernel in interpret mode) on the
same injected standard normals, for the Gaussian, NLN and Smooth-MPPI
samplers, with and without Smooth-MPPI's flash epilogue over W."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops.pallas_rollout import fused_sample_rollout_costs as jax_sample
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import NLNDistribution as JNLN
from mppi_generic_tpu.sampling import SmoothMPPIDistribution as JSmooth
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.ops import fused_rollout as fr

# the sizes of tests/test_injected_noise.py:38
K, T, C = 256, 10, 2
DT, LAM, ALPHA = 0.02, 1.2, 0.1
X0 = np.array([2.0, 0.05, -0.1, 1.0], np.float32)  # on the track: J of a few units
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")
DYN_FIELDS = ("control_ranges", "control_deadband", "zero_control", "system_noise")

CASES = {
    # (JAX sampler, stride, iteration)
    "gaussian": (lambda: JGaussian.create(std_dev=[0.7, 0.4], pure_noise_percentage=0.25,
                                          control_cost_coeff=[0.02, 0.5]), 2, 0),
    "nln": (lambda: JNLN.create(std_dev=[0.5, 0.3], pure_noise_percentage=0.125,
                                std_dev_decay=0.9), 1, 1),
    "smooth": (lambda: JSmooth.create(std_dev=[0.6, 0.6], num_timesteps=T, dt=0.05,
                                      pure_noise_percentage=0.25), 2, 0),
}


def _params(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def _port(kind, jsamp, jdyn, jcost):
    p = _params(jsamp, SAMPLER_FIELDS)
    if kind == "smooth":
        p.update(dt_smooth=np.asarray(jsamp.dt_smooth), num_timesteps=T)
    return (convert.double_integrator_from_params(_params(jdyn, DYN_FIELDS)),
            convert.circle_cost_from_params(
                _params(jcost, DoubleIntegratorCircleCost.PARAM_NAMES)),
            convert.SAMPLERS[kind](p))


def _inputs(kind, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float32)[:, None]
    mean = (0.3 * np.sin(np.concatenate([t, 2 * t], axis=1))).astype(np.float32)
    n_z = 2 if kind == "nln" else 1
    Z = rng.normal(size=(n_z, K, T, C)).astype(np.float32)
    dmean = rng.normal(scale=0.2, size=(T, C)).astype(np.float32)
    return mean, (Z if kind == "nln" else Z[0]), dmean


def _run(kind, epilogue, seed):
    make, stride, it = CASES[kind]
    jsamp = make()
    jdyn = JDI.create(control_ranges=[[-0.9, 0.9], [-0.8, 0.8]])
    jcost = JCircle()
    dyn, cost, samp = _port(kind, jsamp, jdyn, jcost)
    mean, Z, dmean = _inputs(kind, seed)
    state = dmean if kind == "smooth" else None
    jout = jax_sample(
        jdyn, jcost, jsamp, jnp.asarray(X0), jnp.asarray(mean), jnp.int32(0), DT,
        LAM, ALPHA, K, iteration=it, optimization_stride=stride, tile_k=128,
        sampler_state=None if state is None else jnp.asarray(state),
        epilogue=epilogue, injected_noise=jnp.asarray(Z))
    tout = fr.fused_sample_rollout_costs(
        dyn, cost, samp, torch.from_numpy(X0), torch.from_numpy(mean), 0, DT, LAM,
        ALPHA, K, iteration=it, optimization_stride=stride,
        sampler_state=None if state is None else torch.from_numpy(state),
        epilogue=epilogue, injected_noise=torch.from_numpy(Z))
    return [None if a is None else np.asarray(a) for a in jout], tout


@pytest.mark.parametrize("kind", sorted(CASES))
def test_sample_rollout_plain_matches_jax_kernel(kind):
    (j_costs, j_crash, j_U, j_W), (costs, crash, U, W) = _run(kind, False, seed=len(kind))
    # the tolerances of tests/test_injected_noise.py:70-122
    np.testing.assert_allclose(U.numpy(), j_U, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(costs.numpy(), j_costs, rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(crash.numpy(), j_crash)
    if kind == "smooth":
        np.testing.assert_allclose(W.numpy(), j_W, rtol=1e-5, atol=1e-6)
    else:
        assert W is None and j_W is None


def test_smooth_epilogue_plain_matches_jax_kernel():
    jout, tout = _run("smooth", True, seed=3)
    j_costs, j_crash, j_U, j_dm, j_base, j_eta = jout
    costs, crash, U, dm, base, eta = tout
    # the tolerances of tests/test_injected_noise.py:125-159
    np.testing.assert_allclose(U.numpy(), j_U, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(costs.numpy(), j_costs, rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(crash.numpy(), j_crash)
    np.testing.assert_allclose(float(base), float(j_base), rtol=1e-5)
    np.testing.assert_allclose(float(eta), float(j_eta), rtol=1e-4)
    np.testing.assert_allclose(dm.numpy(), j_dm, rtol=1e-4, atol=1e-5)


def test_epilogue_refuses_gaussian_and_unknown_samplers():
    jsamp = CASES["gaussian"][0]()
    dyn, cost, samp = _port("gaussian", jsamp, JDI.create(), JCircle())
    mean = torch.zeros((T, C))
    with pytest.raises(NotImplementedError, match="Smooth-MPPI"):
        fr.fused_sample_rollout_costs(dyn, cost, samp, torch.from_numpy(X0), mean, 0,
                                      DT, LAM, ALPHA, K, epilogue=True)

    class Colored(type(samp)):
        pass

    other = Colored.create(std_dev=[1.0, 1.0])
    with pytest.raises(NotImplementedError, match="Colored"):
        fr.fused_sample_rollout_costs(dyn, cost, other, torch.from_numpy(X0), mean, 0,
                                      DT, LAM, ALPHA, K)


@pytest.fixture(autouse=True)
def _fresh_jit_cache():
    yield
    jax.clear_caches()
