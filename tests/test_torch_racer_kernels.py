"""The racer LSTM slice on the CPU: the plain versions of the port's B1
(fused rollout) and B3 (fused solve) entries for the LSTM-steering model
(on an elevation map, with a track costmap) and the LSTM-uncertainty model
(flat ground, no costmap), against the JAX package's Pallas kernels in
interpret mode and its eager ``rollout_combined``, on the same controls or
injected normals. ``test_torch_racer_solve.py`` holds one ``VanillaMPPI``
solve of each row through each path against JAX, with the helpers of this
file.

The configurations are the bench rows (bench.py:719-743, :791-807) cut to
K=256, T=20 (steering; tests/test_pallas_rollout.py:197-214) and K=32, T=8
(uncertainty; tests/test_suspension_models.py:127-150), with their LSTMs
from JAX keys at scale 0.5 so that the networks move the samples apart, a
32^2 elevation map and a 32^2 track map of 0.15 |z| with a hot block ahead
and to the left, so that some samples crash mid-horizon.

Tolerances: U rtol 1e-5 / atol 1e-6; costs rtol / atol 1e-4 (the LSTM,
head and map sums in other orders, through T steps); crash flags exactly;
baselines rtol 1e-5; new means rtol 1e-4 / atol 1e-5 and eta rtol 1e-4, each
widened by what the measured cost differences can move them
(``_weight_slack`` of test_torch_zoo_kernels.py: the crashed samples' costs
are about 1e3 to 1e4, where an ulp of cost moves a weight by 2 dJ / lambda).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import ARStandardCost as JStandard
from mppi_generic_tpu.maps.texture import MapTexture2D as JTex
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.ops.pallas_solve import fused_solve_iteration as jax_solve
from mppi_generic_tpu.ops.rollout import rollout_combined as jax_combined
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import NLNDistribution as JNLN
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.models import (
    RacerDubinsElevationLSTMSteering,
    RacerDubinsElevationLSTMUncertainty,
)
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve
from mppi_generic_tpu_torch.ops.rollout import rollout_combined
from test_torch_autorally import jax_cost_params
from test_torch_racer import jax_racer, jax_racer_params
from test_torch_zoo_kernels import _weight_slack

C, DT, LAM, ALPHA, STRIDE = 2, 0.02, 1.3, 0.1, 2
OUTPUT_INDICES = (2, 3, 5, 6, 0, 1)
SHAPES = {"steering": (256, 20), "unc": (32, 8)}
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")


@functools.lru_cache(maxsize=None)
def _track_map():
    m = (0.15 * np.abs(np.random.default_rng(31).normal(size=(32, 32)))).astype(np.float32)
    m[19:, 27:] = 3.0  # texel centres y >= 0.35 m, x >= 1.15 m
    return JTex.create(m, origin=(-1.6, -1.6, 0.0), resolution=0.1)


def _x0(kind):
    x0 = np.zeros(9 if kind == "steering" else 26, np.float32)
    x0[0] = 3.0
    x0[1] = 0.2  # toward the hot block: about half of the samples reach it
    return x0


def _setup(kind, sampler="gaussian", p=0.0):
    """JAX and port (dynamics, cost, sampler) of one row."""
    jdyn = jax_racer(kind, elevation=kind == "steering")
    jcost = JStandard(costmap=_track_map() if kind == "steering" else None,
                      output_indices=OUTPUT_INDICES)
    cls = JNLN if sampler == "nln" else JGaussian
    jsamp = cls.create(std_dev=[0.3, 0.5], control_cost_coeff=[0.5, 1.0],
                       pure_noise_percentage=p)
    make = convert.nln_from_params if sampler == "nln" else convert.gaussian_from_params
    port_cls = (RacerDubinsElevationLSTMSteering if kind == "steering"
                else RacerDubinsElevationLSTMUncertainty)
    dyn = convert.DYNAMICS[f"racer_{kind}"](jax_racer_params(jdyn, port_cls))
    port = (dyn, convert.ar_cost_from_params(jax_cost_params(jcost)),
            make({n: np.asarray(getattr(jsamp, n)) for n in SAMPLER_FIELDS}))
    return (jdyn, jcost, jsamp), port


def _mean(T, seed=12):
    m = (0.3 * np.random.default_rng(seed).normal(size=(T, C))).astype(np.float32)
    m[:, 0] += 0.3
    return m


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def _rollout_inputs(K, T, seed=13):
    rng = np.random.default_rng(seed)
    mean = _mean(T, seed)
    sigma = np.tile(np.array([[0.3, 0.5]], np.float32), (T, 1))
    U = np.clip(mean + sigma * rng.normal(size=(K, T, C)), -1.0, 1.0).astype(np.float32)
    coeff = np.array([0.5, 1.0], np.float32)
    thresh = float(np.float32(0.9) * np.float32(K))
    return U, (mean, sigma, coeff, LAM, ALPHA, thresh)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_jit_cache():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("kind", ["steering", "unc"])
@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue+lr"])
def test_b1_plain_matches_jax_kernel(kind, mode, one_thread):
    (jdyn, jcost, _), (dyn, cost, _) = _setup(kind)
    K, T = SHAPES[kind]
    U, lr = _rollout_inputs(K, T)
    x0 = _x0(kind)
    with_lr = mode.endswith("+lr")
    jlr = (tuple(jnp.asarray(a) for a in lr[:3]) + tuple(jnp.float32(v) for v in lr[3:])
           if with_lr else None)
    tlr = tuple(torch.from_numpy(a) for a in lr[:3]) + lr[3:] if with_lr else None
    tx0, Ut = torch.from_numpy(x0), torch.from_numpy(U)
    if mode.startswith("costs"):
        jc, jcrash = pallas_rollout.fused_rollout_costs(
            jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), DT, tile_k=128, lr_params=jlr)
        tc, tcrash = fr.fused_rollout_costs(dyn, cost, tx0, Ut, DT, lr_params=tlr)
    else:
        jc, jcrash, jmean, jbase, jeta = pallas_rollout.fused_weighted_rollout(
            jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), DT, LAM, lr_params=jlr,
            tile_k=128)
        tc, tcrash, tmean, tbase, teta = fr.fused_weighted_rollout(
            dyn, cost, tx0, Ut, DT, LAM, lr_params=tlr)
        eta_rtol, mean_atol = _weight_slack(tc, jc, U, jmean, LAM)
        _close(tmean, jmean, 1e-4, mean_atol, "new mean")
        _close(tbase, jbase, 1e-5, 0, "baseline")
        _close(teta, jeta, eta_rtol, 0, "eta")
    _close(tc, jc, 1e-4, 1e-4, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    if kind == "steering":
        assert 0 < int(np.asarray(jcrash).sum()) < K  # some samples crash, some do not
    if mode == "costs":
        # the eager oracle (matmul sums) against JAX's and the plain version
        jc2, _, jcrash2 = jax_combined(jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), DT)
        ec, _, ecrash = rollout_combined(dyn, cost, tx0, Ut, DT)
        _close(ec, jc2, 1e-4, 1e-4, "combined costs")
        np.testing.assert_array_equal(ecrash.numpy(), np.asarray(jcrash2))
        _close(ec, tc, 1e-5, 1e-4, "combined vs plain")


@pytest.mark.parametrize("kind,sampler,p", [("steering", "gaussian", 0.0),
                                             ("steering", "nln", 0.25),
                                             ("unc", "gaussian", 0.1)])
def test_b3_plain_matches_jax_kernel(kind, sampler, p, one_thread):
    (jdyn, jcost, jsamp), (dyn, cost, samp) = _setup(kind, sampler, p)
    K, T = SHAPES[kind]
    z = np.random.default_rng(len(sampler)).normal(size=(2, K, T, C)).astype(np.float32)
    Z = z if sampler == "nln" else z[0]
    mean, x0 = _mean(T), _x0(kind)
    jout = jax_solve(jdyn, jcost, jsamp, jnp.asarray(x0), jnp.asarray(mean), jnp.int32(0),
                     DT, LAM, ALPHA, K, optimization_stride=STRIDE, tile_k=128,
                     return_samples=True, injected_noise=jnp.asarray(Z))
    costs, crash, new_mean, baseline, eta, U = fused_solve.fused_solve_iteration(
        dyn, cost, samp, torch.from_numpy(x0), torch.from_numpy(mean), 0, DT, LAM, ALPHA,
        K, optimization_stride=STRIDE, return_samples=True, injected_noise=torch.from_numpy(Z))
    j_costs, j_crash, j_mean, j_base, j_eta, j_U = (np.asarray(a) for a in jout)
    _close(U, j_U, 1e-5, 1e-6, "U")
    _close(costs, j_costs, 1e-4, 1e-4, "costs")
    np.testing.assert_array_equal(crash.numpy(), j_crash)
    eta_rtol, mean_atol = _weight_slack(costs, j_costs, j_U, j_mean, LAM)
    _close(baseline, j_base, 1e-5, 0, "baseline")
    _close(eta, j_eta, eta_rtol, 0, "eta")
    _close(new_mean, j_mean, 1e-4, mean_atol, "new mean")


def test_racer_solve_refuses_samplers_without_an_entry():
    """The racer pairs' samplers that take the sampling kernel (B4: Tsallis,
    CEM and Smooth-MPPI on the fused solve) have an entry now, in a library
    of their own (csrc/sample_<pair>.cu), beside B1 and B3; nothing is
    refused for want of one."""
    for kind in ("steering", "unc"):
        _, (dyn, cost, samp) = _setup(kind)
        pair = f"racer_{kind}_ar"
        assert fr._entry(dyn, cost, "sample") == (f"sample_{pair}",
                                                  f"fused_sample_rollout_{pair}")
        assert fr._entry(dyn, cost, "solve") == (f"pair_{pair}", f"fused_solve_{pair}")
        assert fr._entry(dyn, cost, "rollout")[1] == f"rollout_costs_{pair}"
