"""The AutoRally slice on the CPU: the plain versions of the port's B3
(fused solve) and B1 (fused rollout, all four modes) against the JAX
package's Pallas kernels in interpret mode on the same injected normals,
and one ``VanillaMPPI`` solve of each path (``fused_solve``, ``fused``,
``combined``) against JAX ``pallas_fused``, ``pallas`` and ``combined``.

The configuration is ``bench.py:704-717`` cut to K=256, T=16, with its
6-32-32-4 network drawn from PRNGKey(0) at scale 1 (the bench's 0.1 leaves
the samples within millimetres of each other over 16 steps), on a 32^2 map
and on a 4 x 1024^2 channel-major map (0.1 m texels; the samples' cluster
stays inside JAX's 256-texel window, ROADMAP section 3). Each map is 0.15 |z|
with a hot block ahead and to the left of the car, so some samples crash
mid-horizon and the crash flags are worth comparing.

Tolerances: U rtol 1e-5 / atol 1e-6; costs rtol 2e-5 / atol 2e-4 (as
tests/test_windowed_maps.py:260: the tent-mask and one-hot map products and
XLA's network sum in other orders); crash flags exactly; new means rtol 1e-4
/ atol 1e-5; baselines rtol 1e-5; eta rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.costs import ARStandardCost as JStandard
from mppi_generic_tpu.maps.texture import MapTexture2D as JTex
from mppi_generic_tpu.models import AutorallyNNDynamics as JAutorally
from mppi_generic_tpu.nn.fnn import FNN as JFNN
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.ops.pallas_solve import fused_solve_iteration as jax_solve
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import NLNDistribution as JNLN
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve
from test_torch_autorally import jax_cost_params, jax_dynamics_params

K, T, C = 256, 16, 2
DT, LAM, ALPHA, STRIDE = 0.02, 1.3, 0.1, 2
X0 = np.array([0.0, 0.0, 0.2, 0.0, 3.0, 0.0, 0.0], np.float32)
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")


@functools.lru_cache(maxsize=None)
def _jax_map(kind):
    rng = np.random.default_rng(11)
    if kind == "32":
        m = (0.15 * np.abs(rng.normal(size=(32, 32)))).astype(np.float32)
        m[21:, 27:] = 3.0  # texel centres y >= 0.55 m, x >= 1.15 m
        return JTex.create(m, origin=(-1.6, -1.6, 0.0), resolution=0.1)
    chw = rng.normal(size=(4, 1024, 1024)).astype(np.float32)
    chw[0] = 0.15 * np.abs(chw[0])
    chw[0, 517:, 523:] = 3.0  # the same block
    return JTex.create(chw, origin=(-51.2, -51.2, 0.0), resolution=0.1,
                       channel_major=True)


def _setup(map_kind, sampler="gaussian", p=0.0):
    """JAX and port (dynamics, cost, sampler) with the same parameters."""
    jdyn = JAutorally.create(nn=JFNN.create([6, 32, 32, 4], key=jax.random.PRNGKey(0),
                                            scale=1.0),
                             control_ranges=[[-0.9, 0.9], [-0.6, 1.0]])
    jcost = JStandard(costmap=_jax_map(map_kind))
    cls = JNLN if sampler == "nln" else JGaussian
    jsamp = cls.create(std_dev=[0.3, 0.5], control_cost_coeff=[0.5, 1.0],
                       pure_noise_percentage=p)
    make = convert.nln_from_params if sampler == "nln" else convert.gaussian_from_params
    port = (convert.autorally_from_params(jax_dynamics_params(jdyn)),
            convert.ar_cost_from_params(jax_cost_params(jcost)),
            make({n: np.asarray(getattr(jsamp, n)) for n in SAMPLER_FIELDS}))
    return (jdyn, jcost, jsamp), port


def _mean(seed=12):
    return (0.2 * np.random.default_rng(seed).normal(size=(T, C))).astype(np.float32)


def _normals(kind, seed):
    z = np.random.default_rng(seed).normal(size=(2, K, T, C)).astype(np.float32)
    return z if kind == "nln" else z[0]


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.fixture
def fresh_jit_cache():
    """solve is jitted: a cached trace would ignore the patched noise, and
    the patched trace must not reach later tests."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("map_kind", ["32", "1024"])
@pytest.mark.parametrize("kind,p", [("gaussian", 0.0), ("nln", 0.25)])
def test_b3_plain_matches_jax_kernel(map_kind, kind, p):
    (jdyn, jcost, jsamp), (dyn, cost, samp) = _setup(map_kind, kind, p)
    Z, mean = _normals(kind, seed=len(kind)), _mean()
    jout = jax_solve(jdyn, jcost, jsamp, jnp.asarray(X0), jnp.asarray(mean),
                     jnp.int32(0), DT, LAM, ALPHA, K, optimization_stride=STRIDE,
                     tile_k=128, return_samples=True, injected_noise=jnp.asarray(Z))
    costs, crash, new_mean, baseline, eta, U = fused_solve.fused_solve_iteration(
        dyn, cost, samp, torch.from_numpy(X0), torch.from_numpy(mean), 0, DT, LAM,
        ALPHA, K, optimization_stride=STRIDE, return_samples=True,
        injected_noise=torch.from_numpy(Z))
    j_costs, j_crash, j_mean, j_base, j_eta, j_U = (np.asarray(a) for a in jout)
    _close(U, j_U, 1e-5, 1e-6, "U")
    _close(costs, j_costs, 2e-5, 2e-4, "costs")
    np.testing.assert_array_equal(crash.numpy(), j_crash)
    assert 0 < int(j_crash.sum()) < K  # some samples crash, some do not
    _close(baseline, j_base, 1e-5, 0, "baseline")
    _close(eta, j_eta, 1e-4, 0, "eta")
    _close(new_mean, j_mean, 1e-4, 1e-5, "new mean")


def _rollout_inputs(seed=13):
    rng = np.random.default_rng(seed)
    mean = _mean(seed)
    sigma = np.tile(np.array([[0.3, 0.5]], np.float32), (T, 1))
    U = np.clip(mean + sigma * rng.normal(size=(K, T, C)), -0.9, 0.9).astype(np.float32)
    coeff = np.array([0.5, 1.0], np.float32)
    thresh = float(np.float32(0.9) * np.float32(K))
    return U, (mean, sigma, coeff, LAM, ALPHA, thresh)


@pytest.mark.parametrize("map_kind", ["32", "1024"])
@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue", "epilogue+lr"])
def test_b1_plain_matches_jax_kernel(map_kind, mode):
    (jdyn, jcost, _), (dyn, cost, _) = _setup(map_kind)
    U, lr = _rollout_inputs()
    with_lr = mode.endswith("+lr")
    jlr = (tuple(jnp.asarray(a) for a in lr[:3]) + tuple(jnp.float32(v) for v in lr[3:])
           if with_lr else None)
    tlr = tuple(torch.from_numpy(a) for a in lr[:3]) + lr[3:] if with_lr else None
    x0, Ut = torch.from_numpy(X0), torch.from_numpy(U)
    if mode.startswith("costs"):
        jc, jcrash = pallas_rollout.fused_rollout_costs(
            jdyn, jcost, jnp.asarray(X0), jnp.asarray(U), DT, tile_k=128, lr_params=jlr)
        tc, tcrash = fr.fused_rollout_costs(dyn, cost, x0, Ut, DT, lr_params=tlr)
    else:
        jc, jcrash, jmean, jbase, jeta = pallas_rollout.fused_weighted_rollout(
            jdyn, jcost, jnp.asarray(X0), jnp.asarray(U), DT, LAM, lr_params=jlr,
            tile_k=128)
        tc, tcrash, tmean, tbase, teta = fr.fused_weighted_rollout(
            dyn, cost, x0, Ut, DT, LAM, lr_params=tlr)
        _close(tmean, jmean, 1e-4, 1e-5, "new mean")
        _close(tbase, jbase, 1e-5, 0, "baseline")
        _close(teta, jeta, 1e-4, 0, "eta")
    _close(tc, jc, 2e-5, 2e-4, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    assert 0 < int(np.asarray(jcrash).sum()) < K


@pytest.fixture
def one_thread():
    """The plain versions run thousands of small operations per solve;
    with the suite's parallel workers, PyTorch's intra-op threads would
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PATHS = [("fused_solve", "pallas_fused"), ("fused", "pallas"), ("combined", "combined")]


@pytest.mark.parametrize("port_kernel,jax_kernel", PATHS)
def test_vanilla_solve_matches_jax(port_kernel, jax_kernel, monkeypatch, one_thread,
                                   fresh_jit_cache):
    """One solve of the bench configuration (cut to K=256, T=16, a warm mean,
    stride 1) on the 32^2 map through each path, against JAX on the same
    normals (JAX's pallas_fused takes its XLA path off the TPU, with the
    patched _draw_noise)."""
    eps = _normals("gaussian", seed=21)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, m, n, s=0: jnp.asarray(eps))
    (jdyn, jcost, jsamp), _ = _setup("32")
    jc = JVanilla(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(DT),
                  lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T,
                  num_rollouts=K, num_iters=1, kernel=jax_kernel)
    tc = convert.vanilla_from_params(
        jax_dynamics_params(jdyn), jax_cost_params(jcost),
        {n: np.asarray(getattr(jsamp, n)) for n in SAMPLER_FIELDS},
        dict(dt=DT, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K, num_iters=1),
        device="cpu", kernel=port_kernel, dynamics_kind="autorally",
        cost_kind="ar_standard")
    js = jc.init_state(jax.random.PRNGKey(0)).replace(control_mean=jnp.asarray(_mean()))
    ts = convert.state_from_params(
        {n: np.asarray(getattr(js, n))
         for n in ("control_mean", "control_history", "previous_baseline")}, tc)
    jres, jnew = jc.solve(jnp.asarray(X0), js, 1)
    tres, tnew = tc.solve(torch.from_numpy(X0), ts, 1, injected_noise=torch.from_numpy(eps))
    _close(tres.costs, jres.costs, 2e-5, 2e-4, "costs")
    np.testing.assert_array_equal(tres.crash.numpy(), np.asarray(jres.crash))
    assert 0 < int(np.asarray(jres.crash).sum()) < K
    _close(tres.baseline, jres.baseline, 1e-5, 0, "baseline")
    _close(tres.control_mean, jres.control_mean, 1e-4, 1e-5, "control mean")
    _close(tnew.control_mean, jnew.control_mean, 1e-4, 1e-5, "new control mean")
    _close(tres.state_trajectory, jres.state_trajectory, 1e-4, 1e-5, "state trajectory")
