"""The analytic model zoo on the kernel paths, on the CPU: the plain versions
of the port's B1 (fused rollout: costs + LR, the exp epilogue, Tsallis pass
1), B3 (fused solve) and B4 (fused sampling) for each new (dynamics, cost)
pair against the JAX package's Pallas kernels in interpret mode on the same
samples or injected normals, and one cartpole solve on ``fused_solve`` and
on ``combined`` against JAX ``pallas_fused`` and ``combined``.

The pairs and their configurations are ``test_torch_zoo.zoo_pair``'s (the
cartpole of bench.py:599-608, the quadrotor of tests/test_model_zoo.py:60-92
with its quadratic cost or the map cost of
examples/quadrotor_waypoint_example.py on a 64^2 map with one gate, the
Dubins car and the double integrator of examples/double_integrator_example.py
with ``QuadraticCost``, the Dubins car also with a goal trajectory), cut to
K=256, T=16. Tolerances: U rtol 1e-5 / atol 1e-6; costs rtol 2e-5 / atol
2e-4 (XLA and the plain versions take transcendentals and the map product
in other orders); crash flags exactly; baselines rtol 1e-5; new means rtol
1e-4 / atol 1e-5 and eta rtol 1e-4, each widened by what the measured cost
differences dJ can move them (``_weight_slack``): the cartpole's costs are
about 1e3, where an ulp of cost moves a normExp weight by 2 dJ / lambda and
a Tsallis weight (r = 2) by 2 dJ / gamma (the AutoRally and Tsallis traps
of ROADMAP.md section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.ops.pallas_solve import fused_solve_iteration as jax_solve
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import NLNDistribution as JNLN
from mppi_generic_tpu.sampling import SmoothMPPIDistribution as JSmooth
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve
from test_torch_zoo import ZOO_PAIRS, jax_fields, port_of, zoo_pair

K, T = 256, 16
DT, LAM, ALPHA, STRIDE = 0.02, 1.3, 0.1, 2
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def _weight_slack(tc, jc, U, jmean, scale, n=None):
    """(eta rtol, mean atol) widened by the measured cost differences:
    every weight moves by at most 2 max|dJ| / scale (relative for normExp
    with scale = lambda; absolute for Tsallis r = 2 with scale = gamma, over
    the ``n`` weighted samples), and the mean by that share of eta times the
    samples' largest distance from the mean."""
    move = 2 * float(np.max(np.abs(np.asarray(tc) - np.asarray(jc)))) / scale
    if n is not None:
        move = move * n
    spread = float(np.max(np.abs(np.asarray(U) - np.asarray(jmean)[None])))
    return max(1e-4, move), 1e-5 + move * spread


def _x0(name):
    """The pair's x0; the map cost's starts beside the gate's right post,
    moving toward its band, so that some samples hit it and crash."""
    x0 = zoo_pair(name)[2].copy()
    if name == "quadrotor_map":
        x0[0], x0[1], x0[3] = 1.337, -2.3, 0.15
    return x0


def _mean(name, C, seed=12):
    mean = (0.3 * np.random.default_rng(seed).normal(size=(T, C))).astype(np.float32)
    mean[:, -1] += zoo_pair(name)[4]
    return mean


def _rollout_inputs(name, jdyn, seed=13):
    C = jdyn.CONTROL_DIM
    mean = _mean(name, C, seed)
    sigma = np.tile(np.float32(zoo_pair(name)[3])[None], (T, 1))
    U = mean + sigma * np.random.default_rng(seed).normal(size=(K, T, C)).astype(np.float32)
    U = np.asarray(jdyn.enforce_constraints(None, jnp.asarray(U).transpose(2, 0, 1))
                   ).transpose(1, 2, 0).copy()
    coeff = np.full((C,), 0.5, np.float32)
    thresh = float(np.float32(0.9) * np.float32(K))
    return U, (mean, sigma, coeff, LAM, ALPHA, thresh)


@pytest.mark.parametrize("name", ZOO_PAIRS)
@pytest.mark.parametrize("mode", ["costs+lr", "epilogue+lr", "tsallis+lr"])
def test_b1_plain_matches_jax_kernel(name, mode):
    jdyn, jcost, *_ = zoo_pair(name)
    dyn, cost = port_of(jdyn, jcost)
    U, lr = _rollout_inputs(name, jdyn)
    x0 = _x0(name)
    jlr = tuple(jnp.asarray(a) for a in lr[:3]) + tuple(jnp.float32(v) for v in lr[3:])
    tlr = tuple(torch.from_numpy(a) for a in lr[:3]) + lr[3:]
    if mode == "costs+lr":
        jc, jcrash = pallas_rollout.fused_rollout_costs(
            jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), DT, tile_k=128, lr_params=jlr)
        tc, tcrash = fr.fused_rollout_costs(dyn, cost, torch.from_numpy(x0),
                                            torch.from_numpy(U), DT, lr_params=tlr)
    else:
        kind = mode.split("+")[0].replace("epilogue", "exp")
        wp = (10.0, 2.0) if kind == "tsallis" else None
        jc, jcrash, jmean, jbase, jeta = pallas_rollout.fused_weighted_rollout(
            jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), DT, LAM, lr_params=jlr,
            tile_k=128, weight_kind=kind, weight_params=wp)
        tc, tcrash, tmean, tbase, teta = fr.fused_weighted_rollout(
            dyn, cost, torch.from_numpy(x0), torch.from_numpy(U), DT, LAM, lr_params=tlr,
            weight_kind=kind, weight_params=wp)
        n = None
        if kind == "tsallis":  # the weighted samples; eta is their weight sum
            n = int(np.sum(np.asarray(jc) - float(jbase) < wp[0]))
        eta_rtol, mean_atol = _weight_slack(tc, jc, U, jmean, wp[0] if wp else LAM, n)
        if n is not None:
            eta_rtol = eta_rtol / float(jeta)
        _close(tmean, jmean, 1e-4, mean_atol, "new mean")
        _close(tbase, jbase, 1e-5, 0, "baseline")
        _close(teta, jeta, eta_rtol, 0, "eta")
    _close(tc, jc, 2e-5, 2e-4, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    if name == "quadrotor_map":
        assert 0 < int(np.asarray(jcrash).sum()) < K  # some samples hit the gate


def _sampler(kind, name, C, p=0.0):
    std = zoo_pair(name)[3]
    if kind == "nln":
        return JNLN.create(std_dev=std, control_cost_coeff=[0.5] * C,
                           pure_noise_percentage=p)
    if kind == "smooth":
        return JSmooth.create(std_dev=std, num_timesteps=T, dt=0.05,
                              control_cost_coeff=[0.5] * C, pure_noise_percentage=p)
    return JGaussian.create(std_dev=std, control_cost_coeff=[0.5] * C,
                            pure_noise_percentage=p)


def _port_sampler(kind, jsamp):
    p = jax_fields(jsamp, SAMPLER_FIELDS)
    if kind == "smooth":
        p.update(dt_smooth=np.asarray(jsamp.dt_smooth), num_timesteps=T)
    return convert.SAMPLERS[kind](p)


B3_CASES = [(name, "gaussian") for name in ZOO_PAIRS] + [("cartpole", "nln")]


@pytest.mark.parametrize("name,kind", B3_CASES)
def test_b3_plain_matches_jax_kernel(name, kind):
    jdyn, jcost, *_ = zoo_pair(name)
    dyn, cost = port_of(jdyn, jcost)
    C = jdyn.CONTROL_DIM
    jsamp = _sampler(kind, name, C, p=0.25)
    samp = _port_sampler(kind, jsamp)
    Z = np.random.default_rng(len(name)).normal(size=(2, K, T, C)).astype(np.float32)
    Z = Z if kind == "nln" else Z[0]
    x0, mean = _x0(name), _mean(name, C)
    jout = jax_solve(jdyn, jcost, jsamp, jnp.asarray(x0), jnp.asarray(mean), jnp.int32(0),
                     DT, LAM, ALPHA, K, optimization_stride=STRIDE, tile_k=128,
                     return_samples=True, injected_noise=jnp.asarray(Z))
    costs, crash, new_mean, baseline, eta, U = fused_solve.fused_solve_iteration(
        dyn, cost, samp, torch.from_numpy(x0), torch.from_numpy(mean), 0, DT, LAM, ALPHA,
        K, optimization_stride=STRIDE, return_samples=True,
        injected_noise=torch.from_numpy(Z))
    j_costs, j_crash, j_mean, j_base, j_eta, j_U = (np.asarray(a) for a in jout)
    _close(U, j_U, 1e-5, 1e-6, "U")
    _close(costs, j_costs, 2e-5, 2e-4, "costs")
    np.testing.assert_array_equal(crash.numpy(), j_crash)
    eta_rtol, mean_atol = _weight_slack(costs, j_costs, j_U, j_mean, LAM)
    _close(baseline, j_base, 1e-5, 0, "baseline")
    _close(eta, j_eta, eta_rtol, 0, "eta")
    _close(new_mean, j_mean, 1e-4, mean_atol, "new mean")


@pytest.mark.parametrize("kind,epilogue", [("gaussian", False), ("nln", False),
                                           ("smooth", False), ("smooth", True)])
def test_b4_cartpole_plain_matches_jax_kernel(kind, epilogue):
    jdyn, jcost, *_ = zoo_pair("cartpole")
    dyn, cost = port_of(jdyn, jcost)
    jsamp = _sampler(kind, "cartpole", 1, p=0.25)
    samp = _port_sampler(kind, jsamp)
    rng = np.random.default_rng(7)
    Z = rng.normal(size=(2, K, T, 1)).astype(np.float32)
    Z = Z if kind == "nln" else Z[0]
    dmean = rng.normal(scale=0.5, size=(T, 1)).astype(np.float32)
    state = dmean if kind == "smooth" else None
    x0, mean = _x0("cartpole"), _mean("cartpole", 1)
    jout = pallas_rollout.fused_sample_rollout_costs(
        jdyn, jcost, jsamp, jnp.asarray(x0), jnp.asarray(mean), jnp.int32(0), DT, LAM,
        ALPHA, K, optimization_stride=STRIDE, tile_k=128,
        sampler_state=None if state is None else jnp.asarray(state), epilogue=epilogue,
        injected_noise=jnp.asarray(Z))
    tout = fr.fused_sample_rollout_costs(
        dyn, cost, samp, torch.from_numpy(x0), torch.from_numpy(mean), 0, DT, LAM, ALPHA,
        K, optimization_stride=STRIDE,
        sampler_state=None if state is None else torch.from_numpy(state),
        epilogue=epilogue, injected_noise=torch.from_numpy(Z))
    jout = [None if a is None else np.asarray(a) for a in jout]
    _close(tout[2], jout[2], 1e-5, 1e-6, "U")
    _close(tout[0], jout[0], 2e-5, 2e-4, "costs")
    np.testing.assert_array_equal(tout[1].numpy(), jout[1])
    if epilogue:
        # the epilogue weights W, the derivative samples (smooth-MPPI.cu:203-236)
        W = np.asarray(jax_sample_w(jdyn, jcost, jsamp, x0, mean, state, Z))
        eta_rtol, mean_atol = _weight_slack(tout[0], jout[0], W, jout[3], LAM)
        _close(tout[3], jout[3], 1e-4, mean_atol, "new derivative mean")
        _close(tout[4], jout[4], 1e-5, 0, "baseline")
        _close(tout[5], jout[5], eta_rtol, 0, "eta")
    elif kind == "smooth":
        _close(tout[3], jout[3], 1e-5, 1e-6, "W")


def jax_sample_w(jdyn, jcost, jsamp, x0, mean, state, Z):
    """The derivative samples W of the JAX sampling kernel without its
    epilogue, on the same normals."""
    return pallas_rollout.fused_sample_rollout_costs(
        jdyn, jcost, jsamp, jnp.asarray(x0), jnp.asarray(mean), jnp.int32(0), DT, LAM,
        ALPHA, K, optimization_stride=STRIDE, tile_k=128, sampler_state=jnp.asarray(state),
        injected_noise=jnp.asarray(Z))[3]


@pytest.fixture
def one_thread():
    """The plain versions run many small operations per solve; with the
    suite's parallel workers, PyTorch's intra-op threads would contend."""
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


@pytest.mark.parametrize("port_kernel,jax_kernel", [("fused_solve", "pallas_fused"),
                                                    ("combined", "combined")])
def test_cartpole_solve_matches_jax(port_kernel, jax_kernel, monkeypatch, one_thread,
                                    fresh_jit_cache):
    """One solve of the bench row cartpole_example_K8192 (bench.py:599-608:
    control range +-5, coefficients (100, 10, 200, 20), std 5, dt 0.02,
    lambda 1) cut to K=256, T=16, from a warm mean with stride 1, against
    JAX on the same normals (JAX's pallas_fused takes its XLA path off the
    TPU, with the patched _draw_noise)."""
    eps = np.random.default_rng(21).normal(size=(K, T, 1)).astype(np.float32)
    monkeypatch.setattr(JGaussian, "_draw_noise",
                        lambda self, key, m, n, s=0: jnp.asarray(eps))
    jdyn, jcost, *_ = zoo_pair("cartpole")
    jsamp = JGaussian.create(std_dev=[5.0])
    jc = JVanilla(dynamics=jdyn, cost=jcost, sampler=jsamp, dt=jnp.float32(DT),
                  lam=jnp.float32(1.0), alpha=jnp.float32(0.0), num_timesteps=T,
                  num_rollouts=K, num_iters=1, kernel=jax_kernel)
    from test_torch_zoo import jax_cost_params, jax_model_params
    tc = convert.vanilla_from_params(
        jax_model_params(jdyn), jax_cost_params(jcost), jax_fields(jsamp, SAMPLER_FIELDS),
        dict(dt=DT, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K, num_iters=1),
        device="cpu", kernel=port_kernel, dynamics_kind="cartpole", cost_kind="cartpole")
    mean = _mean("cartpole", 1)
    js = jc.init_state(jax.random.PRNGKey(0), initial_mean=jnp.asarray(mean))
    ts = tc.init_state(seed=0, initial_mean=torch.from_numpy(mean))
    x0 = _x0("cartpole")
    jres, jnew = jc.solve(jnp.asarray(x0), js, 1)
    tres, tnew = tc.solve(torch.from_numpy(x0), ts, 1, injected_noise=torch.from_numpy(eps))
    _close(tres.costs, jres.costs, 2e-5, 2e-4, "costs")
    _close(tres.baseline, jres.baseline, 1e-5, 0, "baseline")
    U = np.clip(np.asarray(mean)[None] + 5.0 * eps, -5.0, 5.0)  # the clamped samples
    _, mean_atol = _weight_slack(tres.costs, jres.costs, U, jres.control_mean, 1.0)
    _close(tres.control_mean, jres.control_mean, 1e-4, mean_atol, "control mean")
    _close(tnew.control_mean, jnew.control_mean, 1e-4, mean_atol, "new control mean")
    _close(tres.state_trajectory, jres.state_trajectory, 1e-4, T * DT * mean_atol + 1e-5,
           "state trajectory")
