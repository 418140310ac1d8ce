"""The fused sampling kernel (B4) for every pair that gained it, on the CPU:
the plain version of the port's ``fused_sample_rollout_costs`` (what the
wrapper runs on CPU tensors) against the JAX package's
``fused_sample_rollout_costs`` (its Pallas kernel in interpret mode) on the
same injected normals, for AutoRally's network, the quadrotor with either
cost, the Dubins car and the double integrator with ``QuadraticCost`` or
its robust cost (RMPPI's, here under a vanilla controller), the
bicycle slip with the AutoRally cost, and the two racer LSTM models in the
kernel's recurrent mode (the (h, c) carry from the model's warm state);
also the bicycle's fused solve (B3) against JAX ``fused_solve_iteration``.

Samplers: Gaussian, NLN (p = 0.25) and Smooth-MPPI with its epilogue over
the derivative samples W (the racer models Gaussian and Smooth), all with
stride 2; one ragged case (K = 200, a 10 % pure-noise tail). The maps are
the ones of the earlier slices' tests where part of the samples crash
(AutoRally's and the bicycle's 32^2 maps, the racer's track map, the
quadrotor's gate map), and the tests assert a mixed crash population there.

Sizes: K = 128, T = 10; T = 16 for the quadrotor on its map, AutoRally and
the bicycle and T = 20 for the racer steering model, so that part of the
samples reach the hot block; the racer uncertainty model K = 64, T = 6
(JAX's interpret-mode LSTM kernels take seconds). The racer cases are in
test_torch_sample_racer.py, which runs them through ``check_b4``. Tolerances: U and W rtol 1e-5 / atol 1e-6; costs rtol 1e-5 / atol
1e-5 for the analytic pairs, rtol 1e-4 / atol 1e-4 for the AutoRally family
(network, head and map sums in other orders); crash flags exactly;
baselines rtol 1e-5; new means rtol 1e-4 / atol 1e-5 and eta rtol 1e-4,
each widened by what the measured cost differences can move them
(``_weight_slack`` of test_torch_zoo_kernels.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.ops.pallas_solve import fused_solve_iteration as jax_solve
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import NLNDistribution as JNLN
from mppi_generic_tpu.sampling import SmoothMPPIDistribution as JSmooth
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve
from test_torch_zoo import jax_fields, port_of, zoo_pair
from test_torch_zoo_kernels import _weight_slack

DT, LAM, ALPHA, STRIDE = 0.02, 1.3, 0.1, 2
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")
ANALYTIC = ("quadrotor_quadratic", "quadrotor_map", "dubins_quadratic", "di_quadratic")
AR_FAMILY = ("ar_nn", "bicycle_ar", "racer_steering_ar", "racer_unc_ar")
# pairs whose map lets part of the samples crash
CRASHING = ("ar_nn", "bicycle_ar", "racer_steering_ar", "quadrotor_map")
SHAPES = {"racer_steering_ar": (128, 20), "racer_unc_ar": (64, 6), "quadrotor_map": (128, 16),
          "ar_nn": (128, 16), "bicycle_ar": (128, 16)}
TOL = {"analytic": (1e-5, 1e-5), "ar": (1e-4, 1e-4)}


def shape(name):
    return SHAPES.get(name, (128, 10))


@functools.lru_cache(maxsize=None)
def pair_parts(name):
    """(JAX dynamics, JAX cost, port dynamics, port cost, x0, std, the
    mean's offset per channel) of one pair on the CPU."""
    if name in ANALYTIC + ("cartpole",):
        jdyn, jcost, x0, std, offset = zoo_pair(name)
        if name == "quadrotor_map":  # beside the gate's right post: a share crashes
            x0 = x0.copy()
            x0[0], x0[1], x0[3] = 1.337, -2.3, 0.15
        off = np.zeros(jdyn.CONTROL_DIM, np.float32)
        off[-1] = offset
        return (jdyn, jcost, *port_of(jdyn, jcost), x0, std, off)
    if name == "di_robust":
        from test_torch_robust_family_kernels import _di_robust_pair
        return (*_di_robust_pair(), np.array([2.0, 0.0, 0.0, 2.0], np.float32), [1.0, 1.0],
                np.zeros(2, np.float32))
    if name == "ar_nn":
        from test_torch_autorally_kernels import X0, _setup
        (jdyn, jcost, _), (dyn, cost, _) = _setup("32")
        return jdyn, jcost, dyn, cost, X0, [0.3, 0.5], np.zeros(2, np.float32)
    if name == "bicycle_ar":
        from test_torch_bicycle import X0, _setup
        (jdyn, jcost), (dyn, cost) = _setup()
        return jdyn, jcost, dyn, cost, X0, [0.3, 0.5], np.array([0.1, 0.0], np.float32)
    from test_torch_racer_kernels import _setup, _x0
    kind = "steering" if name == "racer_steering_ar" else "unc"
    (jdyn, jcost, _), (dyn, cost, _) = _setup(kind)
    return jdyn, jcost, dyn, cost, _x0(kind), [0.3, 0.5], np.array([0.3, 0.0], np.float32)


def samplers(name, kind, p, T):
    """(JAX sampler, port sampler) of ``kind`` for the pair."""
    std = pair_parts(name)[5]
    kw = dict(std_dev=std, control_cost_coeff=[0.5] * len(std), pure_noise_percentage=p)
    if kind == "smooth":
        jsamp = JSmooth.create(num_timesteps=T, dt=0.05, **kw)
    else:
        jsamp = (JNLN if kind == "nln" else JGaussian).create(**kw)
    fields = jax_fields(jsamp, SAMPLER_FIELDS)
    if kind == "smooth":
        fields.update(dt_smooth=np.asarray(jsamp.dt_smooth), num_timesteps=T)
    return jsamp, convert.SAMPLERS[kind](fields)


def inputs(name, kind, K, T, seed):
    """(x0, mean, derivative mean or None, normals) of one case."""
    C = pair_parts(name)[0].CONTROL_DIM
    rng = np.random.default_rng(seed)
    mean = (0.2 * rng.normal(size=(T, C)) + pair_parts(name)[6]).astype(np.float32)
    dmean = rng.normal(scale=0.5, size=(T, C)).astype(np.float32) if kind == "smooth" else None
    Z = rng.normal(size=(2, K, T, C)).astype(np.float32)
    return pair_parts(name)[4], mean, dmean, Z if kind == "nln" else Z[0]


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.fixture
def one_thread():
    """The plain versions run many small operations; with the suite's
    parallel workers, PyTorch's intra-op threads would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_b4(jdyn, jcost, jsamp, x0, mean, dmean, Z, K, epilogue):
    return pallas_rollout.fused_sample_rollout_costs(
        jdyn, jcost, jsamp, jnp.asarray(x0), jnp.asarray(mean), jnp.int32(0), DT, LAM,
        ALPHA, K, optimization_stride=STRIDE, tile_k=128,
        sampler_state=None if dmean is None else jnp.asarray(dmean), epilogue=epilogue,
        injected_noise=jnp.asarray(Z))


B4_CASES = ([(name, kind, 0.25 if kind == "nln" else 0.0, None)
             for name in ANALYTIC + ("ar_nn", "bicycle_ar")
             for kind in ("gaussian", "nln", "smooth")]
            + [("di_robust", kind, 0.0, None) for kind in ("gaussian", "smooth")]
            + [("ar_nn", "gaussian", 0.1, 200)])  # ragged: K = 200, 10 % pure noise


@pytest.mark.parametrize("name,kind,p,K_ragged", B4_CASES)
def test_b4_plain_matches_jax_kernel(name, kind, p, K_ragged, one_thread):
    check_b4(name, kind, p, K_ragged)


def check_b4(name, kind, p, K_ragged=None):
    """B4's plain version against JAX's kernel for one pair and sampler;
    with ``K_ragged`` at that K instead of the pair's."""
    jdyn, jcost, dyn, cost, *_ = pair_parts(name)
    K, T = shape(name)
    K = K_ragged or K
    jsamp, samp = samplers(name, kind, p, T)
    x0, mean, dmean, Z = inputs(name, kind, K, T, seed=len(name) + len(kind))
    epilogue = kind == "smooth"
    jout = [None if a is None else np.asarray(a)
            for a in _jax_b4(jdyn, jcost, jsamp, x0, mean, dmean, Z, K, epilogue)]
    tout = fr.fused_sample_rollout_costs(
        dyn, cost, samp, torch.from_numpy(x0), torch.from_numpy(mean), 0, DT, LAM, ALPHA,
        K, optimization_stride=STRIDE,
        sampler_state=None if dmean is None else torch.from_numpy(dmean),
        epilogue=epilogue, injected_noise=torch.from_numpy(Z))
    rtol, atol = TOL["ar" if name in AR_FAMILY else "analytic"]
    _close(tout[2], jout[2], 1e-5, 1e-6, "U")
    _close(tout[0], jout[0], rtol, atol, "costs")
    np.testing.assert_array_equal(tout[1].numpy(), jout[1])
    if name in CRASHING and kind == "gaussian":
        assert 0 < int(jout[1].sum()) < K  # some samples crash, some do not
    if epilogue:
        # the epilogue weights W, the derivative samples (smooth-MPPI.cu:203-236)
        W = np.asarray(_jax_b4(jdyn, jcost, jsamp, x0, mean, dmean, Z, K, False)[3])
        eta_rtol, mean_atol = _weight_slack(tout[0], jout[0], W, jout[3], LAM)
        _close(tout[3], jout[3], 1e-4, mean_atol, "new derivative mean")
        _close(tout[4], jout[4], 1e-5, 0, "baseline")
        _close(tout[5], jout[5], eta_rtol, 0, "eta")
        # the derivative samples of the port's plain version without the epilogue
        plain = fr.fused_sample_rollout_costs(
            dyn, cost, samp, torch.from_numpy(x0), torch.from_numpy(mean), 0, DT, LAM,
            ALPHA, K, optimization_stride=STRIDE, sampler_state=torch.from_numpy(dmean),
            injected_noise=torch.from_numpy(Z))
        _close(plain[3], W, 1e-5, 1e-6, "W")


@pytest.mark.parametrize("kind,p", [("gaussian", 0.0), ("nln", 0.25)])
def test_bicycle_b3_plain_matches_jax_kernel(kind, p, one_thread):
    jdyn, jcost, dyn, cost, *_ = pair_parts("bicycle_ar")
    K, T = shape("bicycle_ar")
    jsamp, samp = samplers("bicycle_ar", kind, p, T)
    x0, mean, _, Z = inputs("bicycle_ar", kind, K, T, seed=3 + len(kind))
    jout = jax_solve(jdyn, jcost, jsamp, jnp.asarray(x0), jnp.asarray(mean), jnp.int32(0),
                     DT, LAM, ALPHA, K, optimization_stride=STRIDE, tile_k=128,
                     return_samples=True, injected_noise=jnp.asarray(Z))
    costs, crash, new_mean, baseline, eta, U = fused_solve.fused_solve_iteration(
        dyn, cost, samp, torch.from_numpy(x0), torch.from_numpy(mean), 0, DT, LAM, ALPHA,
        K, optimization_stride=STRIDE, return_samples=True, injected_noise=torch.from_numpy(Z))
    j_costs, j_crash, j_mean, j_base, j_eta, j_U = (np.asarray(a) for a in jout)
    _close(U, j_U, 1e-5, 1e-6, "U")
    _close(costs, j_costs, *TOL["ar"], "costs")
    np.testing.assert_array_equal(crash.numpy(), j_crash)
    assert 0 < int(j_crash.sum()) < K  # some samples crash, some do not
    eta_rtol, mean_atol = _weight_slack(costs, j_costs, j_U, j_mean, LAM)
    _close(baseline, j_base, 1e-5, 0, "baseline")
    _close(eta, j_eta, eta_rtol, 0, "eta")
    _close(new_mean, j_mean, 1e-4, mean_atol, "new mean")


SPLIT_PAIRS = ("cartpole", "quadrotor_quadratic", "di_quadratic", "dubins_quadratic",
               "bicycle_ar", "racer_steering_ar", "racer_unc_ar")
FAMILY_PAIRS = ("racer_dubins_ar", "racer_elevation_ar", "racer_suspension_ar",
                "bicycle_elevation_ar", "racer_elev_susp_ar")


def _pair_classes():
    """{pair name: (dynamics class, cost class)} of ``fr._PAIRS``."""
    out = {}
    for (dyn_cls, cost_cls), name in fr._PAIRS.items():
        out.setdefault(name, (dyn_cls, cost_cls))
    return out


@pytest.mark.parametrize("name", sorted(set(fr._PAIRS.values())))
def test_every_pair_has_the_kernels_jax_runs_it_on(name):
    """Each pair of ``fr._PAIRS`` resolves its entries by name, with no
    card: B1, B3 and B4 for every pair, the split kinds for every pair whose
    cost is eligible (the robust DI cost's too), B1 from one x0 per sample
    for every pair and its split for every eligible one, B8 for every pair
    but the racer LSTMs (JAX refuses a recurrent model there). The robust
    family's entries of the later pairs live in ``robust_<pair>``. The rest
    of the racer family and the bicycle on its elevation map
    (``FAMILY_PAIRS``) have B1, B3 and B4 only: their robust and split
    entries are still to come."""
    dyn_cls, cost_cls = _pair_classes()[name]
    dyn, cost = object.__new__(dyn_cls), object.__new__(cost_cls)
    eligible = name in SPLIT_PAIRS + ("di_circle", "ar_nn", "di_robust")
    has_robust = name not in FAMILY_PAIRS
    kinds = {"sample": True, "solve": True, "rollout": True, "rollout_x0": has_robust,
             "rmppi": has_robust and name not in ("racer_steering_ar", "racer_unc_ar"),
             "split_dynamics": eligible, "split_solve_dynamics": eligible,
             "split_cost": eligible, "split_dynamics_x0": eligible}
    first = ("di_circle", "di_robust", "ar_nn")
    for kind, has in kinds.items():
        if not has:
            with pytest.raises(NotImplementedError, match="no CUDA"):
                fr._entry(dyn, cost, kind)
            continue
        lib, fn = fr._entry(dyn, cost, kind)
        assert fn == fr._build._ENTRY_PREFIX[kind] + name
        robust = kind in ("rollout_x0", "rmppi", "split_dynamics_x0")
        if robust and name not in first and (name, kind) != ("bicycle_ar", "rollout_x0"):
            want = f"robust_{name}"
        elif kind in ("rollout_x0", "rmppi"):
            want = {"rollout_x0": "rollout_x0", "rmppi": "rmppi_rollout"}[kind]
        else:
            want = {("sample", "ar_nn"): "sample_ar_nn",
                    ("sample", "racer_steering_ar"): "sample_racer_steering_ar",
                    ("sample", "racer_unc_ar"): "sample_racer_unc_ar",
                    ("sample", "racer_elev_susp_ar"): "sample_racer_elev_susp_ar",
                    ("split_dynamics_x0", "ar_nn"): "split_x0_ar_nn"}.get(
                (kind, name), f"split_{name}" if kind.startswith("split") else f"pair_{name}")
        assert lib == want
        assert fn in fr._build.SIGNATURES[lib]
