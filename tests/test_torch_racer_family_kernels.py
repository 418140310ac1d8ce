"""The rest of the racer family on the CPU: the plain versions of the port's
B1 (fused rollout), B3 (fused solve) and B4 (fused sampling) entries against
the JAX package's Pallas kernels in interpret mode, on the same controls or
injected normals. This file holds the helpers and RACER Dubins
(``racer_dubins_ar``); each other pair has a file of its own, so that each
runs in about half a minute on one worker:
``test_torch_racer_family_elevation.py`` (the elevation model without an
LSTM), ``..._suspension.py`` and ``..._suspension_sampling.py`` (the
rigid-body RacerSuspension), ``..._bicycle.py`` and
``..._bicycle_sampling.py`` (BicycleSlipParametricElevation), ``..._elev_susp.py``
and ``..._elev_susp_sampling.py`` (the suspension model with its steering
LSTM) and ``..._unc_map.py``, ``..._unc_map_b3.py``, ``..._unc_map_b4.py``
(the LSTM-uncertainty model on an elevation map, the racer_unc_ar entries'
map mode).

The configurations: each model as the JAX package's own kernel tests build
it (its defaults; the bicycle with nonzero feedback gains K so that its
Jacobian acts; the LSTMs from JAX keys at scale 0.5), on the 32^2 elevation
map of test_torch_racer.py where the model reads one, with ARStandardCost on
the 32^2 track map of test_torch_racer_kernels.py (a hot block ahead and to
the left, so that part of the samples crash) and the output layout the
pair's entries are compiled for. K = 64 (61 for the ragged cases), T = 12,
stride 2.

Modes: B1 costs, costs + LR, the exp epilogue + LR, Tsallis + LR (gamma 10,
r 2); B3 Gaussian and NLN (p = 0.25); B4 Gaussian, NLN, Smooth-MPPI and
Smooth-MPPI with its epilogue over W.

Tolerances: crash flags exactly; U and W rtol 1e-5 / atol 1e-6; costs rtol
1e-5 / atol 1e-5, rtol 1e-4 / atol 1e-4 for the pairs with an LSTM (its
gates and head summed in another order) or where samples crash (J about
1e4, as the racer rows, ROADMAP.md section 3); baselines and rho rtol 1e-5;
new means rtol 1e-4 / atol 1e-5 and eta rtol 1e-4, each widened by what the
measured cost differences can move them (``_weight_slack`` of
test_torch_zoo_kernels.py for the exp weights, of test_torch_tsallis_kernels.py
for the Tsallis weights).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import ARStandardCost as JStandard
from mppi_generic_tpu.models import BicycleSlipParametricElevation as JBicycle
from mppi_generic_tpu.models import RacerDubinsDynamics as JRacerDubins
from mppi_generic_tpu.models import RacerDubinsElevationDynamics as JElevation
from mppi_generic_tpu.models import RacerSuspensionDynamics as JSuspension
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.ops.pallas_solve import fused_solve_iteration as jax_solve
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import NLNDistribution as JNLN
from mppi_generic_tpu.sampling import SmoothMPPIDistribution as JSmooth
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.models import (
    RacerDubinsDynamics,
    RacerDubinsElevationDynamics,
    RacerDubinsElevationLSTMUncertainty,
    RacerDubinsElevationSuspension,
)
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve
from test_torch_autorally import jax_cost_params
from test_torch_bicycle_elevation import jax_bicycle_params
from test_torch_racer import jax_elevation_map, jax_racer, jax_racer_params
from test_torch_racer_kernels import _track_map
from test_torch_racer_suspension import jax_suspension_params
from test_torch_tsallis_kernels import _weight_slack as tsallis_slack
from test_torch_zoo_kernels import _weight_slack

C, DT, LAM, ALPHA, STRIDE = 2, 0.02, 1.3, 0.1, 2
K, K_RAGGED, T = 64, 61, 12
GAMMA, R = 10.0, 2.0
SAMPLER_FIELDS = ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                  "std_dev_decay")
RACER_INDICES = (2, 3, 5, 6, 0, 1)
CONSTRAINTS = ("control_ranges", "control_deadband", "zero_control")
# the pairs whose step runs an LSTM
LSTM_PAIRS = ("racer_elev_susp_ar", "racer_unc_map")
B1_MODES = ("costs", "costs+lr", "epilogue+lr", "tsallis+lr")
B3_KINDS = ("gaussian", "nln")
B4_KINDS = ("gaussian", "nln", "smooth")


def _racer_x0(S, px=0.4, py=0.05):
    """A racer state at 3 m/s, yaw 0.2, at (px, py) on the maps: toward the
    hot block's lower edge, so that part of the samples reach it."""
    x0 = np.zeros(S, np.float32)
    x0[0], x0[1], x0[2], x0[3] = 3.0, 0.2, px, py
    return x0


@functools.lru_cache(maxsize=None)
def family_jax(name):
    """(JAX dynamics, its parameters for ``convert``, the port's dynamics
    kind in ``convert.DYNAMICS``, x0, the cost's output layout) of a pair."""
    emap, indices = jax_elevation_map(), RACER_INDICES
    if name == "racer_dubins_ar":
        jdyn, kind = JRacerDubins.create(), "racer_dubins"
        p = {n: np.asarray(getattr(jdyn, n)) for n in CONSTRAINTS
             + RacerDubinsDynamics.param_names()}
        x0 = _racer_x0(7)
    elif name == "racer_elevation_ar":
        jdyn, kind = JElevation.create(elevation_map=emap), "racer_elevation"
        p = jax_racer_params(jdyn, RacerDubinsElevationDynamics)
        x0 = _racer_x0(9)
    elif name == "racer_suspension_ar":
        jdyn, kind = JSuspension.create(elevation_map=emap), "racer_suspension"
        p, indices = jax_suspension_params(jdyn), (0, 1, 5, 6, 3, 4)
        x0 = np.array(jdyn.get_zero_state())
        x0[7] = 3.0
    elif name == "bicycle_elevation_ar":
        jdyn = JBicycle.create(elevation_map=emap, K_x=0.3, K_y=0.2, K_yaw=0.1)
        p, kind = jax_bicycle_params(jdyn), "bicycle_elevation"
        x0 = np.zeros(22, np.float32)
        x0[0], x0[1], x0[2], x0[5] = 0.6, 0.2, 0.2, 3.0
        x0[12:16] = 0.05
    elif name == "racer_elev_susp_ar":
        jdyn, kind = jax_racer("suspension"), "racer_elev_susp"
        p = jax_racer_params(jdyn, RacerDubinsElevationSuspension)
        x0 = _racer_x0(23)
    else:  # racer_unc_map: the racer_unc_ar entries on an elevation map
        jdyn, kind = jax_racer("unc"), "racer_unc"
        p = jax_racer_params(jdyn, RacerDubinsElevationLSTMUncertainty)
        x0 = _racer_x0(26, py=0.02)
    return jdyn, p, kind, x0, indices


@functools.lru_cache(maxsize=None)
def family_parts(name):
    """(JAX dynamics, JAX cost, port dynamics, port cost, x0) of a pair."""
    jdyn, p, kind, x0, indices = family_jax(name)
    jcost = JStandard(costmap=_track_map(), output_indices=indices)
    return (jdyn, jcost, convert.DYNAMICS[kind](p),
            convert.ar_cost_from_params(jax_cost_params(jcost)), x0)


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def cost_tol(name, jcrash):
    """(rtol, atol) of the costs: 1e-5 unless the step runs an LSTM or
    samples crash."""
    if name in LSTM_PAIRS or bool(np.asarray(jcrash).any()):
        return 1e-4, 1e-4
    return 1e-5, 1e-5


def _mean(seed=12):
    m = (0.3 * np.random.default_rng(seed).normal(size=(T, C))).astype(np.float32)
    m[:, 0] += 0.3
    return m


def rollout_inputs(Kn, seed=13):
    """Clamped Gaussian controls around a mean and the LR tables (10 %
    pure noise)."""
    rng = np.random.default_rng(seed)
    mean = _mean(seed)
    sigma = np.tile(np.array([[0.3, 0.5]], np.float32), (T, 1))
    U = np.clip(mean + sigma * rng.normal(size=(Kn, T, C)), -1.0, 1.0).astype(np.float32)
    coeff = np.array([0.5, 1.0], np.float32)
    thresh = float(np.float32(0.9) * np.float32(Kn))
    return U, (mean, sigma, coeff, LAM, ALPHA, thresh)


def check_b1(name, mode, Kn=K):
    """B1's plain version in ``mode`` against JAX's kernel."""
    jdyn, jcost, dyn, cost, x0 = family_parts(name)
    U, lr = rollout_inputs(Kn)
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
        kw = (dict(weight_kind="tsallis", weight_params=(GAMMA, R)) if mode.startswith("tsallis")
              else {})
        jkw = ({k: (v if k == "weight_kind" else tuple(jnp.float32(a) for a in v))
                for k, v in kw.items()})
        jc, jcrash, jmean, jbase, jeta = pallas_rollout.fused_weighted_rollout(
            jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), DT, LAM, lr_params=jlr,
            tile_k=128, **jkw)
        tc, tcrash, tmean, tbase, teta = fr.fused_weighted_rollout(
            dyn, cost, tx0, Ut, DT, LAM, lr_params=tlr, **kw)
        _close(tbase, jbase, 1e-5, 0, "baseline")
        if kw:
            dJ = float(np.abs(tc.numpy() - np.asarray(jc)).max())
            slack = tsallis_slack(tc, tbase, GAMMA, R, dJ)
            _close(teta, jeta, 1e-5, slack, "eta")
            spread = float((Ut - tmean).abs().max())
            _close(tmean, jmean, 1e-4, 1e-5 + slack * spread / float(teta), "new mean")
        else:
            eta_rtol, mean_atol = _weight_slack(tc, jc, U, jmean, LAM)
            _close(teta, jeta, eta_rtol, 0, "eta")
            _close(tmean, jmean, 1e-4, mean_atol, "new mean")
    _close(tc, jc, *cost_tol(name, jcrash), "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    return np.asarray(jcrash)


def samplers(kind, p=0.0):
    """(JAX sampler, port sampler) of ``kind``: std [0.3, 0.5], coefficients
    [0.5, 1.0]."""
    kw = dict(std_dev=[0.3, 0.5], control_cost_coeff=[0.5, 1.0], pure_noise_percentage=p)
    if kind == "smooth":
        jsamp = JSmooth.create(num_timesteps=T, dt=0.05, **kw)
    else:
        jsamp = (JNLN if kind == "nln" else JGaussian).create(**kw)
    fields = {n: np.asarray(getattr(jsamp, n)) for n in SAMPLER_FIELDS}
    if kind == "smooth":
        fields.update(dt_smooth=np.asarray(jsamp.dt_smooth), num_timesteps=T)
    return jsamp, convert.SAMPLERS[kind](fields)


def normals(kind, Kn, seed):
    """Injected standard normals: (K, T, C), NLN (2, K, T, C)."""
    z = np.random.default_rng(seed).normal(size=(2, Kn, T, C)).astype(np.float32)
    return z if kind == "nln" else z[0]


def check_b3(name, kind, Kn=K):
    """B3's plain version (Gaussian or NLN at p = 0.25) against JAX's kernel."""
    jdyn, jcost, dyn, cost, x0 = family_parts(name)
    jsamp, samp = samplers(kind, 0.25 if kind == "nln" else 0.0)
    Z, mean = normals(kind, Kn, len(name) + len(kind)), _mean()
    jout = jax_solve(jdyn, jcost, jsamp, jnp.asarray(x0), jnp.asarray(mean), jnp.int32(0),
                     DT, LAM, ALPHA, Kn, optimization_stride=STRIDE, tile_k=128,
                     return_samples=True, injected_noise=jnp.asarray(Z))
    costs, crash, new_mean, baseline, eta, U = fused_solve.fused_solve_iteration(
        dyn, cost, samp, torch.from_numpy(x0), torch.from_numpy(mean), 0, DT, LAM, ALPHA,
        Kn, optimization_stride=STRIDE, return_samples=True, injected_noise=torch.from_numpy(Z))
    j_costs, j_crash, j_mean, j_base, j_eta, j_U = (np.asarray(a) for a in jout)
    _close(U, j_U, 1e-5, 1e-6, "U")
    _close(costs, j_costs, *cost_tol(name, j_crash), "costs")
    np.testing.assert_array_equal(crash.numpy(), j_crash)
    eta_rtol, mean_atol = _weight_slack(costs, j_costs, j_U, j_mean, LAM)
    _close(baseline, j_base, 1e-5, 0, "baseline")
    _close(eta, j_eta, eta_rtol, 0, "eta")
    _close(new_mean, j_mean, 1e-4, mean_atol, "new mean")
    return j_crash


def _jax_b4(jdyn, jcost, jsamp, x0, mean, dmean, Z, Kn, epilogue):
    return pallas_rollout.fused_sample_rollout_costs(
        jdyn, jcost, jsamp, jnp.asarray(x0), jnp.asarray(mean), jnp.int32(0), DT, LAM,
        ALPHA, Kn, optimization_stride=STRIDE, tile_k=128,
        sampler_state=None if dmean is None else jnp.asarray(dmean), epilogue=epilogue,
        injected_noise=jnp.asarray(Z))


def check_b4(name, kind, Kn=K):
    """B4's plain version against JAX's kernel: Gaussian, NLN (p = 0.25), or
    Smooth-MPPI (``kind`` "smooth"), which runs without and with its
    epilogue over W."""
    jdyn, jcost, dyn, cost, x0 = family_parts(name)
    jsamp, samp = samplers(kind, 0.25 if kind == "nln" else 0.0)
    rng = np.random.default_rng(len(name) + 3 * len(kind))
    mean = _mean(seed=int(rng.integers(100)))
    dmean = rng.normal(scale=0.5, size=(T, C)).astype(np.float32) if kind == "smooth" else None
    Z = normals(kind, Kn, int(rng.integers(100)))

    def port(epilogue):
        return fr.fused_sample_rollout_costs(
            dyn, cost, samp, torch.from_numpy(x0), torch.from_numpy(mean), 0, DT, LAM, ALPHA,
            Kn, optimization_stride=STRIDE,
            sampler_state=None if dmean is None else torch.from_numpy(dmean),
            epilogue=epilogue, injected_noise=torch.from_numpy(Z))

    jout = [None if a is None else np.asarray(a)
            for a in _jax_b4(jdyn, jcost, jsamp, x0, mean, dmean, Z, Kn, False)]
    tout = port(False)
    _close(tout[2], jout[2], 1e-5, 1e-6, "U")
    _close(tout[0], jout[0], *cost_tol(name, jout[1]), "costs")
    np.testing.assert_array_equal(tout[1].numpy(), jout[1])
    if kind == "smooth":
        W = jout[3]
        _close(tout[3], W, 1e-5, 1e-6, "W")
        # the epilogue over the derivative samples W (smooth-MPPI.cu:203-236)
        jepi = [np.asarray(a) for a in _jax_b4(jdyn, jcost, jsamp, x0, mean, dmean, Z, Kn,
                                                True)]
        tepi = port(True)
        eta_rtol, mean_atol = _weight_slack(tepi[0], jepi[0], W, jepi[3], LAM)
        _close(tepi[3], jepi[3], 1e-4, mean_atol, "new derivative mean")
        _close(tepi[4], jepi[4], 1e-5, 0, "baseline")
        _close(tepi[5], jepi[5], eta_rtol, 0, "eta")
    return jout[1]


@pytest.fixture
def one_thread():
    """One thread (the plain versions run many small operations; with the
    suite's parallel workers, PyTorch's intra-op threads would contend) and
    TF32 off, as the JAX tests run at "highest" precision."""
    saved = (torch.get_num_threads(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(saved[0])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[1:]


# --- RACER Dubins ------------------------------------------------------------
# The layout (2, 3, 5, 6, 0, 1) of the JAX suite's test of this model reads
# its steering rate as the roll: every sample passes pi / 2 and crashes, at
# different steps.
NAME = "racer_dubins_ar"


@pytest.mark.parametrize("mode", B1_MODES)
def test_b1_plain_matches_jax_kernel(mode, one_thread):
    check_b1(NAME, mode, K_RAGGED if mode == "costs+lr" else K)


@pytest.mark.parametrize("kind", B3_KINDS)
def test_b3_plain_matches_jax_kernel(kind, one_thread):
    check_b3(NAME, kind, K_RAGGED if kind == "nln" else K)


@pytest.mark.parametrize("kind", B4_KINDS)
def test_b4_plain_matches_jax_kernel(kind, one_thread):
    check_b4(NAME, kind, K_RAGGED if kind == "nln" else K)
