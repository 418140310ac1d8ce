"""The robust family's entries of the later pairs, on the CPU: the plain
versions of the port's B1 from one x0 for the DI robust cost, B1 from one x0
per sample (RMPPI's stage 1), the split dynamics passes from one x0 and from
one x0 per sample, and B8 (RMPPI's stage 2), each against the JAX package's
Pallas kernel in interpret mode on the same inputs, and the entry each
(pair, kind) resolves to by name, with no card. B8 is in
``test_torch_robust_entries_b8.py``, the racer LSTMs' B1 from one x0 per
sample in ``test_torch_robust_entries_racer.py`` (both with this file's
helpers), so that each file runs in about half a minute.

The pairs are ``test_torch_sample_pairs.pair_parts``'s: the zoo's analytic
pairs (the cartpole, the quadrotor with its quadratic and its map cost, the
Dubins car and the DI with ``QuadraticCost``), the DI with its robust cost,
the bicycle with the AutoRally cost on its partly-crashing map, and the two
racer LSTM models. RMPPI's candidates are 9 states on a segment, 8 samples
each over T = 12 (the racers' 4 samples over T = 6: JAX's interpret-mode
LSTM kernels take seconds). Tolerances: the analytic pairs' costs rtol 2e-5
/ atol 1e-5 (the quadrotor map cost's atol 2e-4: its map products sum in
another order in XLA); the AutoRally cost's (bicycle) rtol 2e-5 / atol
2e-4; the racers' rtol / atol 1e-4 (their LSTM and head sums in other
orders through T steps, as test_torch_racer_kernels.py); crash flags
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.ops import _build
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_robust_family_kernels import DI_CONSTRAINTS
from test_torch_sample_pairs import pair_parts
from test_torch_split_pairs import check_split_b1, check_split_b3, rollout_inputs

DT, LAM, ALPHA = 0.02, 1.3, 0.1
N_CAND = 9
X0_SHAPE = {"racer_steering_ar": (4, 6), "racer_unc_ar": (4, 6)}  # (S_PER, T)
ANALYTIC = ("cartpole", "quadrotor_quadratic", "quadrotor_map", "dubins_quadratic",
            "di_quadratic")
RACERS = ("racer_steering_ar", "racer_unc_ar")
SPLIT_X0 = ("di_circle", "cartpole", "quadrotor_quadratic", "dubins_quadratic",
            "di_quadratic", "bicycle_ar")
TOL = {"quadrotor_map": (2e-5, 2e-4), "bicycle_ar": (2e-5, 2e-4),
       "racer_steering_ar": (1e-4, 1e-4), "racer_unc_ar": (1e-4, 1e-4)}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def _parts(name):
    """(JAX dynamics, JAX cost, port dynamics, port cost, x0) of a pair."""
    if name == "di_circle":
        jdyn, jcost = JDI.create(**DI_CONSTRAINTS), JCircle()
        dyn = convert.double_integrator_from_params(
            {n: np.asarray(getattr(jdyn, n)) for n in ("control_ranges", "control_deadband",
                                                       "zero_control", "system_noise")})
        cost = convert.circle_cost_from_params(
            {n: np.asarray(getattr(jcost, n)) for n in DoubleIntegratorCircleCost.PARAM_NAMES})
        return jdyn, jcost, dyn, cost, np.array([2.0, 0.0, 0.0, 1.0], np.float32)
    return pair_parts(name)[:5]


def _delta(name, S, scale):
    """A state offset of the pair's first (position and velocity) entries."""
    d = np.zeros(S, np.float32)
    n = min(S, 6)
    d[:n] = scale * np.linspace(1.0, -0.5, n, dtype=np.float32)
    return d


def _candidates(name):
    """RMPPI's stage-1 layout: N_CAND states on a segment from the pair's
    x0, s_per samples each, (N_CAND * s_per, S), and their controls."""
    jdyn, _, _, _, x0 = _parts(name)
    s_per, T = X0_SHAPE.get(name, (8, 12))
    w = np.linspace(0.0, 1.0, N_CAND, dtype=np.float32)[:, None]
    x_b = x0 + _delta(name, x0.shape[0], 0.3)
    X0 = np.repeat((1 - w) * x0 + w * x_b, s_per, axis=0).astype(np.float32)
    if name == "di_circle":
        rng = np.random.default_rng(13)
        U = rng.normal(size=(X0.shape[0], T, 2)).astype(np.float32)
    else:
        U, _ = rollout_inputs(name, X0.shape[0], T)
    return X0, U


@pytest.mark.parametrize("mode", ["costs+lr", "epilogue+lr", "tsallis+lr"])
def test_b1_di_robust_split_and_combined_match_jax(mode, one_thread):
    """B1 from one x0 on the DI robust cost: its split form (the new split
    dynamics pass with the pair's cost pass) against JAX's split kernel, and
    the combined plain version (``rollout_costs_di_robust``) against it."""
    check_split_b1("di_robust", mode)
    assert _build.pair_entry("di_robust", "rollout") == ("pair_di_robust",
                                                         "rollout_costs_di_robust")
    assert _build.pair_entry("di_robust", "split_dynamics") == ("split_di_robust",
                                                                "split_dynamics_di_robust")


def test_b3_di_robust_split_matches_jax(one_thread):
    check_split_b3("di_robust")
    assert _build.pair_entry("di_robust", "split_solve_dynamics")[0] == "split_di_robust"


def test_b1_di_robust_combined_matches_jax_kernel(one_thread):
    """The combined B1 from one x0 against JAX's combined kernel, costs + LR."""
    jdyn, jcost, dyn, cost, x0 = _parts("di_robust")
    U, lr = rollout_inputs("di_robust", 128, 16)
    jlr = tuple(jnp.asarray(a) for a in lr[:3]) + tuple(jnp.float32(v) for v in lr[3:])
    tlr = tuple(torch.from_numpy(a) for a in lr[:3]) + lr[3:]
    jc, jcrash = pallas_rollout.fused_rollout_costs(
        jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), DT, tile_k=128, lr_params=jlr,
        split_cost=False)
    tc, tcrash = fr.fused_rollout_costs(dyn, cost, torch.from_numpy(x0), torch.from_numpy(U),
                                        DT, lr_params=tlr, split_cost=False)
    _close(tc, jc, 2e-5, 1e-5, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))


@pytest.mark.parametrize("name", ANALYTIC)
def test_b1_x0_plain_matches_jax_kernel(name, one_thread):
    """B1 from one x0 per sample, combined."""
    check_b1_x0(name)


@pytest.mark.parametrize("name", SPLIT_X0)
def test_b1_x0_split_plain_matches_jax_split(name, one_thread):
    """B1's split form from one x0 per sample against JAX's split kernel in
    its per-sample-x0 mode, and against the port's combined plain version."""
    check_x0_split(name)


def check_b1_x0(name):
    """B1 from one x0 per sample, combined, against JAX's kernel."""
    jdyn, jcost, dyn, cost, _ = _parts(name)
    X0, U = _candidates(name)
    jc, jcrash = pallas_rollout.fused_rollout_costs(
        jdyn, jcost, jnp.asarray(X0), jnp.asarray(U), DT, split_cost=False)
    tc, tcrash = fr.fused_rollout_costs(dyn, cost, torch.from_numpy(X0), torch.from_numpy(U),
                                        DT, split_cost=False)
    rtol, atol = TOL.get(name, (2e-5, 1e-5))
    _close(tc, jc, rtol, atol, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    assert _build.pair_entry(name, "rollout_x0") == (f"robust_{name}",
                                                     f"rollout_costs_x0_{name}")


def check_x0_split(name):
    """B1's split form from one x0 per sample against JAX's split kernel,
    and against the port's combined plain version."""
    jdyn, jcost, dyn, cost, _ = _parts(name)
    X0, U = _candidates(name)
    jc, jcrash = pallas_rollout.fused_rollout_costs(
        jdyn, jcost, jnp.asarray(X0), jnp.asarray(U), DT, split_cost=True)
    tX0, tU = torch.from_numpy(X0), torch.from_numpy(U)
    tc, tcrash = fr.fused_rollout_costs(dyn, cost, tX0, tU, DT, split_cost=True)
    rtol, atol = TOL.get(name, (2e-5, 1e-5))
    _close(tc, jc, rtol, atol, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    cc, ccrash = fr.fused_rollout_costs(dyn, cost, tX0, tU, DT, split_cost=False)
    assert torch.equal(ccrash, tcrash)
    _close(tc, cc, rtol, atol, "split vs combined costs")
    lib, fn = fr._entry(dyn, cost, "split_dynamics_x0")
    assert fn == f"split_dynamics_x0_{name}"
    assert lib == ("split_di_circle" if name == "di_circle" else f"robust_{name}")


def test_entry_table_by_name():
    """Every (pair, kind) the JAX package runs in its kernels resolves to an
    entry declared in its library's signatures; the racers have no B8 (JAX
    refuses a recurrent model there) and the quadrotor map cost no split.
    The rest of the racer family has B1, B3 and B4 only: its robust and
    split entries are still to come (ROADMAP.md section 2 item 8)."""
    family = ("racer_dubins_ar", "racer_elevation_ar", "racer_suspension_ar",
              "bicycle_elevation_ar", "racer_elev_susp_ar")
    for pair, kinds in _build.PAIR_KERNELS.items():
        for kind in kinds:
            lib, fn = _build.pair_entry(pair, kind)
            assert fn in _build.SIGNATURES[lib], (pair, kind)
        if pair in family:
            assert kinds == ("rollout", "solve", "sample"), pair
            continue
        assert ("rollout_x0" in kinds) and (("rmppi" in kinds) == (pair not in RACERS))
    assert _build.pair_entry("quadrotor_map", "split_dynamics_x0") is None
    assert "riccati_ladder_dubins" in _build.SIGNATURES["riccati"]
