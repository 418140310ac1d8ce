"""Parity of the port's models, costs and math utilities with the JAX
package: the same numpy inputs through both, float32, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.models.base import rollout_single as j_rollout_single
from mppi_generic_tpu.utils import math_utils as jmu
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.models.base import rollout_single
from mppi_generic_tpu_torch.utils import math_utils as tmu

RTOL = ATOL = 1e-6
N = 257

DYN_FIELDS = ("control_ranges", "control_deadband", "zero_control",
              "system_noise")


def _params(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def _close(torch_out, jax_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               rtol=rtol, atol=atol)


def _constrained_pair():
    jdyn = JDI.create(control_ranges=[[-0.9, 0.7], [-0.5, 0.8]],
                      control_deadband=[0.1, 0.05], zero_control=[0.02, -0.01])
    return jdyn, convert.double_integrator_from_params(_params(jdyn, DYN_FIELDS))


def test_di_step_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, N)).astype(np.float32)
    u = rng.normal(size=(2, N)).astype(np.float32)
    jx, jy = JDI.create().step(jnp.asarray(x), jnp.asarray(u), 3.0, 0.02)
    tx, ty = DoubleIntegratorDynamics.create().step(
        torch.from_numpy(x), torch.from_numpy(u), 3.0, 0.02)
    _close(tx, jx)
    _close(ty, jy)


@pytest.mark.parametrize("scale", [0.05, 2.0])
def test_enforce_constraints_matches_jax(scale):
    rng = np.random.default_rng(1)
    u = (scale * rng.normal(size=(2, N))).astype(np.float32)
    u[:, :3] = 0.0  # sign(0) = +1 inside the deadband
    jdyn, tdyn = _constrained_pair()
    _close(tdyn.enforce_constraints(None, torch.from_numpy(u)),
           jdyn.enforce_constraints(None, jnp.asarray(u)))


def test_default_ranges_pass_controls_through():
    u = torch.from_numpy(
        np.random.default_rng(2).normal(size=(2, N)).astype(np.float32) * 50)
    assert torch.equal(DoubleIntegratorDynamics.create().enforce_constraints(None, u), u)


@pytest.mark.parametrize("discount", [1.0, 0.9])
def test_circle_cost_matches_jax(discount):
    rng = np.random.default_rng(3)
    y = np.concatenate([rng.uniform(-2.5, 2.5, size=(2, N)),
                        rng.normal(scale=2.0, size=(2, N))]).astype(np.float32)
    u = rng.normal(size=(2, N)).astype(np.float32)
    jcost = JCircle(discount=jnp.float32(discount))
    tcost = convert.circle_cost_from_params(
        _params(jcost, DoubleIntegratorCircleCost.PARAM_NAMES))
    for t in (0, 7):
        jc, jcrash = jcost.running_cost(jnp.asarray(y), jnp.asarray(u), t,
                                        jnp.int32(0))
        tc, tcrash = tcost.running_cost(torch.from_numpy(y),
                                        torch.from_numpy(u), t,
                                        torch.zeros(N, dtype=torch.int32))
        _close(tc, jc, rtol=1e-6, atol=1e-4)  # crash_cost 1000 scales atol
        assert np.array_equal(np.broadcast_to(np.asarray(jcrash), (N,)),
                              np.broadcast_to(tcrash.numpy(), (N,)))
    _close(tcost.terminal_cost(torch.from_numpy(y)),
           jcost.terminal_cost(jnp.asarray(y)))


def test_cost_params_round_trip():
    jcost = JCircle(velocity_cost=jnp.float32(1.5), crash_cost=jnp.float32(10.0))
    tcost = convert.circle_cost_from_params(
        _params(jcost, DoubleIntegratorCircleCost.PARAM_NAMES))
    for name in DoubleIntegratorCircleCost.PARAM_NAMES:
        assert float(getattr(tcost, name)) == float(getattr(jcost, name))


def test_rollout_single_matches_jax():
    rng = np.random.default_rng(4)
    U = rng.normal(size=(30, 2)).astype(np.float32)
    x0 = np.array([2.0, 0.0, 0.0, 1.0], np.float32)
    jdyn, tdyn = _constrained_pair()
    js, jy = j_rollout_single(jdyn, jnp.asarray(x0), jnp.asarray(U), 0.02)
    ts, ty = rollout_single(tdyn, torch.from_numpy(x0), torch.from_numpy(U), 0.02)
    _close(ts, js, rtol=1e-5, atol=1e-6)
    _close(ty, jy, rtol=1e-5, atol=1e-6)


def test_sign_and_discount_pow_match_jax():
    x = np.array([-2.0, -0.0, 0.0, 1e-30, 3.0], np.float32)
    _close(tmu.sign(torch.from_numpy(x)), jmu.sign(jnp.asarray(x)))
    for base in (1.0, 0.95):
        for t in (0, 1, 17, 99):
            got = tmu.discount_pow(torch.tensor(base), t)
            want = jmu.discount_pow(jnp.float32(base), t)
            _close(got, want)
    assert float(tmu.discount_pow(torch.tensor(1.0), 99)) == 1.0


@pytest.mark.parametrize("with_history", [True, False])
def test_savitzky_golay_matches_jax(with_history):
    rng = np.random.default_rng(5)
    u = rng.normal(size=(24, 2)).astype(np.float32)
    h = rng.normal(size=(2, 2)).astype(np.float32) if with_history else None
    got = tmu.savitzky_golay_smooth(
        torch.from_numpy(u), None if h is None else torch.from_numpy(h))
    want = jmu.savitzky_golay_smooth(
        jnp.asarray(u), None if h is None else jnp.asarray(h))
    _close(got, want)


@pytest.mark.parametrize("stride", [0, 1, 2, 3, 40])
def test_history_and_slide_match_jax(stride):
    rng = np.random.default_rng(6)
    u = rng.normal(size=(24, 2)).astype(np.float32)
    h = rng.normal(size=(2, 2)).astype(np.float32)
    _close(tmu.update_control_history(torch.from_numpy(h), torch.from_numpy(u), stride),
           jmu.update_control_history(jnp.asarray(h), jnp.asarray(u), stride))
    scale = np.array([0.5, 0.9], np.float32)
    for sc in (None, scale):
        got = tmu.slide_control_sequence(
            torch.from_numpy(u), stride, None if sc is None else torch.from_numpy(sc))
        want = jmu.slide_control_sequence(
            jnp.asarray(u), stride, None if sc is None else jnp.asarray(sc))
        _close(got, want)
