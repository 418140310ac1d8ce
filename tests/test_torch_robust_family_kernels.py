"""The robust family's kernel entries beyond the double integrator's circle
cost, on the CPU: the plain versions of the port's RMPPI kernel (B8) and
per-sample-x0 rollout (B1) against the JAX package's Pallas kernels in
interpret mode, on the same inputs.

* B8 for AutoRally's network dynamics with ``ARStandardCost`` and
  ``ARRobustCost`` on a 32^2 map with a hot block ahead of the car, so that
  part of the samples crash (the configuration of
  ``test_torch_autorally_kernels.py``: ``bench.py:704-717`` cut to K=256,
  T=16, the network at scale 1). Tolerances: costs rtol 2e-5 / atol 2e-4
  (the JAX kernel's map products and network matmul sum in other orders, as
  ``tests/test_windowed_maps.py:260``), U_real rtol 1e-5 / atol 1e-5 (the
  feedback multiplies the two systems' state difference, which carries the
  network's last-bit differences), crash flags exactly.
* B8 and B1-x0 for the double integrator with ``DoubleIntegratorRobustCost``
  (the JAX suite's RMPPI cost), states near the annulus' edge so that both
  of the cost's branches run: rtol 1e-5 / atol 1e-5, U_real atol 1e-6,
  crash flags exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import ARRobustCost as JARRobust
from mppi_generic_tpu.costs import ARStandardCost as JARStandard
from mppi_generic_tpu.costs.double_integrator import DoubleIntegratorRobustCost as JRobustDI
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_autorally import jax_cost_params
from test_torch_autorally_kernels import X0 as AR_X0
from test_torch_autorally_kernels import _jax_map, _setup

K, T, DT, LAM, ALPHA = 256, 16, 0.02, 1.3, 0.1
DI_CONSTRAINTS = dict(control_ranges=[[-2.5, 2.5], [-2.0, 2.0]],
                      control_deadband=[0.05, 0.1])


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(t, j, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


def _feedback_inputs(S, C, seed, u_scale, sigma_row):
    rng = np.random.default_rng(seed)
    U = (u_scale * rng.normal(size=(K, T, C))).astype(np.float32)
    gains = (-0.5 * rng.uniform(size=(T, C, S))).astype(np.float32)
    sigma = (np.asarray(sigma_row, np.float32)
             * rng.uniform(0.8, 1.2, size=(T, C))).astype(np.float32)
    coeff = np.array([0.5, 1.0], np.float32)
    return U, gains, sigma, coeff


def _both(jdyn, jcost, dyn, cost, x_nom, x_real, U, gains, sigma, coeff):
    jout = pallas_rollout.fused_rmppi_rollout(
        jdyn, jcost, jnp.asarray(x_nom), jnp.asarray(x_real), jnp.asarray(U),
        jnp.asarray(gains), jnp.asarray(sigma), jnp.asarray(coeff), jnp.float32(DT),
        LAM, ALPHA, interpret=True)
    fr.reset_launch_counts()
    tout = fr.fused_rmppi_rollout(dyn, cost, _t(x_nom), _t(x_real), _t(U), _t(gains),
                                  _t(sigma), _t(coeff), DT, LAM, ALPHA)
    assert fr.launch_counts["rmppi_rollout_kernel"] == 0  # CPU: no launch
    return tout, [np.asarray(a) for a in jout]


@pytest.mark.parametrize("robust", [False, True], ids=["standard", "robust"])
def test_rmppi_rollout_autorally_matches_pallas(robust):
    (jdyn, _, _), (dyn, _, _) = _setup("32")
    jcost = (JARRobust if robust else JARStandard)(costmap=_jax_map("32"))
    cost = convert.ar_cost_from_params(jax_cost_params(jcost), robust=robust)
    x_real = AR_X0 + np.array([0.05, -0.04, 0.03, 0.0, 0.2, 0.05, 0.02], np.float32)
    U, gains, sigma, coeff = _feedback_inputs(7, 2, 5 + robust, 0.5, [0.3, 0.5])
    tout, jout = _both(jdyn, jcost, dyn, cost, AR_X0, x_real, U, gains, sigma, coeff)
    for name, t, j in zip(("s_nom", "j_real", "s_fb"), tout[:3], jout[:3]):
        _close(t, j, 2e-5, 2e-4, name)
    np.testing.assert_array_equal(tout[3].numpy(), jout[3])
    assert 0 < int(jout[3].sum()) < K  # some samples crash, some do not
    _close(tout[4], jout[4], 1e-5, 1e-5, "U_real")


def _di_robust_pair(jcost_kw=None):
    jdyn, jcost = JDI.create(**DI_CONSTRAINTS), JRobustDI(**(jcost_kw or {}))
    dyn = convert.double_integrator_from_params(
        {n: np.asarray(getattr(jdyn, n)) for n in ("control_ranges", "control_deadband",
                                                   "zero_control", "system_noise")})
    cost = convert.circle_cost_from_params(
        {n: np.asarray(getattr(jcost, n)) for n in DoubleIntegratorCircleCost.PARAM_NAMES},
        robust=True)
    return jdyn, jcost, dyn, cost


@pytest.mark.parametrize("K_", [256, 200])
def test_rmppi_rollout_di_robust_matches_pallas(K_):
    """Ragged K=200 pads the TPU kernel's 128-sample tile."""
    jdyn, jcost, dyn, cost = _di_robust_pair()
    x_nom = np.array([2.05, 0.0, 0.0, 1.9], np.float32)
    x_real = np.array([2.12, -0.05, 0.1, 1.8], np.float32)
    U, gains, sigma, coeff = _feedback_inputs(4, 2, K_, 1.2, [1.0, 1.0])
    U = U[:K_]
    tout, jout = _both(jdyn, jcost, dyn, cost, x_nom, x_real, U, gains, sigma, coeff)
    for name, t, j in zip(("s_nom", "j_real", "s_fb"), tout[:3], jout[:3]):
        _close(t, j, 1e-5, 1e-5, name)
    np.testing.assert_array_equal(tout[3].numpy(), jout[3])
    _close(tout[4], jout[4], 1e-5, 1e-6, "U_real")
    # the barrier and the off-track penalty both ran: some means reach it
    assert float(tout[0].max()) > float(cost.crash_cost) / T


def test_rollout_per_sample_x0_di_robust_matches_pallas():
    """RMPPI's stage 1 on the robust cost: 9 candidates x 16 samples, the
    candidates spread across the annulus' edge."""
    jdyn, jcost, dyn, cost = _di_robust_pair(dict(discount=jnp.float32(0.95)))
    n, s_per = 9, 16
    rng = np.random.default_rng(9)
    w = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
    a, b = np.array([1.9, 0.0, 0.0, 2.0], np.float32), np.array([2.3, 0.2, 0.3, 1.6])
    x0 = np.repeat((1 - w) * a + w * b, s_per, axis=0).astype(np.float32)
    U = rng.normal(size=(n * s_per, T, 2)).astype(np.float32)
    jc, jcrash = pallas_rollout.fused_rollout_costs(jdyn, jcost, jnp.asarray(x0),
                                                    jnp.asarray(U), DT)
    tc, tcrash = fr.fused_rollout_costs(dyn, cost, _t(x0), _t(U), DT)
    _close(tc, jc, 1e-5, 1e-5, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    assert float(tc.max()) > float(cost.crash_cost) / T > float(tc.min())
    assert fr._entry(dyn, cost, "rollout_x0") == ("rollout_x0",
                                                  "rollout_costs_x0_di_robust")
