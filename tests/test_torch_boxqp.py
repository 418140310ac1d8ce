"""BoxQP and DDP with BoxQP, on the CPU: the port's ``feedback/boxqp.py``
against the JAX package's ``feedback/boxqp.py`` on the same problems, and
``DDPFeedback(use_boxqp=True)`` against the JAX feedback with BoxQP (which
takes its XLA scan, never the ladder kernel), with bounds that bind.

Tolerances: the QP solutions and gains rtol 1e-5 / atol 1e-6 (the same
masked solves; LAPACK's and XLA's 2 x 2 solves agree to about an ulp), the
free sets exactly; DDP's gains and trajectories rtol 1e-4 / atol 1e-5 (its
backward scan multiplies small matrices in another order than XLA's, as the
port's eager scan does in test_torch_riccati.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.feedback import boxqp as jboxqp
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu_torch.feedback import DDPFeedback, boxqp, boxqp_gains
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics

DT, T = 0.05, 24
RANGES = [[-0.4, 0.4], [-0.3, 0.3]]


def _close(t, j, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


def _qp(seed, n):
    """An SPD H, a gradient g and bounds around 0 that the unconstrained
    minimum -H^-1 g leaves on some dimensions."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    H = (a @ a.T + n * np.eye(n)).astype(np.float32)
    g = (3.0 * rng.normal(size=n)).astype(np.float32)
    lb = -rng.uniform(0.1, 0.5, size=n).astype(np.float32)
    ub = rng.uniform(0.1, 0.5, size=n).astype(np.float32)
    return H, g, lb, ub


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boxqp_matches_jax(n, seed):
    H, g, lb, ub = _qp(10 * n + seed, n)
    jx, jfree = jboxqp.boxqp(*(jnp.asarray(a) for a in (H, g, lb, ub)))
    tx, tfree = boxqp(*(torch.from_numpy(a) for a in (H, g, lb, ub)))
    _close(tx, jx, 1e-5, 1e-6, "x")
    np.testing.assert_array_equal(tfree.numpy(), np.asarray(jfree))
    Qux = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    jK = jboxqp.boxqp_gains(jnp.asarray(H), jnp.asarray(Qux), jfree)
    tK = boxqp_gains(torch.from_numpy(H), torch.from_numpy(Qux), tfree)
    _close(tK, jK, 1e-5, 1e-6, "gains")
    assert torch.all(tK[~tfree] == 0)


def test_boxqp_active_bounds_and_warm_start():
    """A problem whose minimum lies outside the box on every dimension: all
    bounds active, every gain row zero; and a warm start outside the box."""
    H = np.diag([2.0, 3.0]).astype(np.float32)
    g = np.array([5.0, -6.0], np.float32)
    lb, ub = np.array([-1.0, -1.0], np.float32), np.array([1.0, 1.0], np.float32)
    x0 = np.array([3.0, -3.0], np.float32)
    jx, jfree = jboxqp.boxqp(*(jnp.asarray(a) for a in (H, g, lb, ub)), x0=jnp.asarray(x0))
    tx, tfree = boxqp(*(torch.from_numpy(a) for a in (H, g, lb, ub)),
                      x0=torch.from_numpy(x0))
    _close(tx, jx, 0, 0, "x")
    assert tx.tolist() == [-1.0, 1.0] and not bool(tfree.any())
    np.testing.assert_array_equal(tfree.numpy(), np.asarray(jfree))
    assert not boxqp_gains(torch.from_numpy(H), torch.ones((2, 4)), tfree).any()


def test_ddp_with_boxqp_matches_jax():
    """Two iLQR iterations with BoxQP on the DI tracking a target the
    control bounds cannot reach in time, so that bounds bind along the
    horizon."""
    rng = np.random.default_rng(5)
    x0 = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
    goal = np.zeros((T, 4), np.float32)
    goal[:, 0], goal[:, 1] = 1.5, -1.0
    u_init = (0.1 * rng.normal(size=(T, 2))).astype(np.float32)
    Q = np.diag([5.0, 5.0, 0.1, 0.1]).astype(np.float32)
    jfb = JDDP.create(JDI.create(control_ranges=RANGES), DT, Q=Q, R=0.01 * np.eye(2),
                      Q_f=Q, num_iterations=2, use_boxqp=True)
    jst = jfb.compute_feedback(jnp.asarray(x0), jnp.asarray(goal), jnp.asarray(u_init))
    tfb = DDPFeedback.create(DoubleIntegratorDynamics.create(control_ranges=RANGES), DT,
                             Q=Q, R=0.01 * np.eye(2), Q_f=Q, num_iterations=2,
                             use_boxqp=True)
    tst = tfb.compute_feedback(torch.from_numpy(x0), torch.from_numpy(goal),
                               torch.from_numpy(u_init))
    _close(tst.gains, jst.gains, 1e-4, 1e-5, "gains")
    _close(tst.u_traj, jst.u_traj, 1e-4, 1e-5, "u_traj")
    _close(tst.x_traj, jst.x_traj, 1e-4, 1e-5, "x_traj")
    _close(tst.total_cost, jst.total_cost, 1e-4, 0.0, "total_cost")
    u = tst.u_traj.abs()
    assert bool((u[:, 0] == 0.4).any() or (u[:, 1] == 0.3).any())  # a bound binds
    # a clamped control's gain row is zero somewhere along the horizon
    assert bool((tst.gains.abs().sum(-1) == 0).any())
