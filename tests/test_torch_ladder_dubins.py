"""The DDP ladder (B7) for the Dubins car, on the CPU: the port's plain
ladder against the JAX package's ``_ladder_call`` in interpret mode on the
same linearisation, and ``DDPFeedback`` on the ladder against the JAX
feedback with its ladder kernel.

The trap it pins: the TPU kernel steps x + state_deriv(x, u) dt and does not
wrap the yaw (pallas_riccati.py:263-264), though the Dubins model's own step
does (models/dubins.py:30-34). The tracked trajectory turns the car from a
yaw of 2.9 through pi, so the candidates' yaws pass pi unwrapped; a ladder
that wrapped them would be 2 pi off there. Tolerances: gains, feedforward
terms, candidate states and controls rtol 1e-5 / atol 1e-6, costs rtol 1e-5
(the same operations in the same order, transcendentals aside).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.feedback import ilqr as j_ilqr
from mppi_generic_tpu.models.dubins import DubinsDynamics as JDubins
from mppi_generic_tpu.ops import pallas_riccati
from mppi_generic_tpu_torch.feedback import DDPFeedback
from mppi_generic_tpu_torch.feedback.ilqr import _alpha_ladder, linearize
from mppi_generic_tpu_torch.models import DubinsDynamics
from mppi_generic_tpu_torch.ops import riccati

T, S, C, DT = 40, 3, 2, 0.05
RANGES = [[-2.0, 2.0], [-1.5, 1.5]]


def _close(t, j, rtol, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


def _problem(seed):
    """A tracking linearisation along a trajectory that turns through pi."""
    rng = np.random.default_rng(seed)
    dyn = DubinsDynamics.create(control_ranges=RANGES)
    us = torch.tensor(np.stack([1.0 + 0.2 * rng.normal(size=T),
                                1.2 + 0.1 * rng.normal(size=T)], 1).astype(np.float32))
    x = torch.tensor([0.0, 0.0, 2.9])
    xs = []
    for t in range(T):
        xs.append(x)
        x = x + dyn.state_deriv(x, us[t]) * DT
    xs = torch.stack(xs)
    goal_x = xs + torch.tensor(0.05 * rng.normal(size=(T, S)).astype(np.float32))
    goal_u = torch.zeros((T, C))
    fb = DDPFeedback.create(dyn, DT)
    lin = linearize(dyn, xs, us, goal_x, goal_u, fb.Q, fb.R, fb.Q_f, DT)
    lo, hi = dyn.control_ranges[:, 0].contiguous(), dyn.control_ranges[:, 1].contiguous()
    args = (xs, us, *lin[:4], fb.Q, fb.R, fb.Q_f, lin[4], lin[5], goal_x, goal_u,
            _alpha_ladder(), lo, hi)
    return dyn, args


def test_dubins_ladder_plain_matches_pallas():
    dyn, args = _problem(3)
    assert float(args[0][:, 2].max()) > np.pi  # the tracked yaw passes pi
    jout = pallas_riccati.riccati_ladder_solve(
        JDubins.create(control_ranges=RANGES), *[jnp.asarray(a.numpy()) for a in args],
        jnp.float32(DT), interpret=True)
    riccati.reset_launch_counts()
    tout = riccati.riccati_ladder_solve(dyn, *args, DT)
    assert riccati.launch_counts["riccati_ladder_warp_kernel"] == 0  # CPU: no launch
    for name, t, j in zip(("Ks", "ks", "costs", "xs_new", "us_new"), tout, jout):
        _close(t, j, 1e-5, 1e-6 if name != "costs" else 0.0, name)
    yaw = tout[3][..., 2]
    assert float(yaw.max()) > np.pi  # unwrapped, as the TPU kernel steps it
    assert riccati._LADDER_ENTRY[DubinsDynamics] == "riccati_ladder_dubins"


@pytest.fixture
def ladder_interpret(monkeypatch):
    monkeypatch.setattr(j_ilqr, "_LADDER_INTERPRET", True)
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_dubins_ddp_feedback_on_the_ladder_matches_jax(ladder_interpret):
    """Two iLQR iterations of DDPFeedback on the ladder, both packages."""
    dyn, args = _problem(4)
    xs, us, goal_x = args[0], args[1], args[11]
    jfb = JDDP.create(JDubins.create(control_ranges=RANGES), DT, num_iterations=2)
    jst = jfb.compute_feedback(jnp.asarray(xs[0].numpy()), jnp.asarray(goal_x.numpy()),
                               jnp.asarray(us.numpy()))
    tfb = DDPFeedback.create(dyn, DT, num_iterations=2)
    tst = tfb.compute_feedback(xs[0], goal_x, us)
    _close(tst.gains, jst.gains, 1e-4, 1e-5, "gains")
    _close(tst.x_traj, jst.x_traj, 1e-5, 1e-5, "x_traj")
    _close(tst.u_traj, jst.u_traj, 1e-5, 1e-5, "u_traj")
    _close(tst.total_cost, jst.total_cost, 1e-5, 0.0, "total_cost")
