"""CCM feedback, on the CPU: the port's ``feedback/ccm.py`` against the JAX
package's on the same states. The Chebyshev points, weights and polynomials;
the metric; the contraction law ``u_feedback`` on the double integrator,
with the state pairs where it acts and where it returns zero; ``k`` through
``compute_feedback``'s state; and a closed loop of 100 steps under the law.
Tolerances: rtol 1e-5 / atol 1e-6 for one evaluation (a 4 x 4 inverse and
a few products in another order), rtol 1e-4 / atol 1e-5 after 100 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.feedback import CCMFeedback as JCCM
from mppi_generic_tpu.feedback import chebyshev_points as jpoints
from mppi_generic_tpu.feedback import chebyshev_polynomial as jpoly
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu_torch.feedback import (
    CCMFeedback,
    chebyshev_points,
    chebyshev_polynomial,
)
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics

DT = 0.02


def _close(t, j, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("n", [5, 9, 17])
def test_chebyshev_points_and_polynomials_match_jax(n):
    tp, tw = chebyshev_points(n)
    jp, jw = jpoints(n)
    _close(tp, jp, msg="points")
    _close(tw, jw, msg="weights")
    _close(chebyshev_polynomial(tp, 6), jpoly(jp, 6), msg="polynomials")
    assert abs(float(tw.sum()) - 1.0) < 1e-5


def _pairs():
    return JCCM.create(JDI.create()), CCMFeedback.create(DoubleIntegratorDynamics.create())


def test_metric_and_energy_match_jax():
    jfb, tfb = _pairs()
    x = np.array([0.3, -0.2, 1.0, 0.5], np.float32)
    dx = np.array([0.1, 0.2, -0.3, 0.05], np.float32)
    _close(tfb.metric(torch.from_numpy(x)), jfb.metric(jnp.asarray(x)), msg="metric")
    _close(tfb.energy(torch.from_numpy(dx), torch.from_numpy(x)),
           jfb.energy(jnp.asarray(dx), jnp.asarray(x)), msg="energy")


@pytest.mark.parametrize("seed", range(6))
def test_u_feedback_matches_jax(seed):
    """Random state pairs and nominal controls: both branches of the law
    (the zero where rhs > 0, the projection otherwise) across the seeds."""
    rng = np.random.default_rng(seed)
    jfb, tfb = _pairs()
    x_nom = rng.normal(size=4).astype(np.float32)
    x_act = (x_nom + 0.5 * rng.normal(size=4)).astype(np.float32)
    u_nom = rng.normal(size=2).astype(np.float32)
    ju = jfb.u_feedback(jnp.asarray(x_act), jnp.asarray(x_nom), jnp.asarray(u_nom))
    tu = tfb.u_feedback(torch.from_numpy(x_act), torch.from_numpy(x_nom),
                        torch.from_numpy(u_nom))
    _close(tu, ju, msg="u_feedback")


def test_zero_feedback_at_nominal_and_the_k_interface():
    jfb, tfb = _pairs()
    x = torch.tensor([1.0, 2.0, 0.5, -0.5])
    assert not tfb.u_feedback(x, x, torch.zeros(2)).any()
    T = 16
    goal = np.zeros((T, 4), np.float32)
    goal[:, 2] = 1.0
    ctrls = (0.3 * np.random.default_rng(1).normal(size=(T, 2))).astype(np.float32)
    jst = jfb.compute_feedback(jnp.asarray(goal[0]), jnp.asarray(goal), jnp.asarray(ctrls))
    tst = tfb.compute_feedback(torch.from_numpy(goal[0]), torch.from_numpy(goal),
                               torch.from_numpy(ctrls))
    xa = np.array([0.1, 0.0, 1.0, 0.0], np.float32)
    for t in (0, 3, T - 1, T + 4):  # k clips t to the horizon
        _close(tfb.k(torch.from_numpy(xa), tst[0][min(t, T - 1)], t, tst),
               jfb.k(jnp.asarray(xa), jst[0][min(t, T - 1)], t, jst), msg=f"k at {t}")
    fb0 = tfb.init_feedback_state(T)
    assert fb0[0].shape == (T, 4) and fb0[1].shape == (T, 2)


def test_ccm_closed_loop_matches_jax_and_contracts():
    """The tracking error under the law against JAX's over 100 steps of the
    DI coasting nominal; it shrinks against the open loop's."""
    jfb, tfb = _pairs()
    jdyn, tdyn = jfb.dynamics, tfb.dynamics
    x_nom = np.array([0.0, 0.0, 1.0, 0.0], np.float32)
    x = x_nom + np.array([0.4, -0.3, 0.2, 0.1], np.float32)
    jx, jn = jnp.asarray(x), jnp.asarray(x_nom)
    tx, tn, t_open = torch.from_numpy(x), torch.from_numpy(x_nom), torch.from_numpy(x)
    u0 = np.zeros(2, np.float32)
    for _ in range(100):
        jx = jdyn.step(jx, jfb.u_feedback(jx, jn, jnp.asarray(u0)), 0.0, DT)[0]
        jn = jdyn.step(jn, jnp.asarray(u0), 0.0, DT)[0]
        tx = tdyn.step(tx, tfb.u_feedback(tx, tn, torch.from_numpy(u0)), 0.0, DT)[0]
        t_open = tdyn.step(t_open, torch.from_numpy(u0), 0.0, DT)[0]
        tn = tdyn.step(tn, torch.from_numpy(u0), 0.0, DT)[0]
    _close(tx, jx, 1e-4, 1e-5, "closed-loop state")
    assert float((tx - tn).norm()) < 0.5 * float((t_open - tn).norm())
