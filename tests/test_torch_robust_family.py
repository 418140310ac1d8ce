"""The robust family beyond the double integrator, on the CPU: the DDP
feedback's pieces for the models the port now runs it on, against the JAX
package.

* ``DoubleIntegratorRobustCost`` against JAX's (rtol 1e-6 / atol 1e-5: the
  same operations; the barrier reaches 1e3 off the track).
* The backward Riccati recursion's plain version at (S, C) = (4, 1) and
  (7, 2), the cartpole's and AutoRally's sizes, against the JAX kernel in
  interpret mode (rtol 1e-5 / atol 1e-6: the same unrolled order).
* The line-search ladder's plain version for AutoRally's network dynamics
  and the cartpole against the JAX kernel in interpret mode on the same
  linearisation, rtol 1e-5 / atol 1e-5: the JAX kernel steps the network
  with a matmul, the plain version sums left to right as the CUDA kernel
  does (over T = 16 steps the states differ by about 1e-6), and at S = 7
  the recursion's sums cancel to about 1e-6 of the gains' scale (about 1),
  where XLA's CPU code may round a multiply-add once.

The DDP size choice and the factories are in
``test_torch_instantiations.py``; the RMPPI kernel and the robust solves in
``test_torch_robust_family_kernels.py`` and
``test_torch_robust_family_solve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs.double_integrator import DoubleIntegratorRobustCost as JRobustDI
from mppi_generic_tpu.models import AutorallyNNDynamics as JAutorally
from mppi_generic_tpu.models import CartpoleDynamics as JCartpole
from mppi_generic_tpu.nn.fnn import FNN as JFNN
from mppi_generic_tpu.ops import pallas_riccati
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost, DoubleIntegratorRobustCost
from mppi_generic_tpu_torch.feedback.ilqr import _alpha_ladder, linearize
from mppi_generic_tpu_torch.ops import riccati
from test_torch_autorally import jax_dynamics_params
from test_torch_riccati import _LADDER_ARGS, _problem

DT, T = 0.02, 16
CONSTRAINTS = ("control_ranges", "control_deadband", "zero_control")


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(t, j, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.fixture
def fresh_jit_cache():
    jax.clear_caches()
    yield
    jax.clear_caches()


# --- the DI robust cost ----------------------------------------------------
@pytest.mark.parametrize("discount", [1.0, 0.9])
def test_di_robust_cost_matches_jax(discount):
    rng = np.random.default_rng(int(discount * 10))
    n = 400
    r = rng.uniform(1.5, 2.5, size=n)
    ang = rng.uniform(-np.pi, np.pi, size=n)
    y = np.stack([r * np.cos(ang), r * np.sin(ang), rng.normal(size=n),
                  rng.normal(size=n)]).astype(np.float32)
    jc = JRobustDI(discount=jnp.float32(discount))
    tc = convert.circle_cost_from_params(
        {name: np.asarray(getattr(jc, name))
         for name in DoubleIntegratorCircleCost.PARAM_NAMES}, robust=True)
    assert type(tc) is DoubleIntegratorRobustCost
    crash = np.zeros((n,), np.int32)
    for t in (0, 7, 23):
        jcost, jcrash = jc.running_cost(jnp.asarray(y), jnp.zeros((2, n)), t,
                                        jnp.asarray(crash))
        tcost, tcrash = tc.running_cost(_t(y), torch.zeros((2, n)), t,
                                        torch.from_numpy(crash))
        _close(tcost, jcost, 1e-6, 1e-5, f"t={t}")
        assert not tcrash.any() and not np.asarray(jcrash).any()
    d = (r * r - 0.5 * (1.875**2 + 2.125**2)) / (0.5 * (2.125**2 - 1.875**2))
    assert (np.abs(d) > 1).any() and (np.abs(d) < 1).any()  # both branches
    _close(tc.lipschitz_constant_cost(), jc.lipschitz_constant_cost(), 0, 0)
    _close(tc.terminal_cost(_t(y)), jc.terminal_cost(jnp.asarray(y)), 0, 0)


# --- B6 at the new sizes ----------------------------------------------------
@pytest.mark.parametrize("S_,C_", [(4, 1), (7, 2)])
def test_riccati_backward_new_sizes_match_pallas(S_, C_):
    p = _problem(S_ * 10 + C_, S_, C_, 24)
    names = ("As", "Bs", "dLx", "dLu", "Q", "R", "Vxx_T", "Vx_T")
    jK, jk = pallas_riccati.riccati_backward(*[jnp.asarray(p[n]) for n in names], DT,
                                             interpret=True)
    tK, tk = riccati.riccati_backward(*[_t(p[n]) for n in names], DT)
    _close(tK, jK, 1e-5, 1e-6, "Ks")
    _close(tk, jk, 1e-5, 1e-6, "ks")
    assert (S_, C_) in riccati._BACKWARD_ENTRY


# --- B7 with the model inside ------------------------------------------------
def _model_pair(kind):
    """(JAX dynamics, port dynamics, x0) with the same parameters: AutoRally's
    6-32-32-4 network at scale 1 (the bench's 0.1 barely reacts) or the
    cartpole with its control range."""
    if kind == "autorally":
        jdyn = JAutorally.create(
            nn=JFNN.create([6, 32, 32, 4], key=jax.random.PRNGKey(0), scale=1.0),
            control_ranges=[[-0.9, 0.9], [-0.6, 1.0]])
        return (jdyn, convert.autorally_from_params(jax_dynamics_params(jdyn)),
                np.array([0.0, 0.0, 0.2, 0.0, 3.0, 0.0, 0.0], np.float32))
    jdyn = JCartpole.create(control_ranges=[[-5.0, 5.0]])
    p = {n: np.asarray(getattr(jdyn, n))
         for n in CONSTRAINTS + ("cart_mass", "pole_mass", "pole_length")}
    return (jdyn, convert.cartpole_from_params(p),
            np.array([0.1, -0.2, 0.6, 0.3], np.float32))


def _ladder_problem(kind, seed=3):
    """The first iLQR iteration's ladder inputs, as ``ilqr_tracking`` forms
    them: xs rolled from a random u_init, a noisy goal, diagonal weights."""
    jdyn, dyn, x0 = _model_pair(kind)
    S, C = dyn.STATE_DIM, dyn.CONTROL_DIM
    rng = np.random.default_rng(seed)
    lo, hi = dyn.control_ranges[:, 0], dyn.control_ranges[:, 1]
    us = torch.clamp(_t(0.4 * rng.normal(size=(T, C))), lo, hi)
    xs = [_t(x0)]
    for t in range(T - 1):
        xs.append(xs[-1] + dyn.state_deriv(xs[-1], us[t]) * DT)
    xs = torch.stack(xs)
    goal_x = xs + _t(0.05 * rng.normal(size=(T, S)))
    goal_u = torch.zeros((T, C))
    Q = _t(np.diag(rng.uniform(0.5, 2.0, size=S)))
    R = _t(np.diag(rng.uniform(0.5, 2.0, size=C)))
    Qf = 3.0 * Q
    As, Bs, dLx, dLu, Vxx_T, Vx_T = linearize(dyn, xs, us, goal_x, goal_u, Q, R, Qf, DT)
    p = dict(xs=xs, us=us, As=As, Bs=Bs, dLx=dLx, dLu=dLu, Q=Q, R=R, Q_f=Qf,
             Vxx_T=Vxx_T, Vx_T=Vx_T, goal_x=goal_x, goal_u=goal_u,
             alphas=_alpha_ladder(), u_min=lo.contiguous(), u_max=hi.contiguous())
    return jdyn, dyn, p


@pytest.mark.parametrize("kind", ["autorally", "cartpole"])
def test_riccati_ladder_plain_matches_pallas_with_the_model(kind, fresh_jit_cache):
    jdyn, dyn, p = _ladder_problem(kind)
    jout = pallas_riccati.riccati_ladder_solve(
        jdyn, *[jnp.asarray(p[n].numpy()) for n in _LADDER_ARGS], jnp.float32(DT),
        interpret=True)
    tout = riccati.riccati_ladder_solve(dyn, *[p[n] for n in _LADDER_ARGS], DT)
    for name, t, j in zip(("Ks", "ks", "costs", "xs_new", "us_new"), tout, jout):
        _close(t, j, 1e-5, 1e-5, name)
    assert type(dyn) in riccati._LADDER_ENTRY
    # the line search moved the trajectory: the candidates differ
    assert float((tout[3][0] - tout[3][-1]).abs().max()) > 1e-4


def test_ladder_plain_steps_the_kernels_derivative():
    """The plain ladder steps AutoRally with ``kernel_state_deriv`` (the
    network summed left to right, as the CUDA kernel does), not the eager
    matmul: its states are x + kernel_state_deriv(x, u) dt exactly."""
    _, dyn, p = _ladder_problem("autorally")
    _, _, _, xs_new, us_new = riccati.riccati_ladder_solve(
        dyn, *[p[n] for n in _LADDER_ARGS], DT)
    x, u = xs_new[:, :-1].reshape(-1, 7).T, us_new[:, :-1].reshape(-1, 2).T
    want = (x + dyn.kernel_state_deriv(x, u) * np.float32(DT)).T.reshape(14, T - 1, 7)
    assert torch.equal(xs_new[:, 1:], want)
