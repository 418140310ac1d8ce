"""Parity of the port's DDP feedback with the JAX package: the unrolled
Gauss solve, the backward Riccati recursion and the line-search ladder (the
plain versions of the port's CUDA kernels, which the wrappers run for CPU
tensors) against the JAX package's Pallas kernels in interpret mode, and
``ilqr_tracking`` / ``DDPFeedback`` against the JAX package's.

Tolerances: rtol 1e-5 where both sides run the TPU kernel's unrolled
operation order (the kernel in interpret mode and the plain versions);
rtol 1e-4 against the JAX XLA scan, whose matrix products and LU solve sum
and pivot in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.feedback import ilqr as j_ilqr
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops import pallas_riccati
from mppi_generic_tpu_torch.feedback import DDPFeedback, ilqr_tracking
from mppi_generic_tpu_torch.feedback.ilqr import _alpha_ladder
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.ops import riccati

T, S, C, DT = 16, 4, 2, 0.02
RANGES = {"unbounded": None, "bounded": [[-1.5, 1.5], [-1.0, 1.0]]}


def _close(t, j, rtol, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=msg)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _problem(seed, S=S, C=C, T=T):
    """A random backward-pass problem: near-identity A, small B."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        As=f32(np.eye(S) + 0.05 * rng.normal(size=(T, S, S))),
        Bs=f32(0.1 * rng.normal(size=(T, S, C))),
        dLx=f32(rng.normal(size=(T, S))),
        dLu=f32(rng.normal(size=(T, C))),
        Q=f32(np.eye(S)), R=f32(0.5 * np.eye(C)),
        Vxx_T=f32(2 * np.eye(S)), Vx_T=f32(rng.normal(size=(S,))),
    )


@pytest.mark.parametrize("C_", [1, 2, 3, 4])
def test_solve_gauss_matches_jax(C_):
    rng = np.random.default_rng(C_)
    a = rng.normal(size=(C_, C_))
    M = (a @ a.T + C_ * np.eye(C_)).astype(np.float32)
    rhs = rng.normal(size=(C_, 5)).astype(np.float32)
    jx = pallas_riccati._solve_gauss(
        [[jnp.float32(v) for v in row] for row in M],
        [[jnp.float32(v) for v in rhs[:, j]] for j in range(5)])
    want = np.array([[float(v) for v in col] for col in jx], np.float32).T
    got = riccati._solve_gauss(_t(M), _t(rhs)).numpy()
    _close(got, want, rtol=1e-6)
    _close(got, np.linalg.solve(M.astype(np.float64), rhs), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("S_,C_,T_", [(4, 2, 16), (6, 3, 12)])
def test_riccati_backward_plain_matches_pallas(S_, C_, T_):
    p = _problem(S_ * 10 + C_, S_, C_, T_)
    jK, jk = pallas_riccati.riccati_backward(
        *[jnp.asarray(p[n]) for n in ("As", "Bs", "dLx", "dLu", "Q", "R",
                                      "Vxx_T", "Vx_T")], DT, interpret=True)
    riccati.reset_launch_counts()
    tK, tk = riccati.riccati_backward(
        *[_t(p[n]) for n in ("As", "Bs", "dLx", "dLu", "Q", "R", "Vxx_T",
                             "Vx_T")], DT)
    _close(tK, jK, rtol=1e-5, atol=1e-6)
    _close(tk, jk, rtol=1e-5, atol=1e-6)
    assert not tK[-1].any() and not tk[-1].any()
    # CPU: no launch
    assert riccati.launch_counts["riccati_backward_kernel"] == 0
    assert riccati.launch_counts["riccati_backward_warp_kernel"] == 0


def _ladder_inputs(seed, ranges):
    """A DDP linearisation of the DI tracking problem, as ilqr_tracking
    forms it: xs rolled from u_init, tracking a noisy goal."""
    rng = np.random.default_rng(seed)
    jdyn = JDI.create(**({} if ranges is None else {"control_ranges": ranges}))
    x0 = np.array([2.0, 0.0, 0.0, 1.0], np.float32)
    goal_x = (x0 + 0.1 * rng.normal(size=(T, S))).astype(np.float32)
    u_init = (0.8 * rng.normal(size=(T, C))).astype(np.float32)
    Q = np.eye(S, dtype=np.float32)
    R = np.diag([0.5, 1.5]).astype(np.float32)
    Qf = (3 * np.eye(S)).astype(np.float32)
    lo = np.nan_to_num(np.asarray(jdyn.control_ranges[:, 0]), neginf=-1e30)
    hi = np.nan_to_num(np.asarray(jdyn.control_ranges[:, 1]), posinf=1e30)
    us = np.clip(u_init, lo, hi)
    xs = [x0]
    for t in range(T - 1):
        x = xs[-1]
        xs.append((x + np.array([x[2], x[3], us[t, 0], us[t, 1]], np.float32)
                   * np.float32(DT)).astype(np.float32))
    xs = np.stack(xs)
    A = np.eye(S, dtype=np.float32) + np.float32(DT) * np.array(
        [[0, 0, 1, 0], [0, 0, 0, 1], [0, 0, 0, 0], [0, 0, 0, 0]], np.float32)
    B = np.float32(DT) * np.array([[0, 0], [0, 0], [1, 0], [0, 1]], np.float32)
    return jdyn, dict(
        xs=xs, us=us, As=np.tile(A, (T, 1, 1)), Bs=np.tile(B, (T, 1, 1)),
        dLx=((xs - goal_x) @ Q.T).astype(np.float32),
        dLu=(us @ R.T).astype(np.float32), Q=Q, R=R, Q_f=Qf,
        Vxx_T=(0.5 * (Qf + Qf.T)).astype(np.float32),
        Vx_T=(Qf @ (xs[-1] - goal_x[-1])).astype(np.float32),
        goal_x=goal_x, goal_u=np.zeros((T, C), np.float32),
        alphas=np.power(0.5, np.arange(14, dtype=np.float32)),
        u_min=lo.astype(np.float32), u_max=hi.astype(np.float32))


_LADDER_ARGS = ("xs", "us", "As", "Bs", "dLx", "dLu", "Q", "R", "Q_f", "Vxx_T",
                "Vx_T", "goal_x", "goal_u", "alphas", "u_min", "u_max")


@pytest.mark.parametrize("ranges", sorted(RANGES))
def test_riccati_ladder_plain_matches_pallas(ranges):
    jdyn, p = _ladder_inputs(1, RANGES[ranges])
    jout = pallas_riccati.riccati_ladder_solve(
        jdyn, *[jnp.asarray(p[n]) for n in _LADDER_ARGS], jnp.float32(DT),
        interpret=True)
    dyn = DoubleIntegratorDynamics.create(
        **({} if RANGES[ranges] is None else {"control_ranges": RANGES[ranges]}))
    tout = riccati.riccati_ladder_solve(dyn, *[_t(p[n]) for n in _LADDER_ARGS], DT)
    for name, t, j in zip(("Ks", "ks", "costs", "xs_new", "us_new"), tout, jout):
        _close(t, j, rtol=1e-5, atol=1e-6, msg=name)


def test_riccati_wrappers_refuse_unsupported_sizes():
    assert riccati.supported(4, 2, 1024) and not riccati.supported(9, 2, 50)
    assert not riccati.supported(4, 5, 50) and not riccati.supported(4, 2, 1025)
    p = _problem(0, T=1025)
    with pytest.raises(ValueError, match="unsupported"):
        riccati.riccati_backward(*[_t(p[n]) for n in ("As", "Bs", "dLx", "dLu", "Q",
                                                      "R", "Vxx_T", "Vx_T")], DT)
    jdyn, q = _ladder_inputs(0, None)
    with pytest.raises(ValueError, match="alphas"):
        riccati.riccati_ladder_solve(
            DoubleIntegratorDynamics.create(),
            *[_t(q[n]) for n in _LADDER_ARGS[:13]], torch.ones(129),
            _t(q["u_min"]), _t(q["u_max"]), DT)
    # BoxQP takes the eager scan whatever use_kernel says, as in JAX
    # (ilqr.py:191): the ladder's sizes no longer refuse it
    dyn = DoubleIntegratorDynamics.create(control_ranges=[[-0.5, 0.5], [-0.5, 0.5]])
    x0, goal_x, u_init, Q, R, Qf = _tracking_problem(3)
    outs = [ilqr_tracking(dyn, _t(x0), _t(u_init), _t(goal_x), torch.zeros((T, C)),
                          _t(Q), _t(R), _t(Qf), DT, use_boxqp=True, use_kernel=k)
            for k in (True, False)]
    assert torch.equal(outs[0].gains, outs[1].gains)
    assert DDPFeedback.create(dyn, DT, use_boxqp=True).use_boxqp


@pytest.fixture
def fresh_jit_cache():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _tracking_problem(seed):
    rng = np.random.default_rng(seed)
    x0 = np.array([2.1, -0.1, 0.2, 0.9], np.float32)
    goal_x = (np.array([2.0, 0.0, 0.0, 1.0], np.float32)
              + 0.2 * rng.normal(size=(T, S))).astype(np.float32)
    u_init = (0.8 * rng.normal(size=(T, C))).astype(np.float32)
    Q, R = np.eye(S, dtype=np.float32), np.diag([0.5, 1.5]).astype(np.float32)
    return x0, goal_x, u_init, Q, R, (3 * np.eye(S)).astype(np.float32)


@pytest.mark.parametrize("path", ["ladder", "scan"])
@pytest.mark.parametrize("ranges", sorted(RANGES))
def test_ilqr_tracking_matches_jax(path, ranges, monkeypatch, fresh_jit_cache):
    """The port's ladder (use_kernel=True) against the JAX ladder kernel in
    interpret mode at 1e-5; the port's scan (use_kernel=False) against the
    JAX XLA scan at 1e-4."""
    monkeypatch.setattr(j_ilqr, "_LADDER_INTERPRET", path == "ladder")
    kw = {} if RANGES[ranges] is None else {"control_ranges": RANGES[ranges]}
    x0, goal_x, u_init, Q, R, Qf = _tracking_problem(len(ranges))
    jres = j_ilqr.ilqr_tracking(
        JDI.create(**kw), jnp.asarray(x0), jnp.asarray(u_init),
        jnp.asarray(goal_x), jnp.zeros((T, C)), jnp.asarray(Q), jnp.asarray(R),
        jnp.asarray(Qf), jnp.float32(DT))
    tres = ilqr_tracking(
        DoubleIntegratorDynamics.create(**kw), _t(x0), _t(u_init), _t(goal_x),
        torch.zeros((T, C)), _t(Q), _t(R), _t(Qf), DT,
        use_kernel=path == "ladder")
    rtol = 1e-5 if path == "ladder" else 1e-4
    for field in ("gains", "x_traj", "u_traj", "total_cost"):
        _close(getattr(tres, field), getattr(jres, field), rtol=rtol, atol=1e-5,
               msg=field)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ilqr_second_iteration_never_raises_the_cost(use_kernel):
    """Iterations after the first accept only an alpha whose cost does not
    exceed the previous one (else the smallest alpha). On the DI tracking
    problem one Newton step converges, so the ladder's costs tie and the
    choice among them is not compared across packages."""
    x0, goal_x, u_init, Q, R, Qf = _tracking_problem(3)
    args = (DoubleIntegratorDynamics.create(control_ranges=RANGES["bounded"]),
            _t(x0), _t(u_init), _t(goal_x), torch.zeros((T, C)), _t(Q), _t(R),
            _t(Qf), DT)
    one = ilqr_tracking(*args, iterations=1, use_kernel=use_kernel)
    two = ilqr_tracking(*args, iterations=2, use_kernel=use_kernel)
    assert float(two.total_cost) <= float(one.total_cost) * (1 + 1e-6)
    _close(two.gains, one.gains, rtol=1e-3, atol=1e-4)
    assert torch.isfinite(two.x_traj).all() and torch.isfinite(two.u_traj).all()


def test_ddp_feedback_law_matches_jax():
    rng = np.random.default_rng(5)
    gains = rng.normal(size=(T, C, S)).astype(np.float32)
    goal = rng.normal(size=(T, S)).astype(np.float32)
    x = rng.normal(size=(S,)).astype(np.float32)
    jfb = JDDP.create(JDI.create(), DT)
    tfb = DDPFeedback.create(DoubleIntegratorDynamics.create(), DT)
    jstate = jfb.init_feedback_state(T).replace(gains=jnp.asarray(gains))
    tstate = tfb.init_feedback_state(T)
    tstate.gains = _t(gains)
    for t in (0, 7, T - 1):
        _close(tfb.k(_t(x), _t(goal[t]), t, tstate),
               jfb.k(jnp.asarray(x), jnp.asarray(goal[t]), t, jstate), rtol=1e-6)
    for rel_time in (0.0, 0.013, 0.1, 5.0):
        _close(tfb.interpolate_feedback(_t(x), tstate, rel_time, DT, _t(goal)),
               jfb.interpolate_feedback(jnp.asarray(x), jstate, rel_time, DT,
                                        jnp.asarray(goal)), rtol=1e-5)
    assert torch.equal(_alpha_ladder(), _t(j_ilqr._alpha_ladder()))


def test_no_feedback_matches_jax():
    from mppi_generic_tpu.feedback import NoFeedback as JNoFeedback
    from mppi_generic_tpu_torch.feedback import NoFeedback

    jfb, tfb = JNoFeedback(CONTROL_DIM=C, STATE_DIM=S), NoFeedback(C, S)
    goal = np.ones((T, S), np.float32)
    _close(tfb.compute_feedback(_t(goal[0]), _t(goal), torch.zeros((T, C))),
           jfb.compute_feedback(jnp.asarray(goal[0]), jnp.asarray(goal),
                                jnp.zeros((T, C))), rtol=0, atol=0)
    _close(tfb.k(_t(goal[0]), _t(goal[1]), 3, None),
           jfb.k(jnp.asarray(goal[0]), jnp.asarray(goal[1]), 3, None), rtol=0, atol=0)
    assert tuple(tfb.init_feedback_state(T).shape) == (T, C, S)
