"""The DDP size choice and the per-robot factories of the port against the
JAX package, on the CPU.

* The quadrotor (S = 13) is outside the DDP kernels' sizes
  (``ops.riccati.supported``), so ``DDPFeedback(use_kernel=True)`` takes
  the eager scan, as the JAX package takes its XLA scan (ilqr.py:191-197);
  the gains, trajectories and cost agree at rtol 1e-4 / atol 1e-5 (matrix
  products and LU solves in another order), and the ladder is never called.
* The DDP linearisation of the cartpole and the quadrotor (the models
  that multiply by a Python float) stays float32, and its Jacobians equal
  ``jax.jacfwd``'s of the JAX models at rtol 1e-6 / atol 1e-7 (the chain
  rule's products in another order).
* Each factory of ``instantiations`` against JAX's: its scales, sampler,
  constraints, cost parameters and feedback, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu import instantiations as jinst
from mppi_generic_tpu.feedback import DDPFeedback as JDDP
from mppi_generic_tpu.models import CartpoleDynamics as JCartpole
from mppi_generic_tpu.models import QuadrotorDynamics as JQuadrotor
from mppi_generic_tpu_torch import DDPFeedback, convert, instantiations
from mppi_generic_tpu_torch.feedback.ilqr import linearize
from mppi_generic_tpu_torch.ops import riccati

DT = 0.02
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


# --- the DDP size choice -----------------------------------------------------
def test_ddp_takes_the_eager_scan_outside_the_kernel_sizes(monkeypatch, fresh_jit_cache):
    """The quadrotor (S = 13) with ``use_kernel=True``: the JAX package
    takes its XLA scan there (ilqr.py:191-197), and so does the port."""
    def no_ladder(*args, **kwargs):
        raise AssertionError("the ladder kernel was chosen at S = 13")

    monkeypatch.setattr(riccati, "riccati_ladder_solve", no_ladder)
    jdyn = JQuadrotor.create()
    dyn = convert.quadrotor_from_params(
        {n: np.asarray(getattr(jdyn, n))
         for n in CONSTRAINTS + ("mass", "tau_roll", "tau_pitch", "tau_yaw")})
    S, C, T_ = 13, 4, 12
    assert not riccati.supported(S, C, T_)
    rng = np.random.default_rng(7)
    hover = np.zeros((S,), np.float32)
    hover[6] = 1.0  # unit quaternion
    x0 = (hover + 0.05 * rng.normal(size=S)).astype(np.float32)
    goal = np.tile(hover, (T_, 1)).astype(np.float32)
    u_init = (np.array([0.0, 0.0, 0.0, 9.81]) + 0.3 * rng.normal(size=(T_, C))
              ).astype(np.float32)
    jres = JDDP.create(jdyn, DT).compute_feedback(jnp.asarray(x0), jnp.asarray(goal),
                                                  jnp.asarray(u_init))
    fb = DDPFeedback.create(dyn, DT)
    assert fb.use_kernel
    tres = fb.compute_feedback(_t(x0), _t(goal), _t(u_init))
    for field in ("gains", "x_traj", "u_traj", "total_cost"):
        _close(getattr(tres, field), getattr(jres, field), 1e-4, 1e-5, field)
    assert float(tres.gains.abs().max()) > 1e-2


@pytest.mark.parametrize("model", ["cartpole", "quadrotor"])
def test_linearize_keeps_float32(model, fresh_jit_cache):
    """A = I + df/dx dt and B = df/du dt along a trajectory: float32, as
    JAX's, and equal to jax.jacfwd of the JAX model's state_deriv."""
    if model == "cartpole":
        jdyn = JCartpole.create()
        dyn = convert.cartpole_from_params(
            {n: np.asarray(getattr(jdyn, n))
             for n in CONSTRAINTS + ("cart_mass", "pole_mass", "pole_length")})
    else:
        jdyn = JQuadrotor.create()
        dyn = convert.quadrotor_from_params(
            {n: np.asarray(getattr(jdyn, n))
             for n in CONSTRAINTS + ("mass", "tau_roll", "tau_pitch", "tau_yaw")})
    S, C, T_ = dyn.STATE_DIM, dyn.CONTROL_DIM, 9
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(T_, S)).astype(np.float32)
    us = rng.normal(size=(T_, C)).astype(np.float32)
    eye_s, eye_c = torch.eye(S), torch.eye(C)
    As, Bs = linearize(dyn, _t(xs), _t(us), _t(xs), _t(us), eye_s, eye_c, eye_s, DT)[:2]
    assert As.dtype == Bs.dtype == torch.float32
    assert As.is_contiguous() and Bs.is_contiguous()
    jA = jax.vmap(jax.jacfwd(jdyn.state_deriv, argnums=0))(jnp.asarray(xs), jnp.asarray(us))
    jB = jax.vmap(jax.jacfwd(jdyn.state_deriv, argnums=1))(jnp.asarray(xs), jnp.asarray(us))
    assert jA.dtype == jnp.float32
    _close(As, np.eye(S, dtype=np.float32) + np.asarray(jA) * np.float32(DT), 1e-6, 1e-7, "A")
    _close(Bs, np.asarray(jB) * np.float32(DT), 1e-6, 1e-7, "B")


# --- the per-robot factories -------------------------------------------------
FACTORIES = ("autorally_mppi", "cartpole_mppi", "double_integrator_mppi",
             "quadrotor_mppi", "quadrotor_waypoint_mppi", "racer_lstm_mppi")


def _cost_fields(cost):
    names = list(getattr(type(cost), "PARAM_NAMES", ()))
    if hasattr(cost, "coeffs"):  # the cartpole cost
        names += ["coeffs", "desired_state", "terminal_cost_coeff"]
    if hasattr(cost, "s_goal"):
        names.append("s_goal")
    return names


@pytest.mark.parametrize("name", FACTORIES)
def test_instantiation_matches_jax(name):
    jc, jfb = getattr(jinst, name)()
    tc, tfb = getattr(instantiations, name)(device="cpu")
    for field in ("num_rollouts", "num_timesteps", "num_iters", "kernel"):
        assert getattr(tc, field) == getattr(jc, field), field
    for field in ("dt", "lam", "alpha"):
        assert np.float32(getattr(tc, field)) == np.float32(getattr(jc, field)), field
    assert type(tc.dynamics).__name__ == type(jc.dynamics).__name__
    assert type(tc.cost).__name__ == type(jc.cost).__name__
    for field in CONSTRAINTS:
        _close(getattr(tc.dynamics, field), getattr(jc.dynamics, field), 0, 0, field)
    for field in ("std_dev", "control_cost_coeff"):
        _close(getattr(tc.sampler, field), getattr(jc.sampler, field), 0, 0, field)
    fields = _cost_fields(tc.cost)
    assert fields
    for field in fields:
        _close(getattr(tc.cost, field), getattr(jc.cost, field), 0, 0, field)
    if name == "racer_lstm_mppi":  # the LSTMs: JAX draws them from a PRNG key
        assert tc.cost.output_indices == tuple(jc.cost.output_indices)
        for field in type(tc.dynamics).param_names():
            _close(getattr(tc.dynamics, field), getattr(jc.dynamics, field), 0, 0, field)
    elif name == "autorally_mppi":  # the zero network of the reference's shape
        assert tc.dynamics.nn.layers == (6, 32, 32, 4)
        for tw, jw in zip(tc.dynamics.nn.weights, jc.dynamics.nn.weights):
            _close(tw, jw, 0, 0, "network")
    for field in ("Q", "R", "Q_f"):
        _close(getattr(tfb, field), getattr(jfb, field), 0, 0, field)
    assert np.float32(tfb.dt) == np.float32(jfb.dt)
    assert tfb.num_iterations == jfb.num_iterations
    assert tfb.use_kernel == jfb.use_pallas and tfb.dynamics is tc.dynamics
