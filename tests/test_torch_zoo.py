"""The analytic model zoo in the port against the JAX package, on the CPU:
the cartpole, quadrotor and Dubins models (step and state derivative), the
cartpole, quadratic and quadrotor costs (running and terminal, with the crash
flags), the quadrotor map cost's waypoint updates, the pose forms of the map
query, the math helpers the zoo calls (angles, quaternions, RK4, linear
interpolation), ``slide_scale`` and ``init_state(initial_mean=)``. The JAX
objects are built first; the port's from their parameters (``convert``).
Inputs come from numpy seeds. Tolerance rtol 1e-5 / atol 1e-6 (1e-6 / 1e-7
where the arithmetic is exact, no transcendental) unless a case states
another.

The ``jax_*`` helpers and ``zoo_pair`` here carry a JAX object's parameters
across; ``test_torch_zoo_kernels.py`` uses them too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.controllers import VanillaMPPI as JVanilla
from mppi_generic_tpu.costs import QuadraticCost as JQuadratic
from mppi_generic_tpu.costs import QuadrotorMapCost as JQMap
from mppi_generic_tpu.costs import QuadrotorQuadraticCost as JQQuad
from mppi_generic_tpu.costs.cartpole import CartpoleQuadraticCost as JCartCost
from mppi_generic_tpu.maps.texture import MapTexture2D as JTex
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.models import QuadrotorDynamics as JQuad
from mppi_generic_tpu.models.cartpole import CartpoleDynamics as JCart
from mppi_generic_tpu.models.dubins import DubinsDynamics as JDubins
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import SmoothMPPIDistribution as JSmooth
from mppi_generic_tpu.utils import math_utils as jmath
from mppi_generic_tpu_torch import VanillaMPPI, convert
from mppi_generic_tpu_torch.costs import QuadrotorMapCost, QuadrotorQuadraticCost
from mppi_generic_tpu_torch.maps import MapTexture2D
from mppi_generic_tpu_torch.sampling import SmoothMPPIDistribution
from mppi_generic_tpu_torch.utils import math_utils
from test_torch_autorally import jax_texture_params

RTOL, ATOL = 1e-5, 1e-6
EXACT = (1e-6, 1e-7)
CONSTRAINTS = ("control_ranges", "control_deadband", "zero_control")
ZOO_PAIRS = ("cartpole", "quadrotor_quadratic", "quadrotor_map", "dubins_quadratic",
             "dubins_trajectory", "di_quadratic")


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def jax_fields(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def jax_model_params(dyn):
    names = {JCart: ("cart_mass", "pole_mass", "pole_length"),
             JQuad: ("mass", "tau_roll", "tau_pitch", "tau_yaw"),
             JDI: ("system_noise",)}.get(type(dyn), ())
    return jax_fields(dyn, CONSTRAINTS + names)


def jax_cost_params(cost):
    if isinstance(cost, JCartCost):
        return jax_fields(cost, ("coeffs", "desired_state", "terminal_cost_coeff"))
    if isinstance(cost, JQuadratic):
        p = jax_fields(cost, ("goal", "coeffs", "terminal_scale", "current_time"))
        return {**p, "OUTPUT_DIM": cost.OUTPUT_DIM}
    if isinstance(cost, JQQuad):
        return jax_fields(cost, ("s_goal",) + QuadrotorQuadraticCost.PARAM_NAMES)
    p = jax_fields(cost, QuadrotorMapCost.PARAM_NAMES)
    p["costmap"] = None if cost.costmap is None else jax_texture_params(cost.costmap)
    return p


DYN_KIND = {JCart: "cartpole", JQuad: "quadrotor", JDubins: "dubins",
            JDI: "double_integrator"}
COST_KIND = {JCartCost: "cartpole", JQuadratic: "quadratic",
             JQQuad: "quadrotor_quadratic", JQMap: "quadrotor_map"}


def port_of(jdyn, jcost, device="cpu"):
    return (convert.DYNAMICS[DYN_KIND[type(jdyn)]](jax_model_params(jdyn), device=device),
            convert.COSTS[COST_KIND[type(jcost)]](jax_cost_params(jcost), device=device))


def gate_map():
    """A 64^2 map of 0.1 m texels over [-3.2, 3.2]^2: a low random floor and
    a high block (crash) ahead and to the right of the first gate."""
    data = (0.2 * np.abs(np.random.default_rng(1).normal(size=(64, 64)))).astype(np.float32)
    data[40:, 40:] = 3.0
    return JTex.create(data, origin=(-3.2, -3.2, 0.0), resolution=0.1)


def zoo_pair(name):
    """(JAX dynamics, JAX cost, x0, std, mean offset of the last channel) of
    one zoo pair at the configurations the bench and examples use."""
    if name == "cartpole":
        return (JCart.create(control_ranges=[[-5.0, 5.0]]),
                JCartCost(coeffs=jnp.array([100.0, 10.0, 200.0, 20.0]),
                          terminal_cost_coeff=jnp.float32(0.5)),
                np.array([0.1, 0.0, 0.3, 0.0], np.float32), [5.0], 0.0)
    if name.startswith("quadrotor"):
        dyn = JQuad.create(control_ranges=[[-3.0, 3.0]] * 3 + [[0.0, 20.0]])
        x0 = np.zeros(13, np.float32)
        x0[6], x0[0], x0[1] = 1.0, 0.8, -0.3
        if name == "quadrotor_quadratic":
            cost = JQQuad(x_coeff=jnp.float32(50.0), v_coeff=jnp.float32(5.0),
                          terminal_cost_coeff=jnp.float32(0.3))
        else:
            cost = JQMap(costmap=gate_map(), dist_to_waypoint_coeff=jnp.float32(12.0),
                         desired_speed=jnp.float32(1.0), heading_power=jnp.float32(1.5)
                         ).update_waypoint(1.5, 0.0, 0.0, np.float32(np.pi / 2))
        return dyn, cost, x0, [0.5, 0.5, 0.5, 2.0], 9.81
    if name.startswith("dubins"):
        goal = ([1.0, 2.0, 0.5] if name == "dubins_quadratic" else
                np.random.default_rng(3).normal(size=(30, 3)).astype(np.float32))
        cost = JQuadratic.create(goal, coeffs=[1.0, 2.0, 0.3], terminal_scale=2.0)
        cost = cost.replace(current_time=jnp.int32(3))
        return JDubins.create(), cost, np.array([0.0, 0.0, 3.0], np.float32), [1.0, 1.0], 0.0
    return (JDI.create(),
            JQuadratic.create(goal=[-4.0, -4.0, 0.0, 0.0], coeffs=[5.0, 5.0, 0.5, 0.5],
                              output_dim=4),
            np.array([-9.0, -9.0, 0.1, 0.1], np.float32), [0.5, 0.5], 0.0)


def _states(S, K, seed, quat=False, scale=1.0):
    x = (scale * np.random.default_rng(seed).normal(size=(S, K))).astype(np.float32)
    if quat:
        x[6:10] /= np.linalg.norm(x[6:10], axis=0)
    return x


# --- math_utils ------------------------------------------------------------
def _q(seed, n=16):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


MATH_CASES = {
    "angle_diff": lambda m, a: m.angle_diff(a(_states(1, 32, 1, scale=4)[0]),
                                            a(_states(1, 32, 2, scale=4)[0])),
    "interp_angle": lambda m, a: m.interp_angle(a(_states(1, 32, 3, scale=4)[0]),
                                                a(_states(1, 32, 4, scale=4)[0]), 0.3),
    "quat_multiply": lambda m, a: m.quat_multiply(a(_q(1)), a(_q(2))),
    "quat_conjugate": lambda m, a: m.quat_conjugate(a(_q(3))),
    "quat_inverse": lambda m, a: m.quat_inverse(a(2 * _q(4))),
    "quat_normalize": lambda m, a: m.quat_normalize(a(3 * _q(5) * np.sign(_q(9)[:, :1]))),
    "quat_to_rotation_matrix": lambda m, a: m.quat_to_rotation_matrix(a(_q(6))),
    "quat_rotate": lambda m, a: m.quat_rotate(a(_q(7)), a(_states(3, 16, 8).T)),
    "quat_derivative": lambda m, a: m.quat_derivative(a(_q(9)), a(_states(3, 16, 10).T)),
    "quat_slerp": lambda m, a: m.quat_slerp(a(_q(11)), a(_q(12)), 0.35),
    "euler_to_quat": lambda m, a: m.euler_to_quat(*(a(r) for r in _states(3, 16, 13))),
    "quat_to_euler": lambda m, a: m.quat_to_euler(a(_q(14))),
    "rk4_step": lambda m, a: m.rk4_step(lambda x, u, k: -k * x + u, a(_states(4, 8, 15)),
                                        a(_states(4, 8, 16)), 0.05, 0.7),
    "linear_interp": lambda m, a: m.linear_interp(
        a(np.float32([0.25, 2.0, -1.0])), a(np.float32([0.0, 0.0, 0.0])),
        a(np.float32([1.0, 2.0, 3.0])), a(np.float32([1.0, 1.0, 0.0])),
        a(np.float32([5.0, 6.0, 7.0]))),
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_math_helpers_match_jax(name):
    want = MATH_CASES[name](jmath, jnp.asarray)
    got = MATH_CASES[name](math_utils, torch.from_numpy)
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        _close(g, w, what=name)


# --- models ----------------------------------------------------------------
MODELS = {
    "cartpole": lambda: JCart.create(cart_mass=1.3, pole_mass=0.7, pole_length=0.9),
    "quadrotor": lambda: JQuad.create(mass=1.2, tau_roll=0.2, tau_pitch=0.3, tau_yaw=0.4),
    "dubins": lambda: JDubins.create(control_ranges=[[-2.0, 2.0], [-1.0, 1.0]]),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    jdyn = MODELS[name]()
    dyn = convert.DYNAMICS[DYN_KIND[type(jdyn)]](jax_model_params(jdyn))
    S, Cm = jdyn.STATE_DIM, jdyn.CONTROL_DIM
    x = _states(S, 64, 1, quat=name == "quadrotor", scale=2.0)
    u = _states(Cm, 64, 2, scale=3.0)
    jx, jy = jdyn.step(jnp.asarray(x), jnp.asarray(u), 0.0, 0.02)
    tx, ty = dyn.step(torch.from_numpy(x), torch.from_numpy(u), 0.0, 0.02)
    _close(tx, jx, what="step state")
    _close(ty, jy, what="step output")
    _close(dyn.state_deriv(torch.from_numpy(x), torch.from_numpy(u)),
           jdyn.state_deriv(jnp.asarray(x), jnp.asarray(u)), what="state_deriv")
    kx, _ = dyn.kernel_step(torch.from_numpy(x), torch.from_numpy(u), 0.0, 0.02)
    assert torch.equal(kx, tx)  # the kernels' order is the eager one here
    _close(dyn.enforce_constraints(None, torch.from_numpy(u)),
           jdyn.enforce_constraints(None, jnp.asarray(u)), *EXACT, what="clamp")


def test_quadrotor_hover_and_quaternion_norm():
    """The JAX package's own checks (tests/test_model_zoo.py:27-45) on the
    port's model: thrust m g holds the hover, and the quaternion stays unit
    with q_w >= 0 while spinning."""
    dyn = convert.quadrotor_from_params(jax_model_params(JQuad.create()))
    x = dyn.get_zero_state()
    u = torch.tensor([0.0, 0.0, 0.0, 9.81])
    _close(dyn.state_deriv(x, u), np.zeros(13), atol=1e-5)
    x[10] = 2.0
    jx = jnp.asarray(x.numpy())
    for _ in range(20):
        x, _ = dyn.step(x, u, 0.0, 0.05)
        jx, _ = JQuad.create().step(jx, jnp.asarray(u.numpy()), 0.0, 0.05)
    assert abs(float(torch.linalg.vector_norm(x[6:10])) - 1.0) < 1e-5 and float(x[6]) >= 0
    _close(x, jx, what="spinning quadrotor")


def test_dubins_interpolate_state_matches_jax():
    jdyn = JDubins.create()
    dyn = convert.dubins_from_params(jax_model_params(jdyn))
    x1, x2 = _states(3, 1, 1, scale=3.0)[:, 0], _states(3, 1, 2, scale=3.0)[:, 0]
    _close(dyn.interpolate_state(torch.from_numpy(x1), torch.from_numpy(x2), 0.3),
           jdyn.interpolate_state(jnp.asarray(x1), jnp.asarray(x2), 0.3))


# --- costs -----------------------------------------------------------------
def _outputs(name, K=256, seed=5):
    """Outputs where each term of the pair's cost is exercised: for the
    quadrotor map cost, positions across the gate's side-post bands, on and
    off the map."""
    jdyn = zoo_pair(name)[0]
    y = _states(jdyn.OUTPUT_DIM, K, seed, quat=name.startswith("quadrotor"), scale=1.5)
    if name == "quadrotor_map":
        rng = np.random.default_rng(seed + 1)
        y[0] = rng.uniform(1.3, 1.7, K)
        y[1] = rng.uniform(-5.0, 5.0, K)
    return y


@pytest.mark.parametrize("name", ZOO_PAIRS)
def test_cost_matches_jax(name):
    jdyn, jcost, *_ = zoo_pair(name)
    _, cost = port_of(jdyn, jcost)
    y = _outputs(name)
    crash0 = (np.arange(y.shape[1]) % 7 == 0).astype(np.int32)
    for t in (0, 5, 40):
        jc, jcrash = jcost.state_cost(jnp.asarray(y), t, jnp.asarray(crash0))
        tc, tcrash = cost.running_cost(torch.from_numpy(y), torch.zeros(1), t,
                                       torch.from_numpy(crash0))
        _close(tc, jc, what=f"running cost t={t}")
        np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    _close(cost.terminal_cost(torch.from_numpy(y)), jcost.terminal_cost(jnp.asarray(y)),
           what="terminal cost")
    if name == "quadrotor_map":
        hit = np.asarray(jcrash) & ~crash0.astype(bool)
        assert 0 < int(hit.sum()) < y.shape[1]  # the gate band sets crash flags


def test_quadrotor_map_cost_updates_match_jax():
    jcost = JQMap(costmap=gate_map())
    cost = port_of(JQuad.create(), jcost)[1]
    steps = [(1.5, 0.0, 0.0, np.pi / 2), (1.5, 0.0, 0.0, np.pi / 2), (3.0, 0.8, 0.2, 1.2)]
    for wp in steps:
        jcost = jcost.update_waypoint(*(np.float32(v) for v in wp))
        cost = cost.update_waypoint(*wp)
        for f in ("curr_waypoint", "prev_waypoint", "curr_gate_left", "curr_gate_right",
                  "prev_gate_left", "prev_gate_right"):
            _close(getattr(cost, f), getattr(jcost, f), what=f)
    left, right = np.float32([4.0, 2.0, 0.5]), np.float32([2.0, 1.0, 0.5])
    jcost, cost = (jcost.update_gate_boundaries(left, right),
                   cost.update_gate_boundaries(left, right))
    for f in ("curr_gate_left", "curr_gate_right", "prev_gate_left", "prev_gate_right"):
        _close(getattr(cost, f), getattr(jcost, f), *EXACT, what=f)
    assert cost.costmap is not None and cost.params.shape[0] == 59


# --- the pose forms of the map query ---------------------------------------
def _pose_texture():
    data = np.random.default_rng(7).normal(size=(48, 40)).astype(np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    jtex = JTex.create(data, origin=(-1.0, -2.0, 0.5), rotation=rot,
                       resolution=(0.1, 0.12, 1.0))
    return jtex, convert.texture_from_params(jax_texture_params(jtex))


POSE_FORMS = {
    "world_to_map": lambda m, w: m.world_to_map(w),
    "map_to_tex": lambda m, w: m.map_to_tex(w),
    "world_to_tex": lambda m, w: m.world_to_tex(w),
    "query_at_map_pose": lambda m, w: m.query_at_map_pose(w),
    "query_at_world_pose": lambda m, w: m.query_at_world_pose(w),
}


@pytest.mark.parametrize("form", sorted(POSE_FORMS) + ["query_at_world_offset_pose"])
def test_map_pose_forms_match_jax(form):
    jtex, tex = _pose_texture()
    w = np.random.default_rng(8).uniform(-1.5, 3.0, size=(64, 3)).astype(np.float32)
    if form == "query_at_world_offset_pose":
        off = np.float32([0.3, -0.2, 0.1])
        rpy = np.float32([0.1, -0.2, 0.7])
        want = jtex.query_at_world_offset_pose(jnp.asarray(w), jnp.asarray(off),
                                               jnp.asarray(rpy))
        got = tex.query_at_world_offset_pose(torch.from_numpy(w), torch.from_numpy(off),
                                             torch.from_numpy(rpy))
    else:
        want = POSE_FORMS[form](jtex, jnp.asarray(w))
        got = POSE_FORMS[form](tex, torch.from_numpy(w))
    for g, j in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(g, j, 1e-5, 1e-5, what=form)


# --- controller services ---------------------------------------------------
def _cartpole_controllers(slide_scale):
    jdyn, jcost, *_ = zoo_pair("cartpole")
    jsamp = JGaussian.create(std_dev=[5.0], control_cost_coeff=[1.0])
    kw = dict(dt=0.01, lam=0.25, alpha=0.0, num_timesteps=20, num_rollouts=64)
    jc = JVanilla(dynamics=jdyn, cost=jcost, sampler=jsamp, slide_scale=slide_scale,
                  **{k: (jnp.float32(v) if isinstance(v, float) else v)
                     for k, v in kw.items()})
    dyn, cost = port_of(jdyn, jcost)
    tc = VanillaMPPI(dyn, cost, convert.gaussian_from_params(jax_fields(
        jsamp, ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                "std_dev_decay"))), device="cpu",
        slide_scale=None if slide_scale is None else np.asarray(slide_scale), **kw)
    return jc, tc


@pytest.mark.parametrize("slide_scale", [None, [1.0], [0.5]])
@pytest.mark.parametrize("stride", [1, 3])
def test_slide_scale_matches_jax(slide_scale, stride):
    jc, tc = _cartpole_controllers(None if slide_scale is None else jnp.asarray(slide_scale))
    mean = _states(20, 1, 21, scale=2.0)
    js = jc.init_state(jax.random.PRNGKey(0), initial_mean=jnp.asarray(mean))
    ts = tc.init_state(seed=0, initial_mean=mean)
    js = jc.slide_control_sequence(js, stride)
    ts = tc.slide_control_sequence(ts, stride)
    _close(ts.control_mean, js.control_mean, *EXACT, what="slid mean")
    _close(ts.control_history, js.control_history, *EXACT, what="history")


def test_smooth_sampler_shift_takes_slide_scale():
    j = JSmooth.create(std_dev=[1.0, 1.0], num_timesteps=12, dt=0.05)
    t = SmoothMPPIDistribution.create(std_dev=[1.0, 1.0], num_timesteps=12, dt=0.05)
    mean, dmean = _states(12, 2, 31), _states(12, 2, 32)
    scale = np.float32([0.5, 0.9])
    jm, jd = j.shift(jnp.asarray(mean), 2, jnp.asarray(scale), jnp.asarray(dmean))
    tm, td = t.shift(torch.from_numpy(mean), 2, torch.from_numpy(scale),
                     torch.from_numpy(dmean))
    _close(tm, jm, *EXACT)
    _close(td, jd, *EXACT)


def test_init_state_initial_mean_matches_jax():
    jdyn, jcost, *_ = zoo_pair("quadrotor_quadratic")
    jsamp = JGaussian.create(std_dev=[0.5, 0.5, 0.5, 2.0], control_cost_coeff=[0.0] * 4)
    hover = np.tile(np.float32([0.0, 0.0, 0.0, 9.81]), (48, 1))
    jc = JVanilla(dynamics=jdyn, cost=jcost, sampler=jsamp, num_timesteps=48,
                  num_rollouts=64)
    dyn, cost = port_of(jdyn, jcost)
    tc = VanillaMPPI(dyn, cost, convert.gaussian_from_params(jax_fields(
        jsamp, ("std_dev", "control_cost_coeff", "pure_noise_percentage",
                "std_dev_decay"))), num_timesteps=48, num_rollouts=64, device="cpu")
    js = jc.init_state(jax.random.PRNGKey(0), initial_mean=jnp.asarray(hover))
    ts = tc.init_state(seed=0, initial_mean=torch.from_numpy(hover))
    _close(ts.control_mean, js.control_mean, 0, 0)
    _close(ts.control_history, js.control_history, 0, 0)
    assert ts.control_mean.data_ptr() != 0 and tc.init_state().control_mean.abs().sum() == 0
