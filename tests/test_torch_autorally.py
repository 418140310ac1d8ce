"""AutoRally's modules in the port against the JAX package, on the CPU:
the polynomial math, the FNN, the AutoRally step, the map texture and its
track-npz loader, and the AutoRally costs. The JAX objects are built
first; the port's are built from their parameters (``convert``). Tolerance
rtol 1e-5 / atol 1e-6 unless a case states another.

The ``jax_*_params`` helpers here carry a JAX object's parameters across
as numpy arrays; ``test_torch_autorally_kernels.py`` uses them too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import ARRobustCost as JRobust
from mppi_generic_tpu.costs import ARStandardCost as JStandard
from mppi_generic_tpu.maps.texture import MapTexture2D as JTex
from mppi_generic_tpu.maps.texture import load_track_npz as j_load_track
from mppi_generic_tpu.models import AutorallyNNDynamics as JAutorally
from mppi_generic_tpu.nn.fnn import FNN as JFNN
from mppi_generic_tpu.utils import math_utils as jmath
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.costs import ARStandardCost
from mppi_generic_tpu_torch.maps import MapTexture2D, load_track_npz
from mppi_generic_tpu_torch.models import AutorallyNNDynamics
from mppi_generic_tpu_torch.nn import FNN
from mppi_generic_tpu_torch.utils import math_utils

RTOL, ATOL = 1e-5, 1e-6


def jax_fnn_params(nn):
    return {"weights": [np.asarray(w) for w in nn.weights],
            "biases": [np.asarray(b) for b in nn.biases]}


def jax_dynamics_params(dyn):
    p = {n: np.asarray(getattr(dyn, n))
         for n in ("control_ranges", "control_deadband", "zero_control")}
    p["nn"] = jax_fnn_params(dyn.nn)
    return p


def jax_texture_params(tex):
    return {"data": np.asarray(tex.data), "origin": np.asarray(tex.origin),
            "rotation": np.asarray(tex.rotation),
            "resolution": np.asarray(tex.resolution),
            "channel_major": tex.channel_major}


def jax_cost_params(cost):
    p = {n: np.asarray(getattr(cost, n)) for n in ARStandardCost.PARAM_NAMES}
    p.update(l1_speed_cost=cost.l1_speed_cost, output_indices=cost.output_indices,
             costmap=None if cost.costmap is None else jax_texture_params(cost.costmap))
    return p


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


# --- math_utils ------------------------------------------------------------
ANGLES = np.array([0.0, -0.0, np.pi, -np.pi, np.float32(np.pi), -np.float32(np.pi),
                   3 * np.pi, -3 * np.pi, 1e-7, -1e-7, 2 * np.pi, 7.5, -7.5, 100.0,
                   -1234.5, 0.5 * np.pi], np.float32)
RATIOS = np.array([0.0, -0.0, 1.0, -1.0, 1.0000001, -0.9999999, 0.3, -0.7, 5.0,
                   -5.0, 1e6, -1e6, 1e-30, 0.99, -1.01], np.float32)


@pytest.mark.parametrize("name", ["normalize_angle", "atan_approx", "atan_full_approx",
                                  "asin_approx"])
def test_math_utils_match_jax(name):
    x = ANGLES if name == "normalize_angle" else RATIOS
    if name == "atan_approx":  # its domain is |z| <= 1
        x = x[np.abs(x) <= 1]
    got = getattr(math_utils, name)(torch.from_numpy(x))
    want = getattr(jmath, name)(jnp.asarray(x))
    _close(got, want, what=name)
    assert got.dtype == torch.float32


def test_atan2_approx_matches_jax_in_every_quadrant():
    y, x = np.meshgrid(RATIOS, RATIOS[::-1])
    got = math_utils.atan2_approx(torch.from_numpy(y), torch.from_numpy(x))
    _close(got, jmath.atan2_approx(jnp.asarray(y), jnp.asarray(x)))


def test_normalize_angle_lands_in_range():
    x = torch.linspace(-50.0, 50.0, 10001)
    w = math_utils.normalize_angle(x)
    assert bool((w >= -np.float32(np.pi)).all()) and bool((w < np.float32(np.pi)).all())


# --- FNN -------------------------------------------------------------------
def _jax_fnn(layers=(6, 32, 32, 4), seed=0):
    return JFNN.create(list(layers), key=jax.random.PRNGKey(seed))


@pytest.mark.parametrize("layers", [(6, 32, 32, 4), (3, 5, 2)])
def test_fnn_forward_matches_jax(layers):
    jnn = _jax_fnn(layers)
    tnn = convert.fnn_from_params(jax_fnn_params(jnn))
    x = np.random.default_rng(1).normal(size=(2, 9, layers[0])).astype(np.float32)
    _close(tnn.forward(torch.from_numpy(x)), jnn.forward(jnp.asarray(x)))
    xa = np.moveaxis(x, -1, 0).copy()  # (in, 2, 9)
    want = jnn.forward_axis0(jnp.asarray(xa))
    _close(tnn.forward_axis0(torch.from_numpy(xa)), want)
    _close(tnn.forward_axis0_plain(torch.from_numpy(xa)), want)
    assert tnn.layers == tuple(layers)


def test_fnn_from_npz_reads_the_reference_keys():
    rng = np.random.default_rng(2)
    npz = {"dynamics_W1": rng.normal(size=(8, 6)), "dynamics_b1": rng.normal(size=(8, 1)),
           "dynamics_W2": rng.normal(size=(4, 8)), "dynamics_b2": rng.normal(size=(4,)),
           "other": np.zeros(3)}
    jnn, tnn = JFNN.from_npz(npz), FNN.from_npz(npz)
    assert tnn.layers == (6, 8, 4)
    for tw, jw in zip(tnn.weights + tnn.biases, jnn.weights + jnn.biases):
        _close(tw, jw, rtol=0, atol=0)
    pre = {f"net/{k}": v for k, v in npz.items()}
    assert FNN.from_npz(pre, prefix="net").layers == (6, 8, 4)
    with pytest.raises(KeyError):
        FNN.from_npz({"nothing": np.zeros(1)})


# --- AutoRally dynamics ----------------------------------------------------
def _jax_autorally(**constraints):
    return JAutorally.create(key=jax.random.PRNGKey(0), **constraints)


def _batch(K=64, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(7, K)).astype(np.float32)
    x[2] = rng.uniform(-3.2, 3.2, size=K)  # yaw, some wrap in one step
    x[4] = 3.0 + x[4]
    x[6] = 100.0 * x[6]  # a large yaw rate, so the Euler step crosses pi
    u = rng.normal(scale=0.5, size=(2, K)).astype(np.float32)
    return x, u


def test_autorally_step_matches_jax():
    jdyn = _jax_autorally()
    tdyn = convert.autorally_from_params(jax_dynamics_params(jdyn))
    x, u = _batch()
    jx, jy = jdyn.step(jnp.asarray(x), jnp.asarray(u), 0.0, 0.02)
    for step in (tdyn.step, tdyn.kernel_step):
        tx, ty = step(torch.from_numpy(x), torch.from_numpy(u), 0.0, 0.02)
        _close(tx, jx)
        _close(ty, jy)
    unwrapped = x[2] - 0.02 * x[6]
    assert bool((np.abs(unwrapped) > np.pi).any())  # some yaw wrapped
    # one vector, as the re-rollout of the mean steps it
    tv, _ = tdyn.step(torch.from_numpy(x[:, 0]), torch.from_numpy(u[:, 0]), 0.0, 0.02)
    _close(tv, jx[:, 0])
    _close(tdyn.state_deriv(torch.from_numpy(x), torch.from_numpy(u)),
           jdyn.state_deriv(jnp.asarray(x), jnp.asarray(u)), rtol=1e-5, atol=1e-5)


def test_autorally_constraints_and_npz():
    ranges = [[-0.9, 0.9], [-0.5, 1.0]]
    jdyn = _jax_autorally(control_ranges=ranges, control_deadband=[0.05, 0.0])
    tdyn = convert.autorally_from_params(jax_dynamics_params(jdyn))
    u = np.random.default_rng(4).normal(size=(2, 50)).astype(np.float32)
    _close(tdyn.enforce_constraints(None, torch.from_numpy(u)),
           jdyn.enforce_constraints(None, jnp.asarray(u)), rtol=0, atol=0)
    npz = {"dynamics_W1": np.ones((32, 6)), "dynamics_b1": np.zeros(32),
           "dynamics_W2": np.ones((32, 32)), "dynamics_b2": np.zeros(32),
           "dynamics_W3": np.ones((4, 32)), "dynamics_b3": np.zeros(4)}
    assert AutorallyNNDynamics.from_npz(npz).nn.layers == (6, 32, 32, 4)
    with pytest.raises(ValueError, match="6-input"):
        AutorallyNNDynamics(FNN.create([5, 4]))
    with pytest.raises(NotImplementedError, match="compiled"):
        AutorallyNNDynamics(FNN.create([6, 8, 4])).kernel_params()


# --- map texture -----------------------------------------------------------
def _maps():
    rng = np.random.default_rng(5)
    rot = np.array([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]], np.float32)
    chw = rng.normal(size=(4, 1024, 1024)).astype(np.float32)
    return {
        "plain 48x40": JTex.create(rng.normal(size=(40, 48)).astype("f"),
                                   origin=(-5.0, -3.0, 0.2), resolution=0.25),
        "rotated trailing": JTex.create(rng.normal(size=(24, 16, 3)).astype("f"),
                                        origin=(-2.0, 1.0, 0.0), rotation=rot,
                                        resolution=[0.5, 0.25, 1.0]),
        "channel-major 1024": JTex.create(chw, origin=(-51.2, -51.2, 0.0),
                                          resolution=0.1, channel_major=True),
    }


def _tex_points(n=400, seed=6):
    """Normalized coordinates inside, on the edges and out of range."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.2, 1.2, size=n).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, size=n).astype(np.float32)
    edges = np.array([0.0, 1.0, -1e-3, 1.0 + 1e-3, 0.5, -5.0, 5.0], np.float32)
    eu, ev = np.meshgrid(edges, edges)
    return np.concatenate([u, eu.ravel()]), np.concatenate([v, ev.ravel()])


@pytest.mark.parametrize("name", ["plain 48x40", "rotated trailing", "channel-major 1024"])
def test_map_queries_match_jax(name):
    jtex = _maps()[name]
    ttex = convert.texture_from_params(jax_texture_params(jtex))
    assert (ttex.height, ttex.width, ttex.channels) == (jtex.height, jtex.width,
                                                        jtex.channels)
    u, v = _tex_points()
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    _close(ttex.query_tex(ut, vt), jtex.query_tex(jnp.asarray(u), jnp.asarray(v)))
    for ch in range(max(jtex.channels, 1)):
        _close(ttex.query_tex_channel(ut, vt, ch),
               jtex.query_tex_channel(jnp.asarray(u), jnp.asarray(v), ch))
    # the world pipeline, over the map and past its edges
    wx = np.random.default_rng(7).uniform(-60, 60, size=300).astype(np.float32)
    wy = np.random.default_rng(8).uniform(-60, 60, size=300).astype(np.float32)
    tu, tv = ttex.world_to_tex_components(torch.from_numpy(wx), torch.from_numpy(wy))
    ju, jv = jtex.world_to_tex_components(jnp.asarray(wx), jnp.asarray(wy))
    _close(tu, ju)
    _close(tv, jv)
    _close(ttex.query_world_components_channel(torch.from_numpy(wx),
                                               torch.from_numpy(wy), 0),
           jtex.query_world_components_channel(jnp.asarray(wx), jnp.asarray(wy), 0))
    _close(ttex.query_world_components(torch.from_numpy(wx), torch.from_numpy(wy)),
           jtex.query_world_components(jnp.asarray(wx), jnp.asarray(wy)))


def test_map_query_clamps_to_the_edge_texels():
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    tex = MapTexture2D(data)
    far = torch.tensor([-3.0, 7.0, float("inf"), float("-inf")])
    got = tex.query_tex(far, torch.tensor([-3.0, 7.0, 0.5, 0.5]))
    assert got.tolist() == [0.0, 11.0, 7.0, 4.0]  # corners, then row 1 ends
    # a texel centre reads the texel exactly
    assert float(tex.query_tex(torch.tensor([1.5 / 4]), torch.tensor([2.5 / 3]))) == 9.0
    with pytest.raises(ValueError, match="channel"):
        tex.query_tex_channel(far, far, 1)


def test_load_track_npz_matches_jax():
    rng = np.random.default_rng(9)
    x_b, y_b, ppm = np.array([-3.0, 5.0]), np.array([-2.0, 2.5]), np.array([4.0])
    H, W = int(4.5 * 4), int(8 * 4)
    d = {"xBounds": x_b, "yBounds": y_b, "pixelsPerMeter": ppm,
         **{f"channel{i}": rng.normal(size=H * W) for i in range(4)}}
    jtex, ttex = j_load_track(d), load_track_npz(d)
    assert ttex.channel_major and tuple(ttex.data.shape) == (4, H, W)
    _close(ttex.data, jtex.data, rtol=0, atol=0)
    _close(ttex.origin, jtex.origin, rtol=0, atol=0)
    _close(ttex.resolution, jtex.resolution, rtol=0, atol=0)
    wx = torch.tensor([-3.0, 0.0, 4.9, 6.0])
    wy = torch.tensor([-2.0, 0.3, 2.4, -9.0])
    _close(ttex.query_world_components_channel(wx, wy, 0),
           jtex.query_world_components_channel(jnp.asarray(wx.numpy()),
                                               jnp.asarray(wy.numpy()), 0))


# --- AutoRally costs -------------------------------------------------------
def _outputs(K=300, seed=10):
    """Outputs over the 48x40 map (x in [-5, 7], y in [-3, 7]), with slip,
    rollover, stopped and NaN samples."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(7, K)).astype(np.float32)
    y[0] = rng.uniform(-6, 8, size=K)
    y[1] = rng.uniform(-4, 8, size=K)
    y[2] = rng.uniform(-np.pi, np.pi, size=K)
    y[3] = rng.uniform(-2.0, 2.0, size=K)  # some roll past pi / 2
    y[4] = rng.uniform(-1.0, 8.0, size=K)
    y[4, :5] = [0.0, 1e-4, -1e-4, 0.001, -0.002]  # stopped / barely moving
    y[5] = rng.normal(scale=3.0, size=K)
    y[0, 5] = np.nan
    return y


COST_CASES = {
    "standard": (JStandard, dict()),
    "robust": (JRobust, dict()),
    "l1 slop discount": (JStandard, dict(l1_speed_cost=True, track_slop=jnp.float32(0.2),
                                         discount=jnp.float32(0.9))),
    "robust l1": (JRobust, dict(l1_speed_cost=True)),
    "no map": (JStandard, dict(costmap=None)),
    "output indices": (JStandard, dict(output_indices=(1, 0, 2, 3, 4, 5))),
    "channel-major map": (JStandard, dict(costmap="channel-major")),
}


@pytest.mark.parametrize("name", sorted(COST_CASES))
def test_ar_costs_match_jax(name):
    cls, kw = COST_CASES[name]
    maps = _maps()
    tex = maps["plain 48x40"]
    if kw.get("costmap") == "channel-major":
        chw = np.abs(np.asarray(maps["channel-major 1024"].data[:, :64, :64]))
        tex = JTex.create(chw, origin=(-3.2, -3.2, 0.0), resolution=0.1,
                          channel_major=True)
    kw = {"costmap": tex, **{k: v for k, v in kw.items() if k != "costmap"}}
    if "costmap" in COST_CASES[name][1] and COST_CASES[name][1]["costmap"] is None:
        kw["costmap"] = None
    jcost = cls(**kw)
    tcost = convert.COSTS["ar_robust" if cls is JRobust else "ar_standard"](
        jax_cost_params(jcost))
    y = _outputs()
    crash = np.zeros(y.shape[1], np.int32)
    crash[::7] = 1
    for t in (0, 5):
        jc, jcr = jcost.state_cost(jnp.asarray(y), t, jnp.asarray(crash))
        tc, tcr = tcost.state_cost(torch.from_numpy(y), t, torch.from_numpy(crash))
        _close(tc, jc, rtol=1e-5, atol=1e-4, what=f"{name} t={t}")
        np.testing.assert_array_equal(tcr.numpy(), np.asarray(jcr))
        if tcost.costmap is not None:
            assert tc[5] == np.float32(1e16)  # the NaN position is saturated
    assert int(np.asarray(jcr).sum()) > crash.sum()  # the map and the roll crash some
    tr, _ = tcost.running_cost(torch.from_numpy(y), torch.zeros((2, y.shape[1])), 0,
                               torch.from_numpy(crash))
    jr, _ = jcost.running_cost(jnp.asarray(y), jnp.zeros((2, y.shape[1])), 0,
                               jnp.asarray(crash))
    _close(tr, jr, rtol=1e-5, atol=1e-4)
    _close(tcost.terminal_cost(torch.from_numpy(y)), jcost.terminal_cost(jnp.asarray(y)))


def test_autorally_controller_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    from mppi_generic_tpu_torch import GaussianDistribution, VanillaMPPI

    def parts():
        return (AutorallyNNDynamics.create(seed=0), ARStandardCost(),
                GaussianDistribution.create(std_dev=[0.3, 0.5]))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VanillaMPPI(*parts(), num_timesteps=8, num_rollouts=16, kernel="fused_solve")
    ctrl = VanillaMPPI(*parts(), num_timesteps=8, num_rollouts=16, kernel="fused_solve",
                       device="cpu")
    res, _ = ctrl.solve(torch.tensor([0.0, 0.0, 0.0, 0.0, 3.0, 0.0, 0.0]),
                        ctrl.init_state(seed=0))
    assert res.control_mean.shape == (8, 2) and bool(torch.isfinite(res.costs).all())
