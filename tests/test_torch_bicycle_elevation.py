"""The port's BicycleSlipParametricElevation, ``body_frame_normals`` and
``MapTexture3D`` against the JAX package's, on the CPU: the normals under
the four wheels (no map, a 3-channel normals map, non-finite texels); the
22-state step with no map, an elevation map, a normals map and both; a
20-step rollout on both maps; the host ``update_state``; the trilinear
query of a layered map; the converter from the JAX model's parameters.

The JAX package's ``body_frame_normals`` (and so its step with a normals
map) takes one sample's scalars: it stacks roll, pitch and yaw on the last
axis and reads them back by the first. The JAX side runs under
``jax.vmap`` over the samples here; the port's takes the batch as it is.

Tolerances: rtol 1e-5 / atol 1e-5 a step, the normals and the 3D query
(the JAX query's one-hot sums differ from the lerp in the last bits); the
20-step rollout rtol 1e-4 / atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.maps.texture import MapTexture2D as JTex
from mppi_generic_tpu.maps.texture import MapTexture3D as JTex3
from mppi_generic_tpu.models import BicycleSlipParametricElevation as JBicycle
from mppi_generic_tpu.models import racer_dubins_elevation as jelev
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.maps import MapTexture3D
from mppi_generic_tpu_torch.models import BicycleSlipParametricElevation, body_frame_normals
from test_torch_autorally import jax_texture_params
from test_torch_racer import jax_elevation_map

RTOL, ATOL = 1e-5, 1e-5
DT = 0.02
CONSTRAINTS = ("control_ranges", "control_deadband", "zero_control")


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def jax_normals_map(side=32, seed=3):
    """Unit normals (H, W, 3) of a smooth random height field, 0.25 m texels
    over the elevation map's patch."""
    rng = np.random.default_rng(seed)
    h = np.cumsum(np.cumsum(0.05 * rng.normal(size=(side, side)), 0), 1)
    gy, gx = np.gradient(h, 0.25)
    n = np.stack([-gx, -gy, np.ones_like(h)], -1)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    return JTex.create(n, origin=(-side / 8, -side / 8, 0.0), resolution=0.25)


def jax_bicycle_params(jdyn):
    p = {n: np.asarray(getattr(jdyn, n))
         for n in CONSTRAINTS + BicycleSlipParametricElevation.param_names()}
    for name in ("elevation_map", "normals_map"):
        m = getattr(jdyn, name)
        p[name] = None if m is None else jax_texture_params(m)
    return p


def models(elevation, normals, **kw):
    jdyn = JBicycle.create(elevation_map=jax_elevation_map() if elevation else None,
                           normals_map=jax_normals_map() if normals else None, **kw)
    return jdyn, convert.bicycle_parametric_elevation_from_params(jax_bicycle_params(jdyn))


def bicycle_states(K, seed):
    """(22, K) states: positions on the maps' patch, speeds 0-5 m/s (every
    regime of Q), small angles, a positive-definite covariance."""
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.normal(size=(22, K))).astype(np.float32)
    x[0:2] = rng.uniform(-1.5, 1.5, size=(2, K))
    x[2] = rng.uniform(-3.1, 3.1, size=K)
    x[4] = np.abs(x[4])
    x[5] = rng.uniform(0.0, 5.0, size=K)
    x[12:16] = np.abs(x[12:16]) + 0.05
    return x


def controls(K, seed):
    return np.clip(np.random.default_rng(seed).normal(scale=0.6, size=(2, K)), -1, 1).astype(
        np.float32)


def jax_stepper(jdyn):
    """JAX's step per sample (``jax.vmap``, jitted): (x (22, K), u (2, K), t)
    -> (x_next, y) as numpy (22, K), (14, K)."""
    fn = jax.jit(jax.vmap(lambda xs, us, t: jdyn.step(xs, us, t, DT), in_axes=(1, 1, None),
                          out_axes=1))

    def step(x, u, t=0.0):
        jx, jy = fn(jnp.asarray(x), jnp.asarray(u), jnp.float32(t))
        return np.asarray(jx), np.asarray(jy)

    return step


def test_body_frame_normals_match_jax():
    jmap = jax_normals_map()
    tmap = convert.texture_from_params(jax_texture_params(jmap))
    rng = np.random.default_rng(4)
    px, py = rng.uniform(-2.5, 2.5, size=(2, 300)).astype(np.float32)
    yaw = rng.uniform(-3.1, 3.1, size=300).astype(np.float32)
    roll, pitch = (0.3 * rng.normal(size=(2, 300))).astype(np.float32)
    args = (px, py, yaw, roll, pitch)
    want = jax.vmap(lambda *a: jelev.body_frame_normals(jmap, *a))(*map(jnp.asarray, args))
    got = body_frame_normals(tmap, *map(torch.from_numpy, args))
    for t, j, what in zip(got, want, "xyz"):
        _close(t, j, what=f"n{what}")
    assert float(torch.abs(got[0]).max()) > 0.01  # the terrain tilts the normals
    # no map: (0, 0, 1)
    none = body_frame_normals(None, *map(torch.from_numpy, args))
    for t, v in zip(none, (0.0, 0.0, 1.0)):
        assert bool((t == v).all())
    # a non-finite texel under a wheel: (0, 0, 1) there, as JAX
    data = np.array(jmap.data)
    data[:, :, 0] = np.nan
    bad = convert.texture_from_params({**jax_texture_params(jmap), "data": data})
    nan_n = body_frame_normals(bad, *map(torch.from_numpy, args))
    for t, v in zip(nan_n, (0.0, 0.0, 1.0)):
        assert bool((t == v).all())


@pytest.mark.parametrize("elevation,normals", [(False, False), (True, False), (False, True),
                                               (True, True)])
def test_step_matches_jax(elevation, normals):
    jdyn, tdyn = models(elevation, normals)
    x, u = bicycle_states(256, seed=5), controls(256, seed=6)
    jx, jy = jax_stepper(jdyn)(x, u)
    tx, ty = tdyn.step(torch.from_numpy(x), torch.from_numpy(u), 0.0, DT)
    _close(tx, jx, what="state")
    _close(ty, jy, what="output")
    if elevation:  # settling tilts the car
        assert float(tx[8].abs().max()) > 0.01
    if normals:  # the gravity terms act
        _, tflat = models(elevation, False)
        assert not torch.allclose(tflat.state_deriv(torch.from_numpy(x), torch.from_numpy(u)),
                                  tdyn.state_deriv(torch.from_numpy(x), torch.from_numpy(u)))


def test_rollout_matches_jax():
    jdyn, tdyn = models(True, True)
    x = bicycle_states(64, seed=7)
    jx, tx = x, torch.from_numpy(x)
    jax_step = jax_stepper(jdyn)
    for t in range(20):
        u = controls(64, seed=100 + t)
        jx, jy = jax_step(jx, u, float(t))
        tx, ty = tdyn.step(tx, torch.from_numpy(u), float(t), DT)
        _close(tx, jx, 1e-4, 1e-4, f"state, step {t}")
        _close(ty, jy, 1e-4, 1e-4, f"output, step {t}")


def test_update_state_matches_jax():
    jdyn, tdyn = models(True, False)
    x, u = bicycle_states(64, seed=8), controls(64, seed=9)
    xdot = np.array(jdyn.state_deriv(jnp.asarray(x), jnp.asarray(u)))
    _close(tdyn.update_state(torch.from_numpy(x), torch.from_numpy(xdot), DT),
           jdyn.update_state(jnp.asarray(x), jnp.asarray(xdot), DT), what="update_state")
    _close(tdyn.get_zero_state(), jdyn.get_zero_state(), 0, 0, "zero state")


def test_converter_carries_every_parameter():
    jdyn, tdyn = models(True, True, K_x=0.5, Q_y_f=0.2, gravity_x=-4.0)
    for name in BicycleSlipParametricElevation.param_names():
        _close(getattr(tdyn, name), getattr(jdyn, name), 0, 0, name)
    assert float(tdyn.brake_max) == 1.0
    assert tdyn.kernel_params().shape == (len(tdyn.params) + 20,)
    assert tdyn.normals_map.channels == 3


@pytest.mark.parametrize("where", ["tex", "world"])
def test_map_texture_3d_matches_jax(where):
    rng = np.random.default_rng(10)
    data = rng.normal(size=(5, 12, 9)).astype(np.float32)
    rot = np.array([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]], np.float32)
    jtex = JTex3.create(data, origin=(0.5, -0.3, 0.2), rotation=rot, resolution=0.4)
    ttex = MapTexture3D(data, origin=(0.5, -0.3, 0.2), rotation=rot, resolution=0.4)
    if where == "tex":  # the sample positions inside and past the edges
        uvw = rng.uniform(-0.2, 1.2, size=(3, 500)).astype(np.float32)
        want = jtex.query_tex(*map(jnp.asarray, uvw))
        got = ttex.query_tex(*map(torch.from_numpy, uvw))
    else:
        pts = rng.uniform(-2.0, 4.0, size=(500, 3)).astype(np.float32)
        want = jtex.query_at_world_pose(jnp.asarray(pts))
        got = ttex.query_at_world_pose(torch.from_numpy(pts))
    _close(got, want, what="trilinear query")
    # the reference case of the JAX suite: a plane of zeros under a plane of ones
    two = MapTexture3D(np.stack([np.zeros((2, 2)), np.ones((2, 2))]).astype(np.float32))
    half = torch.tensor(0.5)
    assert abs(float(two.query_tex(half, half, half)) - 0.5) < 1e-6
    assert float(two.query_tex(half, half, torch.tensor(0.25))) == 0.0
