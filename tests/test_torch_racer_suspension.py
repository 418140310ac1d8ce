"""The port's RacerSuspensionDynamics (the 14-state rigid body with four
spring-damper wheels) against the JAX package's, on the CPU: one step over a
batch of random states, flat and on an elevation map; the edge cases (the
Ackermann denominator's sign flip at a large steering angle, a body velocity
of exactly zero, wheels off the ground with their spring force clamped at
zero); a 20-step rollout; ``state_to_output``, the zero state and the
converter from the JAX model's parameters; and that ``models.__all__`` and
``maps.__all__`` name what the JAX package's name.

Tolerances: rtol 1e-5 / atol 1e-5 a step, on the state and the 26 outputs
(the wheel forces are about 3.5e3 N, so the relative term carries them). On
the elevation map the JAX package's query sums its four texels in another
order (its one-hot matmul): the heights differ by up to a few ulps, which
the spring turns into k_s times as much force, so the four wheel-force
outputs there also get atol 2 max(k_s) max|dh|, with dh measured between
the two packages' queries over the map's patch (about 1e-3 N).
The 20-step rollout at rtol 1e-4 / atol 1e-4: the measured difference after
20 steps is a few ulps of each state, which the spring's stiffness
(k_s = 14000) lifts by up to two orders through the velocities."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.models import RacerSuspensionDynamics as JSuspension
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.models import RacerSuspensionDynamics, rollout_single
from test_torch_autorally import jax_texture_params
from test_torch_racer import jax_elevation_map

RTOL, ATOL = 1e-5, 1e-5
DT = 0.02
CONSTRAINTS = ("control_ranges", "control_deadband", "zero_control")


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def jax_suspension_params(jdyn):
    """The JAX model's parameters for ``convert.racer_suspension_from_params``."""
    p = {n: np.asarray(getattr(jdyn, n))
         for n in CONSTRAINTS + RacerSuspensionDynamics.param_names()}
    emap = jdyn.elevation_map
    p["elevation_map"] = None if emap is None else jax_texture_params(emap)
    return p


def models(with_map, **kw):
    jdyn = JSuspension.create(elevation_map=jax_elevation_map() if with_map else None, **kw)
    return jdyn, convert.racer_suspension_from_params(jax_suspension_params(jdyn))


def suspension_states(K, seed, steer_scale=0.4, height=0.52):
    """(14, K) states near rest on the map's patch: a small random attitude
    (a normalized quaternion), velocities, rates and steering angles."""
    rng = np.random.default_rng(seed)
    x = np.zeros((14, K), np.float32)
    x[0:2] = rng.uniform(-1.5, 1.5, size=(2, K))
    x[2] = height + 0.05 * rng.normal(size=K)
    q = np.concatenate([np.ones((1, K)), 0.1 * rng.normal(size=(3, K))])
    x[3:7] = q / np.linalg.norm(q, axis=0)
    x[7:10] = rng.normal(scale=[[2.0], [0.5], [0.2]], size=(3, K))
    x[10:13] = 0.3 * rng.normal(size=(3, K))
    x[13] = steer_scale * rng.normal(size=K)
    return x


def controls(K, seed):
    return np.clip(np.random.default_rng(seed).normal(scale=0.6, size=(2, K)), -1, 1).astype(
        np.float32)


def _step_both(jdyn, tdyn, x, u):
    jx, jy = jdyn.step(jnp.asarray(x), jnp.asarray(u), 0.0, DT)
    tx, ty = tdyn.step(torch.from_numpy(x), torch.from_numpy(u), 0.0, DT)
    return (tx, ty), (np.asarray(jx), np.asarray(jy))


# the four wheel-force outputs
FORCES = slice(19, 23)


def force_atol(jdyn, tdyn):
    """2 max(k_s) max|dh| + ATOL: dh between the two packages' height
    queries at 4096 points over the map's patch (0 without a map)."""
    if jdyn.elevation_map is None:
        return ATOL
    px, py = np.random.default_rng(0).uniform(-2.5, 2.5, size=(2, 4096)).astype(np.float32)
    jh = jdyn.elevation_map.query_at_world_pose(jnp.stack([px, py, 0 * px], -1))
    th = tdyn.elevation_map.query_world_components(torch.from_numpy(px), torch.from_numpy(py))
    dh = float(np.abs(np.asarray(jh) - th.numpy()).max())
    return 2 * float(np.max(np.asarray(jdyn.k_s))) * dh + ATOL


@pytest.mark.parametrize("with_map", [False, True])
def test_step_matches_jax(with_map):
    jdyn, tdyn = models(with_map)
    x, u = suspension_states(256, seed=1), controls(256, seed=2)
    (tx, ty), (jx, jy) = _step_both(jdyn, tdyn, x, u)
    _close(tx, jx, what="state")
    _close(ty[:19], jy[:19], what="output")
    _close(ty[FORCES], jy[FORCES], atol=force_atol(jdyn, tdyn), what="wheel forces")
    _close(ty[23:], jy[23:], what="accelerations")
    # the spring forces act: some wheels push, the map changes them
    assert float(ty[19:23].max()) > 100.0
    if with_map:
        _, tflat = models(False)
        assert not torch.allclose(tflat.step(torch.from_numpy(x), torch.from_numpy(u), 0.0,
                                             DT)[1], ty)


def test_edge_cases_match_jax():
    """The Ackermann denominator wheel_base -+ tan(delta) width / 2 changes
    sign past tan(delta) = 3.97 (steering angles about +-1.33): half the
    samples steer beyond it; a body velocity of exactly zero (torch.sign 0,
    the brake term off); wheels lifted off the ground (f_k clamped at 0)."""
    jdyn, tdyn = models(False)
    K = 64
    x = suspension_states(K, seed=3)
    x[13, :32] = np.linspace(-1.5, 1.5, 32)  # both signs of the denominators
    x[7:10, 32:40] = 0.0                      # vel_bx = 0
    x[2, 40:48] = 1.5                         # every wheel off the ground
    u = controls(K, seed=4)
    u[0, 32:40] = -0.7                        # braking at rest
    tan = np.tan(x[13, :32])
    assert (np.float32(2.981) - tan * 0.75 < 0).any() and (np.float32(2.981) + tan * 0.75 < 0).any()
    (tx, ty), (jx, jy) = _step_both(jdyn, tdyn, x, u)
    _close(tx, jx, what="state")
    _close(ty, jy, what="output")
    assert float(ty[FORCES, 40:48].abs().max()) == 0.0  # lifted: no wheel force


@pytest.mark.parametrize("with_map", [False, True])
def test_rollout_matches_jax(with_map):
    jdyn, tdyn = models(with_map)
    x0 = np.array(jdyn.get_zero_state())
    x0[7] = 3.0
    U = controls(20, seed=5).T.copy()
    jx, jy = jnp.asarray(x0), []
    jstates = [jx]
    for t in range(20):
        jx, y = jdyn.step(jx, jnp.asarray(U[t]), float(t), DT)
        jstates.append(jx)
        jy.append(y)
    ts, ty = rollout_single(tdyn, torch.from_numpy(x0), torch.from_numpy(U), DT)
    jy = np.stack([np.asarray(y) for y in jy])
    _close(ts, np.stack([np.asarray(s) for s in jstates]), 1e-4, 1e-4, "states")
    _close(ty[:, :19], jy[:, :19], 1e-4, 1e-4, "outputs")
    _close(ty[:, FORCES], jy[:, FORCES], 1e-4, 10 * force_atol(jdyn, tdyn), "wheel forces")
    _close(ty[:, 23:], jy[:, 23:], 1e-4, 1e-4, "accelerations")


def test_state_to_output_and_zero_state_match_jax():
    jdyn, tdyn = models(True, c_t=2.5, mu=0.8)
    _close(tdyn.get_zero_state(), jdyn.get_zero_state(), 0, 0, "zero state")
    x = suspension_states(32, seed=6)
    ty, jy = tdyn.state_to_output(torch.from_numpy(x)), jdyn.state_to_output(jnp.asarray(x))
    _close(ty[:19], jy[:19], what="state_to_output")
    _close(ty[FORCES], jy[FORCES], atol=force_atol(jdyn, tdyn), what="state_to_output forces")
    _close(ty[23:], jy[23:], what="state_to_output accelerations")
    _close(tdyn.state_deriv(torch.from_numpy(x), torch.from_numpy(controls(32, 7))),
           jdyn.state_deriv(jnp.asarray(x), jnp.asarray(controls(32, 7))), what="state_deriv")


def test_converter_carries_every_parameter():
    jdyn, tdyn = models(True, c_t=2.5, mu=0.8, k_s=np.array([1.3e4, 1.4e4, 1.5e4, 1.6e4]))
    for name in RacerSuspensionDynamics.param_names():
        _close(getattr(tdyn, name), getattr(jdyn, name), 0, 0, name)
    assert tdyn.kernel_params().shape == (len(tdyn.params) + 20,)
    assert tdyn.kernel_map() is tdyn.elevation_map.data
    assert float(tdyn.kernel_params()[len(tdyn.params)].view(torch.int32)) == 1  # a map


def test_models_and_maps_export_what_the_jax_package_exports():
    import mppi_generic_tpu.maps as jmaps
    import mppi_generic_tpu.models as jmodels
    import mppi_generic_tpu_torch.maps as tmaps
    import mppi_generic_tpu_torch.models as tmodels

    assert set(tmodels.__all__) == set(jmodels.__all__)
    assert set(tmaps.__all__) == set(jmaps.__all__)
    for mod in (tmodels, tmaps):
        for name in mod.__all__:
            assert getattr(mod, name) is not None
