"""The racer models of the port against the JAX package's, on the CPU:
static settling, the RACER Dubins and elevation steps, the LSTM-steering
model's recurrent step (eager and in the kernels' order), the suspension
and LSTM-uncertainty models' recurrent steps, the covariance helpers, the
warm start from the sensor buffer and the re-rollout of one sequence. The
JAX models are built first (their LSTMs from JAX keys, at scale 0.5 so that
the networks move the state); the port's take their parameters through
``convert``. Tolerance rtol 1e-5 / atol 1e-5 unless a case states another:
the network sums and the map products differ in the last bits.

``jax_racer_params`` and ``jax_racer`` are shared with
``test_torch_racer_kernels.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mppi_generic_tpu.models.base as jbase
from mppi_generic_tpu.maps.texture import MapTexture2D as JTex
from mppi_generic_tpu.models import RacerDubinsDynamics as JRacerDubins
from mppi_generic_tpu.models import RacerDubinsElevationDynamics as JElevation
from mppi_generic_tpu.models import RacerDubinsElevationLSTMSteering as JSteering
from mppi_generic_tpu.models import RacerDubinsElevationLSTMUncertainty as JUnc
from mppi_generic_tpu.models import RacerDubinsElevationSuspension as JSuspension
from mppi_generic_tpu.models import racer_dubins_elevation as jelev
from mppi_generic_tpu.models import racer_dubins_unc as junc
from mppi_generic_tpu.nn.lstm import LSTM as JLSTM
from mppi_generic_tpu.nn.lstm import LSTMLSTM as JLSTMLSTM
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.models import (
    RacerDubinsDynamics,
    RacerDubinsElevationDynamics,
    RacerDubinsElevationLSTMSteering,
    RacerDubinsElevationLSTMUncertainty,
    RacerDubinsElevationSuspension,
    rollout_single,
    static_settling,
)
from mppi_generic_tpu_torch.models import racer_dubins_unc as tunc
from mppi_generic_tpu_torch.nn import LSTM, LSTMLSTM
from test_torch_autorally import jax_texture_params
from test_torch_lstm import _npz, jax_lstm_params

RTOL, ATOL = 1e-5, 1e-5
DT = 0.02
CONSTRAINTS = ("control_ranges", "control_deadband", "zero_control")


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def jax_elevation_map(side=32, seed=1, scale=0.3):
    """A small elevation map of normal heights (0.25 m texels) around the
    origin, so that settling tilts the car."""
    data = (scale * np.random.default_rng(seed).normal(size=(side, side))).astype("f")
    return JTex.create(data, origin=(-side / 8, -side / 8, 0.0), resolution=0.25)


def jax_racer(kind, elevation=True, scale=0.5, warm_seed=5):
    """A JAX racer model: ``kind`` "steering" or "unc" (or "suspension"),
    LSTMs from JAX keys at ``scale``, a nonzero warm (h, c) from a numpy
    seed."""
    emap = jax_elevation_map() if elevation else None
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    lstm = JLSTM.create(4, 16, output_layers=[20, 16, 1], key=keys[0], scale=scale)
    rng = np.random.default_rng(warm_seed)

    def warm(H=16):
        return jnp.asarray((0.3 * rng.normal(size=(H,))).astype(np.float32))

    if kind == "steering":
        return JSteering.create(lstm=lstm, elevation_map=emap).replace(
            warm_hidden=warm(), warm_cell=warm())
    if kind == "suspension":
        return JSuspension.create(lstm=lstm, elevation_map=emap).replace(
            warm_hidden=warm(), warm_cell=warm())
    return JUnc.create(
        lstm=lstm, elevation_map=emap,
        mean_lstm=JLSTM.create(11, 16, output_layers=[27, 16, 2], key=keys[1], scale=scale),
        unc_lstm=JLSTM.create(12, 16, output_layers=[28, 16, 5], key=keys[2], scale=scale),
    ).replace(**{n: warm() for n in RacerDubinsElevationLSTMUncertainty.WARM})


def jax_racer_params(jdyn, cls):
    """A JAX racer model's parameters for ``convert`` (``cls`` the port's
    class, whose ``param_names`` are read)."""
    p = {n: np.asarray(getattr(jdyn, n)) for n in CONSTRAINTS + cls.param_names()}
    emap = getattr(jdyn, "elevation_map", None)
    p["elevation_map"] = None if emap is None else jax_texture_params(emap)
    if hasattr(jdyn, "lstm"):
        p["lstm"] = jax_lstm_params(jdyn.lstm)
        p["warm_hidden"], p["warm_cell"] = np.asarray(jdyn.warm_hidden), np.asarray(
            jdyn.warm_cell)
    if hasattr(jdyn, "mean_lstm"):
        p["mean_lstm"] = jax_lstm_params(jdyn.mean_lstm)
        p["unc_lstm"] = jax_lstm_params(jdyn.unc_lstm)
        p.update({n: np.asarray(getattr(jdyn, n)) for n in cls.WARM})
    return p


def port_racer(jdyn):
    if isinstance(jdyn, JUnc):
        return convert.racer_unc_from_params(jax_racer_params(jdyn, RacerDubinsElevationLSTMUncertainty))
    if isinstance(jdyn, JSuspension):
        cls = RacerDubinsElevationSuspension
        p = jax_racer_params(jdyn, cls)
        return cls(convert.lstm_from_params(p["lstm"]), warm_hidden=p["warm_hidden"],
                   warm_cell=p["warm_cell"], **convert._racer_kwargs(p, cls))
    return convert.racer_steering_from_params(jax_racer_params(jdyn, RacerDubinsElevationLSTMSteering))


def racer_state(S, K, seed, vel=3.0):
    """(S, K) states near v_x = ``vel``: small angles, positions on the map,
    the suspension and covariance entries small and positive on the
    diagonal."""
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.normal(size=(S, K))).astype(np.float32)
    x[0] += vel
    x[1] = rng.uniform(-3.1, 3.1, size=K)
    x[2:4] = rng.uniform(-1.5, 1.5, size=(2, K))
    x[5] = np.abs(x[5])
    if S >= 23:
        x[13:17] = np.abs(x[13:17])
    return x


def racer_controls(K, seed):
    return np.clip(np.random.default_rng(seed).normal(scale=0.6, size=(2, K)), -1, 1).astype(
        np.float32)


# --- settling and the parametric models ------------------------------------
@pytest.mark.parametrize("with_map", [True, False])
def test_static_settling_matches_jax(with_map):
    jmap = jax_elevation_map() if with_map else None
    tmap = None if jmap is None else convert.texture_from_params(jax_texture_params(jmap))
    rng = np.random.default_rng(2)
    px, py = rng.uniform(-3, 3, size=(2, 300)).astype(np.float32)
    yaw, roll, pitch = (rng.uniform(-0.5, 0.5, size=(3, 300)) * [[6], [1], [1]]).astype(
        np.float32)
    want = jelev.static_settling(jmap, *(jnp.asarray(a) for a in (px, py, yaw, roll, pitch)))
    got = static_settling(tmap, *(torch.from_numpy(a) for a in (px, py, yaw, roll, pitch)))
    for t, j, what in zip(got, want, ("roll", "pitch", "height")):
        _close(t, j, what=what)
    if with_map:
        assert float(np.abs(np.asarray(want[0])).max()) > 0.01  # the map tilts the car


def test_racer_dubins_step_matches_jax():
    jdyn = JRacerDubins.create(c_t=1.1, wheel_base=0.4)
    tdyn = RacerDubinsDynamics.create(
        **{n: np.asarray(getattr(jdyn, n)) for n in RacerDubinsDynamics.param_names()})
    x, u = racer_state(7, 200, seed=3, vel=0.5), racer_controls(200, seed=4)
    jx, jy = jdyn.step(jnp.asarray(x), jnp.asarray(u), 0.0, DT)
    tx, ty = tdyn.step(torch.from_numpy(x), torch.from_numpy(u), 0.0, DT)
    _close(tx, jx)
    _close(ty, jy)
    assert float(tdyn.c_t) == np.float32(1.1) and float(tdyn.brake_max) == 1.0


@pytest.mark.parametrize("with_map", [True, False])
def test_racer_elevation_step_matches_jax(with_map):
    jdyn = JElevation.create(elevation_map=jax_elevation_map() if with_map else None)
    tdyn = RacerDubinsElevationDynamics.create(
        elevation_map=None if not with_map else convert.texture_from_params(
            jax_texture_params(jax_elevation_map())),
        **{n: np.asarray(getattr(jdyn, n)) for n in RacerDubinsElevationDynamics.param_names()})
    # speeds in every regime, some braking
    x = racer_state(9, 300, seed=5)
    x[0] = np.random.default_rng(6).uniform(-4, 4, size=300)
    u = racer_controls(300, seed=7)
    jx, jy = jdyn.step(jnp.asarray(x), jnp.asarray(u), 0.0, DT)
    tx, ty = tdyn.step(torch.from_numpy(x), torch.from_numpy(u), 0.0, DT)
    _close(tx, jx)
    _close(ty, jy)


# --- the recurrent models ----------------------------------------------------
def _roll_steps(jdyn, tdyn, x, u_seq, step_names=("step_recurrent", "kernel_step_recurrent")):
    """Step both models through ``u_seq`` (n, C, K) from (S, K) states with
    the warm (h, c) broadcast per sample; compare state, output and (h, c)
    after every step."""
    K = x.shape[1]
    jrec0 = tuple(jnp.broadcast_to(r[:, None], (r.shape[0], K))
                  for r in jdyn.init_recurrent_state())
    for name in step_names:
        jx, jrec = jnp.asarray(x), jrec0
        tx = torch.from_numpy(x)
        trec = tuple(r[:, None].expand(-1, K) for r in tdyn.init_recurrent_state())
        for t, u in enumerate(u_seq):
            jx, jy, jrec = jdyn.step_recurrent(jx, jrec, jnp.asarray(u), float(t), DT)
            tx, ty, trec = getattr(tdyn, name)(tx, trec, torch.from_numpy(u), float(t), DT)
            _close(tx, jx, what=f"{name} state, step {t}")
            _close(ty, jy, what=f"{name} output, step {t}")
            for tr, jr in zip(trec, jrec):
                _close(tr, jr, what=f"{name} recurrent state, step {t}")
    return jx


@pytest.mark.parametrize("with_map", [True, False])
def test_racer_steering_step_recurrent_matches_jax(with_map):
    jdyn = jax_racer("steering", elevation=with_map)
    tdyn = port_racer(jdyn)
    u_seq = [racer_controls(64, seed=10 + t) for t in range(5)]
    jx = _roll_steps(jdyn, tdyn, racer_state(9, 64, seed=8), u_seq)
    assert float(jnp.abs(jx[7]).max()) > (0.01 if with_map else -1)
    # the stateless step of one state starts from the warm state
    x0, u0 = racer_state(9, 1, seed=9)[:, 0], u_seq[0][:, 0]
    _close(tdyn.step(torch.from_numpy(x0), torch.from_numpy(u0), 0.0, DT)[0],
           jdyn.step(jnp.asarray(x0), jnp.asarray(u0), 0.0, DT)[0])


@pytest.mark.parametrize("with_map", [False, True])
def test_racer_suspension_step_recurrent_matches_jax(with_map):
    jdyn = jax_racer("suspension", elevation=with_map)
    tdyn = port_racer(jdyn)
    u_seq = [racer_controls(32, seed=20 + t) for t in range(3)]
    _roll_steps(jdyn, tdyn, racer_state(23, 32, seed=11), u_seq, ("step_recurrent",))


@pytest.mark.parametrize("with_map", [False, True])
def test_racer_unc_step_recurrent_matches_jax(with_map):
    jdyn = jax_racer("unc", elevation=with_map)
    tdyn = port_racer(jdyn)
    u_seq = [racer_controls(48, seed=30 + t) for t in range(4)]
    x = racer_state(26, 48, seed=12)
    x[0, :8] = np.linspace(-0.3, 0.3, 8)  # the low-speed regime and reverse
    jx = _roll_steps(jdyn, tdyn, x, u_seq)
    assert bool(jnp.all(jnp.isfinite(jx)))


def test_racer_unc_helpers_match_jax():
    rng = np.random.default_rng(13)
    s10 = rng.normal(size=(10, 5)).astype(np.float32)
    A, Q = (rng.normal(size=(4, 4, 5)).astype(np.float32) for _ in range(2))
    _close(torch.stack([torch.stack(r) for r in tunc.unc_state_to_matrix(torch.from_numpy(s10))]),
           junc.unc_state_to_matrix(jnp.asarray(s10)), rtol=0, atol=0)
    S = rng.normal(size=(4, 4, 5)).astype(np.float32)
    _close(tunc.unc_matrix_to_state(torch.from_numpy(S)),
           junc.unc_matrix_to_state(jnp.asarray(S)), rtol=0, atol=0)
    _close(tunc.propagate_uncertainty(torch.from_numpy(s10), torch.from_numpy(A),
                                      torch.from_numpy(Q), DT),
           junc.propagate_uncertainty(jnp.asarray(s10), jnp.asarray(A), jnp.asarray(Q), DT),
           1e-6, 1e-6)


@pytest.mark.parametrize("kind", ["steering", "unc"])
def test_rollout_single_carries_the_lstm_state(kind):
    """The controller's re-rollout of one sequence from the warm state."""
    jdyn = jax_racer(kind, elevation=kind == "steering")
    tdyn = port_racer(jdyn)
    S = tdyn.STATE_DIM
    x0 = np.zeros(S, np.float32)
    x0[0] = 3.0
    U = (0.5 * np.random.default_rng(14).normal(size=(12, 2))).astype(np.float32)
    js, jy = jbase.rollout_single(jdyn, jnp.asarray(x0), jnp.asarray(U), DT)
    ts, ty = rollout_single(tdyn, torch.from_numpy(x0), torch.from_numpy(U), DT)
    _close(ts, js)
    _close(ty, jy)


def test_update_from_buffer_warm_starts_like_jax():
    init_npz, pred_npz = _npz(6, 12, [10, 32], seed=15), _npz(4, 16, [16, 1], seed=16)
    jll = JLSTMLSTM.from_npz(init_npz, pred_npz, init_len=4)
    jdyn = JSteering.create(lstm=jll.pred_model).replace(lstm_lstm=jll)
    tdyn = RacerDubinsElevationLSTMSteering(LSTM.from_npz(pred_npz),
                                            lstm_lstm=LSTMLSTM.from_npz(init_npz, pred_npz, 4))
    assert tdyn.requires_buffer and jdyn.requires_buffer
    buf = np.random.default_rng(17).normal(size=(8, 6)).astype(np.float32)
    table0 = tdyn.kernel_params().clone()
    jdyn = jdyn.update_from_buffer(jnp.asarray(buf))
    assert tdyn.update_from_buffer(torch.from_numpy(buf)) is tdyn
    _close(tdyn.warm_hidden, jdyn.warm_hidden)
    _close(tdyn.warm_cell, jdyn.warm_cell)
    table = tdyn.kernel_params()
    _close(table[-32:-16], jdyn.warm_hidden)  # the kernels' table follows
    assert not torch.equal(table, table0)


def test_unc_update_from_buffer_sets_each_warm_state():
    init_npz, pred_npz = _npz(6, 12, [10, 32], seed=18), _npz(11, 16, [16, 2], seed=19)
    tdyn = RacerDubinsElevationLSTMUncertainty.create(
        mean_lstm=LSTM.from_npz(pred_npz))
    tdyn.mean_lstm_lstm = LSTMLSTM.from_npz(init_npz, pred_npz, 2)
    jll = JLSTMLSTM.from_npz(init_npz, pred_npz, init_len=2)
    buf = np.random.default_rng(20).normal(size=(3, 6)).astype(np.float32)
    tdyn.update_from_buffer(torch.from_numpy(buf))
    jh, jc = jll.initialize(jnp.asarray(buf))
    _close(tdyn.mean_warm_hidden, jh)
    _close(tdyn.mean_warm_cell, jc)
    assert float(tdyn.warm_hidden.abs().max()) == 0  # no init network: unchanged


def test_racer_kernel_tables_refuse_what_the_kernels_do_not_take():
    steer = RacerDubinsElevationLSTMSteering.create()
    assert steer.kernel_params().shape == (27 + 20 + 1697 + 32,)
    assert steer.kernel_map() is None
    odd = RacerDubinsElevationLSTMSteering(LSTM.create(4, 8, [12, 4, 1], seed=0))
    with pytest.raises(NotImplementedError, match="steering LSTM"):
        odd.kernel_params()
    unc = RacerDubinsElevationLSTMUncertainty.create()
    assert unc.kernel_params().shape[0] == 55 + 20 + 1697 + 2274 + 2405 + 96
    # the uncertainty model on an elevation map and the suspension model take
    # their tables too: the map block says a map is there
    tmap = convert.texture_from_params(jax_texture_params(jax_elevation_map()))
    unc_map = RacerDubinsElevationLSTMUncertainty.create(elevation_map=tmap)
    assert int(unc_map.kernel_params()[55:56].view(torch.int32)) == 1
    assert unc_map.kernel_map() is unc_map.elevation_map.data
    assert RacerDubinsElevationSuspension.create().kernel_params().shape == (
        46 + 20 + 1697 + 32,)
    with pytest.raises(NotImplementedError, match="uncertainty LSTM"):
        RacerDubinsElevationLSTMUncertainty.create(
            unc_lstm=LSTM.create(12, 8, [20, 8, 5], seed=0)).kernel_params()
    with pytest.raises(TypeError, match="unknown"):
        RacerDubinsElevationLSTMSteering.create(c_x=1.0)
