"""The port's LSTM (nn/lstm.py) against the JAX package's, on the CPU: the
step, the forward with its head, the component-first forms and their
plain (kernel-order) twins, the npz loader with its ``model/`` prefix and
the LSTM-LSTM warm start. The JAX objects are built first from JAX keys; the
port's take their parameters through ``convert``. Tolerance rtol 1e-5 /
atol 1e-6 (matmul and left-to-right sums differ in the last bits).

``jax_lstm_params`` carries a JAX LSTM's parameters across as numpy
arrays; ``test_torch_racer.py`` uses it too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.nn.lstm import LSTM as JLSTM
from mppi_generic_tpu.nn.lstm import LSTMLSTM as JLSTMLSTM
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.nn import LSTM, LSTMLSTM
from mppi_generic_tpu_torch.nn.lstm import sigmoid
from test_torch_autorally import jax_fnn_params

RTOL, ATOL = 1e-5, 1e-6


def jax_lstm_params(lstm):
    p = {n: np.asarray(getattr(lstm, n))
         for n in convert.LSTM_FIELDS + ("initial_hidden", "initial_cell")}
    p["output_nn"] = None if lstm.output_nn is None else jax_fnn_params(lstm.output_nn)
    return p


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


def _pair(I, H, head, seed=0, scale=0.5):
    j = JLSTM.create(I, H, output_layers=head, key=jax.random.PRNGKey(seed), scale=scale)
    return j, convert.lstm_from_params(jax_lstm_params(j))


# the racer models' three LSTMs and a small odd one
SHAPES = [(4, 16, [20, 16, 1]), (11, 16, [27, 16, 2]), (12, 16, [28, 16, 5]),
          (3, 5, [8, 4, 2])]


@pytest.mark.parametrize("I,H,head", SHAPES)
def test_lstm_step_and_forward_match_jax(I, H, head):
    jl, tl = _pair(I, H, head, seed=I)
    rng = np.random.default_rng(I)
    h, c = (rng.normal(size=(6, H)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(6, I)).astype(np.float32)
    jh, jc = jl.step(jnp.asarray(h), jnp.asarray(c), jnp.asarray(x))
    th, tc = tl.step(*(torch.from_numpy(a) for a in (h, c, x)))
    _close(th, jh, what="h")
    _close(tc, jc, what="c")
    jo, jh, jc = jl.forward(jnp.asarray(h[0]), jnp.asarray(c[0]), jnp.asarray(x[0]))
    to, th, tc = tl.forward(*(torch.from_numpy(a[0]) for a in (h, c, x)))
    for t, j, what in ((to, jo, "out"), (th, jh, "h"), (tc, jc, "c")):
        _close(t, j, what=what)
    assert tl.hidden_dim == H and tl.input_dim == I


@pytest.mark.parametrize("I,H,head", SHAPES)
def test_lstm_axis0_and_plain_match_jax(I, H, head):
    """The component-first forms over a (2, 7) batch; the plain twin (the
    kernels' order of operations) against JAX's matmul form too."""
    jl, tl = _pair(I, H, head, seed=10 + I)
    rng = np.random.default_rng(20 + I)
    h, c = (rng.normal(size=(H, 2, 7)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(I, 2, 7)).astype(np.float32)
    want = jl.forward_axis0(jnp.asarray(h), jnp.asarray(c), jnp.asarray(x))
    for fwd in (tl.forward_axis0, tl.forward_axis0_plain):
        got = fwd(*(torch.from_numpy(a) for a in (h, c, x)))
        for t, j, what in zip(got, want, ("out", "h", "c")):
            _close(t, j, what=f"{fwd.__name__} {what}")
    jh, jc = jl.step_axis0(jnp.asarray(h), jnp.asarray(c), jnp.asarray(x))
    th, tc = tl.step_axis0_plain(*(torch.from_numpy(a) for a in (h, c, x)))
    _close(th, jh)
    _close(tc, jc)


def test_lstm_gate_views_and_kernel_table():
    jl, tl = _pair(4, 16, [20, 16, 1])
    for n in convert.LSTM_FIELDS:
        _close(getattr(tl, n), getattr(jl, n), rtol=0, atol=0, what=n)
    table = tl.kernel_table()
    assert table.shape == (4 * 16 * (16 + 4) + 4 * 16 + tl.output_nn.packed.numel(),)
    H = 16
    _close(table[: H * H].reshape(H, H), jl.W_im, rtol=0, atol=0)  # gate order i, f, o, c
    _close(table[3 * H * H: 4 * H * H].reshape(H, H), jl.W_cm, rtol=0, atol=0)
    z = torch.tensor([-100.0, -3.0, 0.0, 2.5, 90.0])
    _close(sigmoid(z), jax.nn.sigmoid(jnp.asarray(z.numpy())))


def _npz(I, H, head_sizes, prefix="", seed=0):
    """An npz dict in the reference's layout (PyTorch's (i, f, g, o) chunks,
    two bias vectors, the head's dynamics_W/b keys, the initial state)."""
    rng = np.random.default_rng(seed)
    d = {f"{prefix}lstm/weight_hh_l0": rng.normal(size=(4 * H, H)),
         f"{prefix}lstm/weight_ih_l0": rng.normal(size=(4 * H, I)),
         f"{prefix}lstm/bias_hh_l0": rng.normal(size=(4 * H,)),
         f"{prefix}lstm/bias_ih_l0": rng.normal(size=(4 * H,)),
         f"{prefix}hidden_state": rng.normal(size=(H,)),
         f"{prefix}cell_state": rng.normal(size=(H,))}
    sizes = [H + I] + list(head_sizes)
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]), start=1):
        d[f"{prefix}output/dynamics_W{i}"] = rng.normal(size=(b, a))
        d[f"{prefix}output/dynamics_b{i}"] = rng.normal(size=(b,))
    return {k: v.astype(np.float32) for k, v in d.items()}


@pytest.mark.parametrize("prefix,given", [("", ""), ("model/", ""), ("model/net/", "net")])
def test_lstm_from_npz_matches_jax(prefix, given):
    npz = _npz(3, 6, [5, 2], prefix)
    jl, tl = JLSTM.from_npz(npz, given), LSTM.from_npz(npz, given)
    for n in convert.LSTM_FIELDS + ("initial_hidden", "initial_cell"):
        _close(getattr(tl, n), getattr(jl, n), rtol=0, atol=0, what=n)
    assert tl.output_nn.layers == (9, 5, 2)
    h, c = (np.asarray(v) for v in jl.init_hidden_cell())
    th, tc = tl.init_hidden_cell()
    _close(th, h, rtol=0, atol=0)
    _close(tc, c, rtol=0, atol=0)


def test_lstm_create_and_errors():
    tl = LSTM.create(4, 16, [20, 16, 1], seed=3)
    assert tl.output_nn.layers == (20, 16, 1)
    assert float(tl.W_fm.abs().max()) > 0 and float(tl.b_i.abs().max()) == 0
    assert float(LSTM.create(4, 16, [20, 16, 1]).packed.abs().max()) == 0
    with pytest.raises(ValueError, match="H \\+ I"):
        LSTM.create(4, 16, [19, 1], seed=0)


@pytest.mark.parametrize("init_len", [1, 3, 5])
def test_lstm_lstm_initialize_matches_jax(init_len):
    init_npz = _npz(6, 12, [10, 16], seed=1)
    pred_npz = _npz(4, 8, [7, 1], seed=2)
    jll = JLSTMLSTM.from_npz(init_npz, pred_npz, init_len=init_len)
    tll = LSTMLSTM.from_npz(init_npz, pred_npz, init_len=init_len)
    buf = np.random.default_rng(3).normal(size=(6, 6)).astype(np.float32)
    jh, jc = jll.initialize(jnp.asarray(buf))
    th, tc = tll.initialize(torch.from_numpy(buf))
    _close(th, jh, 1e-5, 1e-5)
    _close(tc, jc, 1e-5, 1e-5)
    with pytest.raises(ValueError, match="buffer has"):
        LSTMLSTM.from_npz(init_npz, pred_npz, init_len=9).initialize(torch.from_numpy(buf))
    with pytest.raises(ValueError, match="h0; c0"):
        LSTMLSTM.from_npz(pred_npz, pred_npz)
