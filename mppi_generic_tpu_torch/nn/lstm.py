"""Single-layer LSTM with an FNN output head, and the LSTM-LSTM warm start,
in PyTorch.

Counterpart of ``mppi_generic_tpu/nn/lstm.py`` (the reference's
``utils/nn_helpers/lstm_helper`` and ``lstm_lstm_helper``). Gate math
(lstm_helper.cu:267-306):

    g_i = sigma(W_im h + W_ii x + b_i)      g_f = sigma(W_fm h + W_fi x + b_f)
    g_o = sigma(W_om h + W_oi x + b_o)      g_c = tanh(W_cm h + W_ci x + b_c)
    c' = g_i g_c + g_f c ;  h' = g_o tanh(c')

and the output head is an FNN on [h'; x] (lstm_helper.cu:308-323). npz keys
``{prefix}lstm/weight_hh_l0`` etc. in PyTorch's (i, f, g, o) chunk order with
the ih and hh biases summed; a leading ``model/`` prefix is detected.

The gate parameters live in one packed float32 buffer ``packed``: W_m
(4, H, H), W_i (4, H, I) and b (4, H), each in the gate order (i, f, o, c)
of the JAX package's fields; ``W_im`` ... ``b_c`` are views of it.
``kernel_table`` appends the head's packed FNN: that is the table the CUDA
kernels stage into shared memory (``csrc/lstm.cuh``, B10).

Two orders of summation, as in ``nn/fnn.py``:

* ``step`` / ``forward`` / ``step_axis0`` / ``forward_axis0`` are the eager
  model: ``torch.matmul``, as the JAX package leaves ``jnp.dot`` to XLA;
* ``step_axis0_plain`` / ``forward_axis0_plain`` are the kernels' order, the
  plain version of ``csrc/lstm.cuh``: each gate sums W_m h left to right,
  then W_i x left to right, adds the two and then the bias, the order of
  JAX's ``(W_m h) + (W_i x) + b``; the head is ``FNN.forward_axis0_plain``.

The sigmoid is ``1 / (1 + exp(-z))`` everywhere (``sigmoid``), the kernels'
formula, not ``torch.sigmoid``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mppi_generic_tpu_torch.nn.fnn import FNN

GATES = ("i", "f", "o", "c")


def sigmoid(z: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-z)), one IEEE division, as csrc/lstm.cuh computes it."""
    return torch.reciprocal(1.0 + torch.exp(-z))


class LSTM(nn.Module):
    def __init__(self, W_im, W_fm, W_om, W_cm, W_ii, W_fi, W_oi, W_ci,
                 b_i, b_f, b_o, b_c, initial_hidden=None, initial_cell=None,
                 output_nn: Optional[FNN] = None, device="cpu"):
        super().__init__()

        def f32(v):
            return np.asarray(v, np.float32)

        wm = np.stack([f32(w) for w in (W_im, W_fm, W_om, W_cm)])
        wi = np.stack([f32(w) for w in (W_ii, W_fi, W_oi, W_ci)])
        b = np.stack([f32(v).reshape(-1) for v in (b_i, b_f, b_o, b_c)])
        H, I = wi.shape[1], wi.shape[2]
        if wm.shape != (4, H, H) or b.shape != (4, H):
            raise ValueError(f"gate shapes do not agree: W_m {wm.shape}, W_i {wi.shape}, "
                             f"b {b.shape}")
        if output_nn is not None and output_nn.input_dim != H + I:
            raise ValueError(f"the output head takes [h; x] ({H + I}), not "
                             f"{output_nn.input_dim}")
        self.hidden_dim, self.input_dim = int(H), int(I)
        flat = np.concatenate([wm.reshape(-1), wi.reshape(-1), b.reshape(-1)])
        zeros = np.zeros((H,), np.float32)
        self.register_buffer("packed", torch.tensor(flat, device=device))
        self.register_buffer("initial_hidden", torch.tensor(
            zeros if initial_hidden is None else f32(initial_hidden).reshape(H), device=device))
        self.register_buffer("initial_cell", torch.tensor(
            zeros if initial_cell is None else f32(initial_cell).reshape(H), device=device))
        self.output_nn = None if output_nn is None else output_nn.to(device)

    @classmethod
    def create(cls, input_dim, hidden_dim, output_layers: Sequence[int] | None = None,
               seed=None, scale=0.1, device="cpu"):
        """Random gate weights (normal * ``scale`` from a numpy ``seed``, zero
        without one), zero biases and initial state; the head ``FNN.create``
        of ``output_layers`` (its input [h; x])."""
        H, I = hidden_dim, input_dim
        rng = None if seed is None else np.random.default_rng(seed)

        def mk(shape):
            if rng is None:
                return np.zeros(shape, np.float32)
            return (scale * rng.normal(size=shape)).astype(np.float32)

        wm = [mk((H, H)) for _ in GATES]
        wi = [mk((H, I)) for _ in GATES]
        out = None
        if output_layers is not None:
            if output_layers[0] != H + I:
                raise ValueError("the output head's input must be H + I")
            out = FNN.create(output_layers, seed=None if rng is None
                             else int(rng.integers(2**31)), scale=scale)
        b = np.zeros((H,), np.float32)
        return cls(*wm, *wi, b, b, b, b, output_nn=out, device=device)

    @classmethod
    def from_npz(cls, npz, prefix: str = "", device="cpu"):
        """Load from the reference's npz layout (a leading ``model/`` is
        detected); the head from ``{prefix}output/``."""
        if prefix and not prefix.endswith("/") and not prefix.endswith("_"):
            prefix = prefix + "/"
        if f"model/{prefix}lstm/weight_hh_l0" in npz:
            prefix = "model/" + prefix

        def arr(key):
            return np.asarray(npz[prefix + key], np.float32)

        b_hh = arr("lstm/bias_hh_l0").reshape(-1)
        b = b_hh + arr("lstm/bias_ih_l0").reshape(-1)
        H = b_hh.shape[0] // 4
        w_hh = arr("lstm/weight_hh_l0").reshape(4 * H, H)
        w_ih = arr("lstm/weight_ih_l0").reshape(4 * H, -1)
        # PyTorch's chunk order (i, f, g = c, o) (lstm_helper.cu:549-585)
        i, f, c, o = (slice(k * H, (k + 1) * H) for k in range(4))
        kw = {}
        for name, key in (("initial_hidden", "hidden_state"), ("initial_cell", "cell_state")):
            if prefix + key in npz:
                kw[name] = arr(key).reshape(-1)
        return cls(w_hh[i], w_hh[f], w_hh[o], w_hh[c], w_ih[i], w_ih[f], w_ih[o], w_ih[c],
                   b[i], b[f], b[o], b[c], output_nn=FNN.from_npz(npz, prefix + "output/"),
                   device=device, **kw)

    # --- views of the packed gates (gate order i, f, o, c) ---------------
    def _gates(self):
        H, I = self.hidden_dim, self.input_dim
        wm = self.packed[: 4 * H * H].view(4 * H, H)
        wi = self.packed[4 * H * H: 4 * H * (H + I)].view(4 * H, I)
        return wm, wi, self.packed[4 * H * (H + I):]

    def __getattr__(self, name):
        if len(name) == 4 and name[:2] == "W_" and name[2] in GATES and name[3] in "mi":
            wm, wi, _ = self._gates()
            g, H = GATES.index(name[2]), self.hidden_dim
            return (wm if name[3] == "m" else wi)[g * H: (g + 1) * H]
        if len(name) == 3 and name[:2] == "b_" and name[2] in GATES:
            g, H = GATES.index(name[2]), self.hidden_dim
            return self._gates()[2][g * H: (g + 1) * H]
        return super().__getattr__(name)

    def kernel_table(self) -> torch.Tensor:
        """The table csrc/lstm.cuh reads: the packed gates, then the head's
        packed FNN (W1, b1, W2, b2)."""
        return torch.cat([self.packed, self.output_nn.packed])

    def init_hidden_cell(self):
        return self.initial_hidden, self.initial_cell

    # --- eager model ------------------------------------------------------
    @staticmethod
    def _cell(z, c, H):
        g_i, g_f, g_o = sigmoid(z[:H]), sigmoid(z[H: 2 * H]), sigmoid(z[2 * H: 3 * H])
        g_c = torch.tanh(z[3 * H:])
        c2 = g_i * g_c + g_f * c
        return g_o * torch.tanh(c2), c2

    def step(self, h, c, x):
        """One step; h, c (..., H), x (..., I). Returns (h', c')."""
        wm, wi, b = self._gates()
        z = torch.matmul(h, wm.T) + torch.matmul(x, wi.T) + b
        h2, c2 = self._cell(z.movedim(-1, 0), c.movedim(-1, 0), self.hidden_dim)
        return h2.movedim(0, -1), c2.movedim(0, -1)

    def forward(self, h, c, x):
        """Step + output head on [h'; x]: (output, h', c')."""
        h2, c2 = self.step(h, c, x)
        return self.output_nn.forward(torch.cat([h2, x], dim=-1)), h2, c2

    def step_axis0(self, h, c, x):
        """Component-first ``step``: h, c (H, *batch), x (I, *batch)."""
        wm, wi, b = self._gates()
        batch = h.shape[1:]
        hf, cf, xf = (a.reshape(a.shape[0], -1) for a in (h, c, x))
        z = torch.matmul(wm, hf) + torch.matmul(wi, xf) + b[:, None]
        h2, c2 = self._cell(z, cf, self.hidden_dim)
        H = self.hidden_dim
        return h2.reshape((H,) + batch), c2.reshape((H,) + batch)

    def forward_axis0(self, h, c, x):
        """Component-first ``forward``: (output (O, *batch), h', c')."""
        h2, c2 = self.step_axis0(h, c, x)
        return self.output_nn.forward_axis0(torch.cat([h2, x], dim=0)), h2, c2

    # --- the kernels' order -------------------------------------------------
    def step_axis0_plain(self, h, c, x):
        """``step_axis0`` in the kernels' order of operations (see the module
        docstring); all 4H gate rows accumulate at once."""
        wm, wi, b = self._gates()
        batch = h.shape[1:]
        hf, cf, xf = (a.reshape(a.shape[0], -1) for a in (h, c, x))
        zeros = torch.zeros((wm.shape[0], hf.shape[1]), dtype=hf.dtype, device=hf.device)
        acc_m = zeros
        for j in range(wm.shape[1]):
            acc_m = acc_m + wm[:, j: j + 1] * hf[j: j + 1]
        acc_i = zeros
        for j in range(wi.shape[1]):
            acc_i = acc_i + wi[:, j: j + 1] * xf[j: j + 1]
        h2, c2 = self._cell(acc_m + acc_i + b[:, None], cf, self.hidden_dim)
        H = self.hidden_dim
        return h2.reshape((H,) + batch), c2.reshape((H,) + batch)

    def forward_axis0_plain(self, h, c, x):
        """``forward_axis0`` in the kernels' order of operations."""
        h2, c2 = self.step_axis0_plain(h, c, x)
        return self.output_nn.forward_axis0_plain(torch.cat([h2, x], dim=0)), h2, c2


class LSTMLSTM(nn.Module):
    """An init LSTM over the sensor buffer warm-starts the prediction LSTM
    (lstm_lstm_helper.cuh:17-112): its head emits [h0; c0]."""

    def __init__(self, init_model: LSTM, pred_model: LSTM, init_len: int = 1):
        super().__init__()
        if init_model.output_nn.output_dim != 2 * pred_model.hidden_dim:
            raise ValueError("the init LSTM's head must emit [h0; c0] of the "
                             "prediction LSTM")
        self.init_model = init_model
        self.pred_model = pred_model
        self.init_len = int(init_len)

    @classmethod
    def from_npz(cls, init_npz, lstm_npz, init_len=None, init_prefix="", prefix="",
                 device="cpu"):
        return cls(LSTM.from_npz(init_npz, init_prefix, device=device),
                   LSTM.from_npz(lstm_npz, prefix, device=device),
                   init_len if init_len is not None else 1)

    def initialize(self, buffer):
        """The prediction LSTM's (h0, c0) from the init LSTM run over the last
        ``init_len`` rows of ``buffer`` (T_buf, I_init)
        (lstm_lstm_helper.cu:50-73)."""
        if buffer.shape[0] < self.init_len:
            raise ValueError(
                f"warm-start buffer has {buffer.shape[0]} rows but the init network "
                f"expects {self.init_len} (resample the sensor buffer to a fixed-dt "
                "window first, buffer.hpp getSmoothedBuffer)")
        window = buffer[-self.init_len:]
        h, c = self.init_model.init_hidden_cell()
        for row in window[:-1]:
            h, c = self.init_model.step(h, c, row)
        out, _, _ = self.init_model.forward(h, c, window[-1])
        H = self.pred_model.hidden_dim
        return out[:H], out[H:]
