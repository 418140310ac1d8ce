"""Fully-connected network with tanh hidden layers, in PyTorch.

Counterpart of ``mppi_generic_tpu/nn/fnn.py`` (the reference's
``utils/nn_helpers/fnn_helper``): weights row-major (out, in), layers read
from npz keys ``{prefix}dynamics_W{i}`` / ``{prefix}dynamics_b{i}``
(1-indexed), forward x <- W x + b with tanh on every layer but the last.

The parameters live in one packed float32 buffer ``packed`` in the order
W1, b1, W2, b2, ..., which is also the table the CUDA kernels stage into
shared memory (``csrc/fnn.cuh``); ``weights`` and ``biases`` are views of
it.

Two orders of summation:

* ``forward`` / ``forward_axis0`` are the eager model: ``torch.matmul``, as
  the JAX package leaves ``jnp.dot`` to XLA on its combined path.
* ``forward_axis0_plain`` is the kernels' order, the plain version of
  ``fnn_forward`` in ``csrc/fnn.cuh``: each output unit sums its inputs
  left to right, then adds the bias, then applies tanh. It accumulates all
  output units at once (``acc + W[:, j:j+1] * h[j]``), so a step is about
  two operations per input of each layer, not one per weight.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn


class FNN(nn.Module):
    def __init__(self, weights, biases, device="cpu"):
        super().__init__()
        ws = [np.asarray(w, np.float32) for w in weights]
        bs = [np.asarray(b, np.float32).reshape(-1) for b in biases]
        if not ws or len(ws) != len(bs):
            raise ValueError("an FNN needs one bias per weight matrix")
        sizes = [ws[0].shape[1]]
        for w, b in zip(ws, bs):
            if w.ndim != 2 or w.shape[1] != sizes[-1] or w.shape[0] != b.shape[0]:
                raise ValueError(f"layer shapes do not chain: {[a.shape for a in ws]}")
            sizes.append(w.shape[0])
        self.layers = tuple(int(n) for n in sizes)
        flat = np.concatenate([a.reshape(-1) for wb in zip(ws, bs) for a in wb])
        self.register_buffer("packed", torch.tensor(flat, device=device))

    @classmethod
    def create(cls, layers: Sequence[int], seed=None, scale=0.1, device="cpu"):
        """Random (normal * ``scale``, from a numpy seed) or, without a
        seed, zero weights; zero biases."""
        rng = None if seed is None else np.random.default_rng(seed)
        ws, bs = [], []
        for n_in, n_out in zip(layers[:-1], layers[1:]):
            ws.append(np.zeros((n_out, n_in), np.float32) if rng is None
                      else (scale * rng.normal(size=(n_out, n_in))).astype(np.float32))
            bs.append(np.zeros((n_out,), np.float32))
        return cls(ws, bs, device=device)

    @classmethod
    def from_npz(cls, npz, prefix: str = "", device="cpu"):
        """Load from an npz mapping (dict-like or ``np.load`` result) with
        the reference's key convention."""
        if prefix and not prefix.endswith("/") and not prefix.endswith("_"):
            prefix = prefix + "/"
        ws, bs = [], []
        i = 1
        while f"{prefix}dynamics_W{i}" in npz:
            b = np.asarray(npz[f"{prefix}dynamics_b{i}"], np.float32).reshape(-1)
            w = np.asarray(npz[f"{prefix}dynamics_W{i}"], np.float32)
            ws.append(w.reshape(b.shape[0], -1))
            bs.append(b)
            i += 1
        if not ws:
            raise KeyError(f"no '{prefix}dynamics_W1' in npz keys {list(npz.keys())[:10]}")
        return cls(ws, bs, device=device)

    @property
    def input_dim(self) -> int:
        return self.layers[0]

    @property
    def output_dim(self) -> int:
        return self.layers[-1]

    def _views(self):
        out, off = [], 0
        for n_in, n_out in zip(self.layers[:-1], self.layers[1:]):
            w = self.packed[off: off + n_out * n_in].view(n_out, n_in)
            off += n_out * n_in
            out.append((w, self.packed[off: off + n_out]))
            off += n_out
        return out

    @property
    def weights(self):
        return tuple(w for w, _ in self._views())

    @property
    def biases(self):
        return tuple(b for _, b in self._views())

    def forward(self, x):
        """(..., in) -> (..., out)."""
        views = self._views()
        for i, (w, b) in enumerate(views):
            x = torch.matmul(x, w.T) + b
            if i < len(views) - 1:
                x = torch.tanh(x)
        return x

    def forward_axis0(self, x):
        """(in, *batch) -> (out, *batch): the component-first twin of
        ``forward`` for the models' structure-of-arrays convention."""
        batch = x.shape[1:]
        h = x.reshape(x.shape[0], -1)
        views = self._views()
        for i, (w, b) in enumerate(views):
            h = torch.matmul(w, h) + b[:, None]
            if i < len(views) - 1:
                h = torch.tanh(h)
        return h.reshape((h.shape[0],) + batch)

    def forward_axis0_plain(self, x):
        """``forward_axis0`` in the kernels' order of operations (see the
        module docstring)."""
        batch = x.shape[1:]
        h = x.reshape(x.shape[0], -1)
        views = self._views()
        for i, (w, b) in enumerate(views):
            acc = torch.zeros((w.shape[0], h.shape[1]), dtype=h.dtype, device=h.device)
            for j in range(w.shape[1]):
                acc = acc + w[:, j: j + 1] * h[j: j + 1]
            h = acc + b[:, None]
            if i < len(views) - 1:
                h = torch.tanh(h)
        return h.reshape((h.shape[0],) + batch)
