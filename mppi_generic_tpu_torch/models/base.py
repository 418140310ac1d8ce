"""Dynamics base class, in PyTorch.

Counterpart of ``mppi_generic_tpu/models/base.py``. A model is an
``nn.Module`` whose parameters are buffers; its methods are pure functions
of tensors. The step contract mirrors the reference (dynamics.cuh:283-291):

    step(x, u, t, dt) = state_deriv -> Euler update -> state_to_output

Batching convention (docs/design.md section 3): methods index only axis 0
of the state, control and output tensors and otherwise broadcast, so the
same code serves one vector (S,) and a structure-of-arrays batch (S, K).
The CUDA kernels carry the same step as ``__host__ __device__`` functions
in ``csrc/``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from mppi_generic_tpu_torch.utils import math_utils


class Dynamics(nn.Module):
    """Base dynamics model.

    Subclasses define ``STATE_DIM`` / ``CONTROL_DIM`` / ``OUTPUT_DIM`` and
    implement ``state_deriv``. The control constraints (ranges, deadband,
    zero control) are buffers here, as in dynamics.cuh:250-264.
    """

    STATE_DIM = 0
    CONTROL_DIM = 0
    OUTPUT_DIM = 0

    def __init__(self, control_ranges=None, control_deadband=None,
                 zero_control=None, device="cpu"):
        super().__init__()
        for name, value in self._default_constraints(
                control_ranges, control_deadband, zero_control).items():
            self.register_buffer(name, torch.tensor(value, device=device))

    # --- core contract ---------------------------------------------------
    def state_deriv(self, x, u, t=0.0):
        """Continuous-time dx/dt, component-indexed on axis 0."""
        raise NotImplementedError

    def update_state(self, x, xdot, dt):
        """Explicit Euler (dynamics.cuh:276-281)."""
        return x + xdot * dt

    def state_to_output(self, x):
        """Output = the first OUTPUT_DIM state components."""
        if self.OUTPUT_DIM == self.STATE_DIM:
            return x
        return x[: self.OUTPUT_DIM]

    def step(self, x, u, t, dt):
        """One discrete step: returns (x_next, output)."""
        xdot = self.state_deriv(x, u, t)
        x_next = self.update_state(x, xdot, dt)
        return x_next, self.state_to_output(x_next)

    def kernel_step(self, x, u, t, dt):
        """``step`` in the CUDA kernels' order of operations, which the
        kernels' plain versions run. The same as ``step`` unless a model's
        eager step sums in another order (a network's matmul)."""
        return self.step(x, u, t, dt)

    def kernel_state_deriv(self, x, u, t=0.0):
        """``state_deriv`` in the CUDA kernels' order of operations, which
        the DDP ladder's plain version steps with. The same as
        ``state_deriv`` unless a model's eager derivative sums in another
        order (a network's matmul)."""
        return self.state_deriv(x, u, t)

    def kernel_params(self):
        """The float32 table the kernels stage for this model's step, or
        None for a model without one. Called only on the CUDA path; raises
        for parameters the compiled kernels do not take."""
        return None

    def kernel_map(self):
        """The map data the kernels' step reads (the racer models' elevation
        map), or None; its description is in ``kernel_params``."""
        return None

    # --- recurrent models (an LSTM in the rollout) ------------------------
    # The reference keeps each rollout's LSTM hidden and cell state in the
    # kernel's shared memory (lstm_helper.cuh:130-133); here it is a tuple of
    # (H,) tensors carried beside the state (None for a stateless model),
    # broadcast to (H, K) for a batch of samples (``broadcast_rec``).
    def init_recurrent_state(self):
        return None

    def step_recurrent(self, x, rec, u, t, dt):
        """One step of a recurrent model: (x_next, output, rec_next). The
        default is the stateless step."""
        x_next, y = self.step(x, u, t, dt)
        return x_next, y, rec

    def kernel_step_recurrent(self, x, rec, u, t, dt):
        """``step_recurrent`` in the CUDA kernels' order of operations."""
        x_next, y = self.kernel_step(x, u, t, dt)
        return x_next, y, rec

    @classmethod
    def _default_constraints(cls, control_ranges=None, control_deadband=None,
                             zero_control=None):
        """The constraint buffers as float32 numpy arrays: (C, 2) ranges,
        (C,) deadband and zero control; unbounded ranges, no deadband and a
        zero control where not given, as the JAX package's defaults
        (models/base.py:53)."""
        C = cls.CONTROL_DIM
        if control_ranges is None:
            control_ranges = [[-np.inf, np.inf]] * C
        if control_deadband is None:
            control_deadband = [0.0] * C
        if zero_control is None:
            zero_control = [0.0] * C
        return dict(
            control_ranges=np.asarray(control_ranges, np.float32).reshape(C, 2),
            control_deadband=np.asarray(control_deadband, np.float32).reshape(C),
            zero_control=np.asarray(zero_control, np.float32).reshape(C))

    def enforce_constraints(self, x, u):
        """Deadband snap-to-zero-control, deadband shrink, then clamp
        (dynamics.cuh:250-264). ``u`` is (C, ...)."""
        del x
        db = self._bcast(self.control_deadband, u)
        zc = self._bcast(self.zero_control, u)
        lo = self._bcast(self.control_ranges[:, 0], u)
        hi = self._bcast(self.control_ranges[:, 1], u)
        shrunk = u - db * math_utils.sign(u)
        u = torch.where(torch.abs(u) < db, zc, shrunk)
        return torch.clamp(u, lo, hi)

    @staticmethod
    def _bcast(param, like):
        """Broadcast a (C,) parameter against a control of shape (C, ...)."""
        return param.reshape(param.shape + (1,) * (like.dim() - 1))

    def get_stopping_control(self, x):
        """The control that brings the platform to a stop
        (dynamics.cuh:437-443): the zero control."""
        del x
        return self.zero_control

    def state_jacobian(self, x, u):
        """(A, B): the continuous-time Jacobians df/dx (S, S) and df/du
        (S, C) at one state x (S,) and control u (C,), by forward-mode AD
        (the JAX package's jax.jacfwd, which replaces the reference's
        hand-derived computeGrad)."""
        A = torch.func.jacfwd(lambda s: self.state_deriv(s, u))(x)
        B = torch.func.jacfwd(lambda c: self.state_deriv(x, c))(u)
        return A, B

    def enforce_leash(self, state_true, state_nominal, leash):
        """The nominal state clamped to within the per-dimension ``leash``
        of the true state (dynamics.cuh:448-466; ColoredMPPI's state
        leash)."""
        diff = state_nominal - state_true
        return state_true + torch.clamp(diff, -leash, leash)


class PackedParamsDynamics(Dynamics):
    """A model whose named float parameters (``PARAMS``: (name, default)
    pairs, a default may be a tuple) are packed into one float32 buffer
    ``params``, followed by the brake limit -control_ranges[0, 0] (the
    table its CUDA step stages); each name reads as a view of its slot, a
    0-d one for a scalar default (a device scalar: a division by it is one
    IEEE division on CUDA). The control ranges default to [-1, 1] for the
    two controls of the car models."""

    PARAMS = ()

    def __init__(self, control_ranges=None, control_deadband=None, zero_control=None,
                 device="cpu", **params):
        if control_ranges is None:
            control_ranges = [[-1.0, 1.0], [-1.0, 1.0]]
        super().__init__(control_ranges, control_deadband, zero_control, device=device)
        names = tuple(name for name, _ in self.PARAMS)
        unknown = set(params) - set(names)
        if unknown:
            raise TypeError(f"unknown {type(self).__name__} parameters {sorted(unknown)}")
        values, self._slots = [], {}
        for name, default in self.PARAMS:
            v = np.asarray(params.get(name, default), np.float32).reshape(-1)
            self._slots[name] = (len(values), len(v) if np.ndim(default) else 0)
            values.extend(v.tolist())
        brake_max = -np.asarray(control_ranges, np.float32).reshape(2, 2)[0, 0]
        self.register_buffer("params", torch.tensor(
            np.asarray(values + [brake_max], np.float32), device=device))

    @classmethod
    def create(cls, control_ranges=None, device="cpu", **params):
        return cls(control_ranges, device=device, **params)

    @classmethod
    def param_names(cls):
        return tuple(name for name, _ in cls.PARAMS)

    def __getattr__(self, name):
        slots = self.__dict__.get("_slots")
        if slots is not None and name in slots:
            i, n = slots[name]
            return self.params[i] if n == 0 else self.params[i:i + n]
        return super().__getattr__(name)

    @property
    def brake_max(self):
        return self.params[-1]

    def _kernel_table(self):
        """The float32 table the model's CUDA step stages: ``params``, then
        the description of its elevation map (``map_meta``) for a model that
        reads one; a model whose step reads more (networks) adds it."""
        meta = getattr(self, "map_meta", None)
        return self.params if meta is None else torch.cat([self.params, meta])

    def kernel_map(self):
        emap = getattr(self, "elevation_map", None)
        return None if emap is None else emap.data

    def kernel_params(self):
        """``_kernel_table()``, built once per device from the model's
        buffers (``update_from_buffer`` drops it)."""
        table = self.__dict__.get("_table")
        if table is None or table.device != self.params.device:
            table = self.__dict__["_table"] = self._kernel_table()
        return table


def broadcast_rec(rec, K):
    """A recurrent state of (H,) leaves as (H, K) blocks, one column per
    sample (None stays None)."""
    if rec is None:
        return None
    return tuple(r[:, None].expand(-1, K) for r in rec)


def rollout_single(dynamics: Dynamics, x0, U, dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Roll one control sequence (T, C) from x0; returns (states (T+1, S),
    outputs (T, O)). The analog of computeStateTrajectoryHelper. A recurrent
    model's state starts from ``init_recurrent_state`` and rides along.

    The JAX version clamps each control inside its scan; the clamp does not
    depend on the state, so here it runs once over the whole sequence.
    """
    U = dynamics.enforce_constraints(None, U.T).T
    x, rec = x0, dynamics.init_recurrent_state()
    states, outputs = [x0], []
    for t in range(U.shape[0]):
        x, y, rec = dynamics.step_recurrent(x, rec, U[t], float(t), dt)
        states.append(x)
        outputs.append(y)
    return torch.stack(states), torch.stack(outputs)
