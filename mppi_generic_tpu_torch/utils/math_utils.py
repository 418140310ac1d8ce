"""Math utilities used by the vanilla-MPPI path, in PyTorch.

Counterpart of ``mppi_generic_tpu/utils/math_utils.py``: the same functions,
with the same numerics, on tensors. Only what the ported path calls lives
here; the rest of the JAX module is still to be ported.
"""

from __future__ import annotations

import numpy as np
import torch

# Same 5-tap quadratic/cubic Savitzky-Golay kernel the reference hard-codes
# in controllers/controller.cuh:557-586 ([-3, 12, 17, 12, -3] / 35). A copy
# of the JAX package's constant, kept here so this package never imports it.
SG_FILTER_5 = np.array([-3.0, 12.0, 17.0, 12.0, -3.0], np.float32) / 35.0


def sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with sign(0) == 1 (the reference's mppi::math::sign)."""
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def discount_pow(base: torch.Tensor, t) -> torch.Tensor:
    """``base ** t`` for a positive discount factor, as exp(t * log(base)).

    Ported exactly rather than as ``pow``: a discount of 1 gives exactly 1,
    and the CUDA kernels compute the same expf(t * logf(base)).
    """
    return torch.exp(t * torch.log(base))


def savitzky_golay_smooth(u_seq: torch.Tensor, history=None) -> torch.Tensor:
    """Smooth a control sequence (T, C) with the 5-tap SG filter.

    ``history`` is the (2, C) most recent executed controls preceding the
    sequence; the tail is padded by repeating the final control, mirroring
    the reference's smoothControlTrajectoryHelper.
    """
    T = u_seq.shape[0]
    if history is None:
        history = u_seq[0:1].expand(2, -1)
    tail = u_seq[-1:].expand(2, -1)
    padded = torch.cat([history, u_seq, tail], dim=0)  # (T+4, C)
    windows = padded.unfold(0, T, 1).permute(0, 2, 1)  # (5, T, C)
    filt = torch.as_tensor(SG_FILTER_5, device=u_seq.device)
    return torch.einsum("w,wtc->tc", filt, windows)


def update_control_history(history: torch.Tensor, u_seq: torch.Tensor,
                           stride: int) -> torch.Tensor:
    """2-step executed-control history update before a slide
    (saveControlHistoryHelper, controller.cuh:524-544): stride >= 2 takes
    the last two consumed controls [u[stride-2], u[stride-1]]; stride == 1
    shifts [history[1], u[0]]; stride == 0 leaves the history unchanged.
    ``stride`` is a host integer."""
    T = u_seq.shape[0]
    if stride >= 2:
        idx0 = min(max(stride - 2, 0), T - 1)
        idx1 = min(max(stride - 1, 0), T - 1)
        return torch.stack([u_seq[idx0], u_seq[idx1]])
    if stride == 1:
        return torch.stack([history[1], u_seq[0]])
    return history


def slide_control_sequence(u_seq: torch.Tensor, stride: int,
                           slide_scale=None) -> torch.Tensor:
    """Shift the control sequence forward by ``stride`` steps.

    Vacated tail steps are filled with the last control scaled toward zero
    by ``slide_scale`` per channel (slideControlSequenceHelper,
    controller.cuh:588-600).
    """
    T, C = u_seq.shape
    idx = torch.arange(T, device=u_seq.device) + stride
    shifted = u_seq[idx.clamp(0, T - 1)]
    if slide_scale is None:
        slide_scale = torch.zeros((C,), dtype=u_seq.dtype, device=u_seq.device)
    over = (idx - (T - 1)).clamp_min(0).to(u_seq.dtype)[:, None]
    decay = torch.pow(slide_scale.expand(C)[None, :], over.clamp_max(30.0))
    decay = torch.where(over > 0, decay, 1.0)
    return shifted * decay
