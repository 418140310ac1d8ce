"""Math utilities used by the ported controllers, in PyTorch.

Counterpart of ``mppi_generic_tpu/utils/math_utils.py``: the same functions,
with the same numerics, on tensors: the angle helpers, the polynomial atan
family, quaternions ([w, x, y, z], as the reference's Eigen::Quaternionf),
smoothing, the control-sequence services and numerical integration. The
CUDA kernels carry the operations the models and costs call in
``csrc/math_utils.cuh``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# Same 5-tap quadratic/cubic Savitzky-Golay kernel the reference hard-codes
# in controllers/controller.cuh:557-586 ([-3, 12, 17, 12, -3] / 35). A copy
# of the JAX package's constant, kept here so this package never imports it.
SG_FILTER_5 = np.array([-3.0, 12.0, 17.0, 12.0, -3.0], np.float32) / 35.0

# Python floats, as the JAX package writes them; each operation against a
# float32 tensor rounds them to float32 (pi 3.1415927, 2 pi 6.2831855,
# pi / 2 1.5707964), as the CUDA twins' literals in csrc/ do.
PI = math.pi
TWO_PI = 2.0 * math.pi
HALF_PI = math.pi / 2


def sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with sign(0) == 1 (the reference's mppi::math::sign)."""
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap an angle to [-pi, pi): mod(theta + pi, 2 pi) - pi, with the
    floored modulo of ``jnp.mod`` written out as ``fmod`` and its sign fix,
    the operations of the kernels' ``normalize_angle`` (csrc/autorally_nn.cuh)."""
    a = theta + PI
    m = torch.fmod(a, TWO_PI)
    m = torch.where(m < 0, m + TWO_PI, m)
    return m - PI


def angle_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Shortest signed difference a - b wrapped to [-pi, pi)."""
    return normalize_angle(a - b)


def interp_angle(a: torch.Tensor, b: torch.Tensor, alpha) -> torch.Tensor:
    """Interpolate between two angles along the shortest arc."""
    return normalize_angle(a + alpha * angle_diff(b, a))


def atan_approx(z: torch.Tensor) -> torch.Tensor:
    """Minimax odd-polynomial atan on |z| <= 1 (~1e-5 rad max error): the
    JAX package's polynomial, ported exactly because models call it."""
    s = z * z
    return z * (0.9998660
                + s * (-0.3302995
                       + s * (0.180141
                              + s * (-0.085133 + 0.0208351 * s))))


def atan2_approx(y: torch.Tensor, x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """atan2 from ``atan_approx`` with octant reduction; the quadrant
    semantics of atan2 for nonzero inputs."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    r = atan_approx(lo / torch.clamp_min(hi, eps))
    r = torch.where(ay > ax, HALF_PI - r, r)
    r = torch.where(x < 0, PI - r, r)
    return torch.where(y < 0, -r, r)


def atan_full_approx(x: torch.Tensor) -> torch.Tensor:
    """Full-range atan via |x| > 1 inversion + ``atan_approx`` (~1e-5 rad)."""
    ax = torch.abs(x)
    inv = ax > 1.0
    z = torch.where(inv, 1.0 / torch.clamp_min(ax, 1e-30), ax)
    r = atan_approx(z)
    r = torch.where(inv, HALF_PI - r, r)
    return torch.where(x < 0, -r, r)


def asin_approx(x: torch.Tensor) -> torch.Tensor:
    """arcsin via atan2_approx(x, sqrt(1 - x^2)) on the clipped domain."""
    x = torch.clamp(x, -1.0, 1.0)
    return atan2_approx(x, torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0)))


def true_div(x: torch.Tensor, v) -> torch.Tensor:
    """``x / v`` for a host number ``v``, rounded as one IEEE division.

    On CUDA, PyTorch divides a tensor by a host scalar as a multiply by its
    reciprocal, which can differ in the last bit from a division (JAX and
    the CUDA kernels divide); a device scalar is divided by. On the CPU both
    forms divide, so CPU results do not change."""
    return x / x.new_full((), v)


def discount_pow(base: torch.Tensor, t) -> torch.Tensor:
    """``base ** t`` for a positive discount factor, as exp(t * log(base)).

    Ported exactly rather than as ``pow``: a discount of 1 gives exactly 1,
    and the CUDA kernels compute the same expf(t * logf(base)).
    """
    return torch.exp(t * torch.log(base))


# ---------------------------------------------------------------------------
# Quaternions, stored [w, x, y, z]; inputs shaped (..., 4)
# ---------------------------------------------------------------------------
def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 (x) q2."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    return quat_conjugate(q) / torch.clamp_min(
        torch.sum(q * q, dim=-1, keepdim=True), 1e-12)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit quaternion with w >= 0, the sign convention of the reference's
    state-space quaternions."""
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), eps)
    return q * sign(q[..., 0:1])


def quat_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) body-to-world rotation."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    return torch.einsum("...ij,...j->...i", quat_to_rotation_matrix(q), v)


def quat_derivative(q: torch.Tensor, omega_body: torch.Tensor) -> torch.Tensor:
    """dq/dt = 0.5 q (x) [0, omega] for a body-frame angular rate omega."""
    omega_q = torch.cat([torch.zeros_like(omega_body[..., :1]), omega_body], dim=-1)
    return 0.5 * quat_multiply(q, omega_q)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, alpha, eps: float = 1e-8):
    """Spherical linear interpolation between unit quaternions."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < eps
    safe = torch.where(use_lerp, 1.0, sin_theta)
    w0 = torch.where(use_lerp, 1.0 - alpha, torch.sin((1.0 - alpha) * theta) / safe)
    w1 = torch.where(use_lerp, alpha, torch.sin(alpha * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


def euler_to_quat(roll, pitch, yaw) -> torch.Tensor:
    """Z-Y-X Euler angles -> quaternion (..., 4)."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def quat_to_euler(q: torch.Tensor):
    """Quaternion -> (roll, pitch, yaw), with the exact atan2 / asin."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


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
    return torch.einsum("w,wtc->tc", _sg_filter(u_seq.device), windows)


@functools.lru_cache(maxsize=None)
def _sg_filter(device: torch.device) -> torch.Tensor:
    """SG_FILTER_5 on ``device``, copied there once: a copy from the host
    in every solve would make the solve wait for the device."""
    return torch.as_tensor(SG_FILTER_5, device=device)


def update_control_history(history: torch.Tensor, u_seq: torch.Tensor,
                           stride: int) -> torch.Tensor:
    """2-step executed-control history update before a slide
    (saveControlHistoryHelper, controller.cuh:524-544): stride >= 2 takes
    the last two consumed controls [u[stride-2], u[stride-1]]; stride == 1
    shifts [history[1], u[0]]; stride == 0 leaves the history unchanged.
    ``stride`` is a host integer or a 0-d integer tensor on the sequence's
    device (RMPPI's nominal stride, chosen on the device): the tensor path
    gathers with clamped indices and selects, so it never waits on the
    device."""
    T = u_seq.shape[0]
    if isinstance(stride, torch.Tensor):
        idx = torch.stack([stride - 2, stride - 1]).clamp(0, T - 1)
        two_plus = u_seq.index_select(0, idx)
        one = torch.stack([history[1], u_seq[0]])
        return torch.where(stride >= 2, two_plus,
                           torch.where(stride == 1, one, history))
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
    controller.cuh:588-600). ``stride`` is a host integer or a 0-d integer
    tensor on the sequence's device; either way the shift is a gather with
    clamped indices.
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


# ---------------------------------------------------------------------------
# Numerical integration (reference utils/numerical_integration.h)
# ---------------------------------------------------------------------------
def rk4_step(f, x, u, dt, *args):
    """Classic RK4 step of dx/dt = f(x, u, *args)."""
    k1 = f(x, u, *args)
    k2 = f(x + 0.5 * dt * k1, u, *args)
    k3 = f(x + 0.5 * dt * k2, u, *args)
    k4 = f(x + dt * k3, u, *args)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def linear_interp(t, t0, v0, t1, v1):
    """Linear interpolation from (t0, v0) to (t1, v1), clamped to [0, 1] in
    alpha and guarded against t1 == t0; tensor arguments."""
    denom = torch.where(torch.abs(t1 - t0) < 1e-12, 1.0, t1 - t0)
    alpha = torch.clamp((t - t0) / denom, 0.0, 1.0)
    return v0 + alpha * (v1 - v0)
