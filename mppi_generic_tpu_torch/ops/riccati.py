"""DDP backward Riccati recursion and line-search ladder: kernels, wrappers
and plain versions.

Counterpart of ``mppi_generic_tpu/ops/pallas_riccati.py``: the hand-written
Hopper kernels of ``csrc/riccati_kernels.cuh`` (entries in ``csrc/riccati.cu``)
replace its two TPU kernels.

* ``riccati_backward`` (``_riccati_call``): the backward recursion of an
  iLQR iteration (ddp/ddp.h:54-170, plain Newton step), solving each step's
  (C, C) system by unrolled Gauss elimination. Returns the gains
  Ks (T, C, S) and feedforward terms ks (T, C), step T-1 zeroed.
* ``riccati_ladder_solve`` (``_ladder_call``): the same recursion, then the
  forward pass of every line-search step alpha at once,
  u = clamp(us + alpha k + K (x - xs)), x <- x + f(x, u) dt with the model
  inside the kernel (its parameters staged in shared memory), each scored
  with the tracking cost.

The backward kernel has entries for (S, C) = (4, 2), (4, 1) and (7, 2) (the
double integrator's, the cartpole's and AutoRally's sizes), the ladder for
the double integrator, the cartpole, the Dubins car and AutoRally's network
dynamics. The ladder steps x + f(x, u) dt with the model's derivative, as
the TPU kernel does (pallas_riccati.py:263-264): it does not wrap the Dubins
car's yaw, which the model's own step does. The
ladder runs its recursion spread over a warp and, for AutoRally, one warp
per line-search step (``riccati_ladder_warp_kernel``); the backward kernel
runs the same recursion over the one warp of its block
(``riccati_backward_warp_kernel``).

Each wrapper runs the kernel for CUDA tensors and the plain PyTorch version
(``*_plain``, in this module) for CPU tensors; the plain versions follow the
TPU kernel's unrolled loops term by term (``_backward_pass_into``,
``_solve_gauss``; the ladder's model through ``Dynamics.kernel_state_deriv``),
so they agree with the kernels bit for bit. There is no fallback: sizes
outside ``supported`` raise on every device (``feedback/ilqr.py`` chooses
the eager scan for them, as the JAX package does), and a CUDA call without a
compiled kernel for its sizes or dynamics raises. Every launch adds one to
``launch_counts`` under the kernel's name (and to ``entry_counts`` under its
C entry), the one its build reports (``ladder_kernel_name``,
``backward_kernel_name``).
"""

from __future__ import annotations

import functools

import torch

from mppi_generic_tpu_torch.models.autorally import AutorallyNNDynamics
from mppi_generic_tpu_torch.models.cartpole import CartpoleDynamics
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.models.dubins import DubinsDynamics
from mppi_generic_tpu_torch.ops import _build
from mppi_generic_tpu_torch.ops._build import launch_counts, reset_launch_counts
from mppi_generic_tpu_torch.ops.fused_rollout import (
    _check_status,
    _check_tensors,
    _f32,
    _on_cpu,
    _ptr,
)

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "riccati_backward",
    "riccati_ladder_solve",
    "supported",
]

# most line-search steps one ladder launch evaluates (kMaxAlphas in
# csrc/riccati_kernels.cuh)
MAX_ALPHAS = 128
_LIMIT = 1e30  # infinite control limits become +-1e30, as the TPU kernel has them

# (S, C) with a compiled backward kernel -> C entry point (csrc/riccati.cu)
_BACKWARD_ENTRY = {(4, 2): "riccati_backward_s4c2", (4, 1): "riccati_backward_s4c1",
                   (7, 2): "riccati_backward_s7c2"}
# dynamics with a compiled ladder kernel (its forward pass steps the model)
# -> C entry point (csrc/riccati.cu)
_LADDER_ENTRY = {DoubleIntegratorDynamics: "riccati_ladder_di",
                 CartpoleDynamics: "riccati_ladder_cartpole",
                 DubinsDynamics: "riccati_ladder_dubins",
                 AutorallyNNDynamics: "riccati_ladder_ar_nn"}


def supported(S: int, C: int, T: int) -> bool:
    """Sizes the kernels take (pallas_riccati.supported)."""
    return S <= 8 and C <= 4 and T <= 1024


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def _ordered_sum(terms):
    """t0 + t1 + ... left to right: the order of the kernel's unrolled sums."""
    terms = iter(terms)
    acc = next(terms)
    for t in terms:
        acc = acc + t
    return acc


def _solve_gauss(M, rhs):
    """Solve M X = rhs for M (C, C) (SPD after regularization, so no
    pivoting) and rhs (C, n) by unrolled Gauss elimination and
    back-substitution, in the operation order of the TPU kernel's
    ``_solve_gauss``. Elimination updates whole rows; the entries it adds
    to (left of the pivot) are never read again."""
    C = M.shape[0]
    M = list(M.unbind(0))
    rhs = list(rhs.unbind(0))
    for p in range(C):
        inv_p = 1.0 / M[p][p]
        for r in range(p + 1, C):
            f = M[r][p] * inv_p
            M[r] = M[r] - f * M[p]
            rhs[r] = rhs[r] - f * rhs[p]
    xs = [None] * C
    for r in range(C - 1, -1, -1):
        acc = rhs[r]
        for c in range(r + 1, C):
            acc = acc - M[r][c] * xs[c]
        xs[r] = acc / M[r][r]
    return torch.stack(xs)


def riccati_backward_plain(As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T, dt, reg):
    """Plain version of the backward kernel: (Ks (T, C, S), ks (T, C)).
    ``Qdt`` and ``Rdt`` are Q * dt and R * dt. Every entry is formed with
    the operations of ``_backward_pass_into`` in its order; the tensor ops
    vectorize over matrix entries only, never over a sum."""
    T, S, C = As.shape[0], As.shape[1], Bs.shape[2]
    dev = As.device
    Ks = torch.zeros((T, C, S), dtype=torch.float32, device=dev)
    ks = torch.zeros((T, C), dtype=torch.float32, device=dev)
    Vx, Vxx = Vx_T, Vxx_T
    reg_eye = _f32(reg) * torch.eye(C, dtype=torch.float32, device=dev)
    for t in range(T - 2, -1, -1):
        A, B = As[t], Bs[t]
        VA = _ordered_sum(Vxx[:, k:k + 1] * A[k:k + 1] for k in range(S))
        VB = _ordered_sum(Vxx[:, k:k + 1] * B[k:k + 1] for k in range(S))
        qx = dLx[t] * dt + _ordered_sum(A[k] * Vx[k] for k in range(S))
        qu = dLu[t] * dt + _ordered_sum(B[k] * Vx[k] for k in range(S))
        qxx = Qdt + _ordered_sum(A[k][:, None] * VA[k][None] for k in range(S))
        qux = _ordered_sum(B[k][:, None] * VA[k][None] for k in range(S))
        quu = (Rdt + _ordered_sum(B[k][:, None] * VB[k][None] for k in range(S))
               + reg_eye)
        sol = _solve_gauss(quu, torch.cat([qux, qu[:, None]], dim=1))
        Kk, kk = -sol[:, :S], -sol[:, S]
        Ks[t], ks[t] = Kk, kk
        Vxx_n = qxx + _ordered_sum(qux[k][:, None] * Kk[k][None] for k in range(C))
        Vxx = 0.5 * (Vxx_n + Vxx_n.T)
        Vx = qx + _ordered_sum(qux[k] * kk[k] for k in range(C))
    return Ks, ks


def ladder_forward_plain(dynamics, xs, us, Ks, ks, goal_x, goal_u, Q, R, Q_f,
                         alphas, ulim, dt):
    """Plain version of the ladder kernel's forward pass: per line-search
    step n, the trajectory from xs[0] under
    u = clamp(us + alphas[n] ks + Ks (x - xs)), x <- x +
    kernel_state_deriv(x, u) dt, and its tracking cost
    sum_t<T-1 (ex'Q ex + eu'R eu) dt + ex_T'Q_f ex_T. Returns
    (costs (n,), xs_new (n, T, S), us_new (n, T, C)); the states carry the
    lanes on their minor axis, as the model's methods expect."""
    T, S = xs.shape
    C = us.shape[1]
    n = alphas.shape[0]
    x = xs[0][:, None].expand(S, n)
    acc = None
    xo, uo = [], []
    for t in range(T):
        dx = [x[s] - xs[t, s] for s in range(S)]
        u = []
        for c in range(C):
            u_c = us[t, c] + alphas * ks[t, c]
            for s in range(S):
                u_c = u_c + Ks[t, c, s] * dx[s]
            u.append(torch.clamp(u_c, ulim[0, c], ulim[1, c]))
        if t < T - 1:
            ex = [x[s] - goal_x[t, s] for s in range(S)]
            eu = [u[c] - goal_u[t, c] for c in range(C)]
            rc = _ordered_sum(
                [Q[r, c2] * ex[r] * ex[c2] for r in range(S) for c2 in range(S)]
                + [R[r, c2] * eu[r] * eu[c2] for r in range(C) for c2 in range(C)])
            step = rc * dt
        else:
            ex = [x[s] - goal_x[T - 1, s] for s in range(S)]
            step = _ordered_sum(Q_f[r, c2] * ex[r] * ex[c2]
                                for r in range(S) for c2 in range(S))
        acc = step if acc is None else acc + step
        u = torch.stack(u)
        xo.append(x)
        uo.append(u)
        x = x + dynamics.kernel_state_deriv(x, u, float(t)) * dt
    return (acc, torch.stack(xo).permute(2, 0, 1), torch.stack(uo).permute(2, 0, 1))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("riccati")
    if lib.riccati_max_alphas() != MAX_ALPHAS:
        raise RuntimeError("csrc/riccati_kernels.cuh and MAX_ALPHAS disagree")
    return lib


def ladder_kernel_name():
    """The ladder kernel the loaded build launches, as it reports it
    (``riccati_ladder_form()``): ``riccati_ladder_warp_kernel``, the
    recursion spread over a warp, or the one-thread ``riccati_ladder_kernel``
    of a build with -DMPPI_LADDER_ONE_THREAD."""
    return "riccati_ladder_warp_kernel" if _lib().riccati_ladder_form() else "riccati_ladder_kernel"


def backward_kernel_name():
    """The backward kernel the loaded build launches, as it reports it
    (``riccati_backward_form()``): ``riccati_backward_warp_kernel``, the
    recursion spread over a warp, or the one-thread
    ``riccati_backward_kernel`` of a build with -DMPPI_BACKWARD_ONE_THREAD."""
    return ("riccati_backward_warp_kernel" if _lib().riccati_backward_form()
            else "riccati_backward_kernel")


def _check_sizes(As, Bs, dLx, dLu, Q, R, Vxx_T, Vx_T):
    T, S, C = As.shape[0], As.shape[1], Bs.shape[2]
    if not supported(S, C, T) or T < 2:
        raise ValueError(f"riccati kernels unsupported for S={S} C={C} T={T}")
    shapes = {"As": (As, (T, S, S)), "Bs": (Bs, (T, S, C)), "dLx": (dLx, (T, S)),
              "dLu": (dLu, (T, C)), "Q": (Q, (S, S)), "R": (R, (C, C)),
              "Vxx_T": (Vxx_T, (S, S)), "Vx_T": (Vx_T, (S,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return T, S, C


def riccati_backward(As, Bs, dLx, dLu, Q, R, Vxx_T, Vx_T, dt, reg=1e-6):
    """Backward Riccati recursion (ddp/ddp.h backward pass, plain Newton
    step). As (T, S, S) discrete state Jacobians, Bs (T, S, C) control
    Jacobians, dLx (T, S) / dLu (T, C) cost gradients (before dt), Q / R
    cost Hessians (before dt), terminal Vxx_T (S, S) and Vx_T (S,). Returns
    (Ks (T, C, S), ks (T, C)) with step T-1 zeroed."""
    T, S, C = _check_sizes(As, Bs, dLx, dLu, Q, R, Vxx_T, Vx_T)
    Qdt, Rdt = Q * _f32(dt), R * _f32(dt)
    # checked on every device, so that the CPU tests catch a caller the
    # kernel would refuse
    _check_tensors(dict(As=As, Bs=Bs, dLx=dLx, dLu=dLu, Qdt=Qdt, Rdt=Rdt,
                        Vxx_T=Vxx_T, Vx_T=Vx_T), As.device)
    if _on_cpu(As):
        return riccati_backward_plain(As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T,
                                      _f32(dt), reg)
    entry = _BACKWARD_ENTRY.get((S, C))
    if entry is None:
        raise NotImplementedError(f"no CUDA riccati_backward kernel for S={S}, C={C}")
    Ks = torch.empty((T, C, S), dtype=torch.float32, device=As.device)
    ks = torch.empty((T, C), dtype=torch.float32, device=As.device)
    status = getattr(_lib(), entry)(
        As.device.index, As.data_ptr(), Bs.data_ptr(), dLx.data_ptr(),
        dLu.data_ptr(), Qdt.data_ptr(), Rdt.data_ptr(), Vxx_T.data_ptr(),
        Vx_T.data_ptr(), T, _f32(dt), _f32(reg), Ks.data_ptr(), ks.data_ptr(),
        torch.cuda.current_stream(As.device).cuda_stream)
    name = backward_kernel_name()
    _check_status(status, name)
    _build.count_launch(name, entry)
    return Ks, ks


def riccati_ladder_solve(dynamics, xs, us, As, Bs, dLx, dLu, Q, R, Q_f, Vxx_T,
                         Vx_T, goal_x, goal_u, alphas, u_min, u_max, dt, reg=1e-6):
    """One iLQR iteration in one launch: the backward recursion, then the
    forward pass and tracking cost of every line-search step.

    Returns (Ks (T, C, S), ks (T, C), costs (n,), xs_new (n, T, S),
    us_new (n, T, C)): candidate n is the trajectory rolled from xs[0] with
    u = clamp(us + alphas[n] ks + Ks (x - xs)) to [u_min, u_max] (infinite
    limits become +-1e30), scored with sum_t<T-1 (ex'Q ex + eu'R eu) dt
    + ex_T'Q_f ex_T (ddp/ddp.h run() forward pass; the caller selects)."""
    T, S, C = _check_sizes(As, Bs, dLx, dLu, Q, R, Vxx_T, Vx_T)
    n = alphas.shape[0]
    if not 1 <= n <= MAX_ALPHAS:
        raise ValueError(f"the ladder takes 1 to {MAX_ALPHAS} alphas, got {n}")
    if (dynamics.STATE_DIM, dynamics.CONTROL_DIM) != (S, C):
        raise ValueError("the Jacobians do not match the dynamics")
    Qdt, Rdt = Q * _f32(dt), R * _f32(dt)
    ulim = torch.nan_to_num(torch.stack([u_min, u_max]), neginf=-_LIMIT,
                            posinf=_LIMIT)
    _check_tensors(dict(
        As=As, Bs=Bs, dLx=dLx, dLu=dLu, Qdt=Qdt, Rdt=Rdt, Vxx_T=Vxx_T, Vx_T=Vx_T,
        Q=Q, R=R, ulim=ulim, xs=(xs, (T, S)), us=(us, (T, C)),
        goal_x=(goal_x, (T, S)), goal_u=(goal_u, (T, C)), Q_f=(Q_f, (S, S)),
        alphas=(alphas, (n,))), As.device)
    if _on_cpu(As):
        Ks, ks = riccati_backward_plain(As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T,
                                        _f32(dt), reg)
        costs, xs_new, us_new = ladder_forward_plain(
            dynamics, xs, us, Ks, ks, goal_x, goal_u, Q, R, Q_f, alphas, ulim,
            _f32(dt))
        return Ks, ks, costs, xs_new, us_new
    entry = _LADDER_ENTRY.get(type(dynamics))
    if entry is None:
        raise NotImplementedError(
            f"no CUDA riccati ladder kernel for {type(dynamics).__name__}")
    dev = As.device
    dyn_p = dynamics.kernel_params()
    if dyn_p is not None:
        _check_tensors({"dynamics params": dyn_p}, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    Ks = torch.empty((T, C, S), **f32)
    ks = torch.empty((T, C), **f32)
    costs = torch.empty((n,), **f32)
    xs_new = torch.empty((n, T, S), **f32)
    us_new = torch.empty((n, T, C), **f32)
    status = getattr(_lib(), entry)(
        dev.index, As.data_ptr(), Bs.data_ptr(), dLx.data_ptr(), dLu.data_ptr(),
        Qdt.data_ptr(), Rdt.data_ptr(), Vxx_T.data_ptr(), Vx_T.data_ptr(),
        xs.data_ptr(), us.data_ptr(), goal_x.data_ptr(), goal_u.data_ptr(),
        Q.data_ptr(), R.data_ptr(), Q_f.data_ptr(), ulim.data_ptr(),
        alphas.data_ptr(), _ptr(dyn_p), n, T, _f32(dt), _f32(reg), Ks.data_ptr(),
        ks.data_ptr(), costs.data_ptr(), xs_new.data_ptr(), us_new.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    name = ladder_kernel_name()
    _check_status(status, name)
    _build.count_launch(name, entry)
    return Ks, ks, costs, xs_new, us_new
