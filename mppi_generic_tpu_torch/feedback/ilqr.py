"""iLQR/DDP trajectory-tracking feedback, in PyTorch.

Counterpart of ``mppi_generic_tpu/feedback/ilqr.py`` (the reference's Eigen
DDP solver, ddp/ddp.h:54-170, and its DDPFeedback wrapper,
feedback_controllers/DDP/ddp.{cuh,cu}), with the same semantics:

* discrete model x' = x + f(x, u) dt; A_t = I + df/dx dt, B_t = df/du dt,
  the Jacobians by forward-mode AD (``torch.func.jvp``) over
  ``dynamics.state_deriv``;
* tracking cost (x - x*)' Q (x - x*) + (u - u*)' R (u - u*) with gradient
  Q (x - x*) (Q absorbs the factor 2, ddp_tracking_costs.h:37-53) and the
  terminal cost through Q_f;
* a Tikhonov-regularized Newton step in the backward pass, or with
  ``use_boxqp`` the control-constrained step of ``feedback/boxqp.py``
  (bounds relative to the step's control, ddp.h's backward pass with
  ddp/boxqp.h), as the JAX package's XLA scan takes it;
* the forward pass over a fixed ladder of 14 line-search steps
  alpha = 1, 1/2, ..., each clamped to the control ranges; the first
  (largest) alpha whose cost does not exceed the previous iteration's is
  taken (the first iteration takes alpha = 1), else the smallest.

``use_kernel=True`` (the JAX package's ``use_pallas``) runs each iteration
as one call of ``ops.riccati.riccati_ladder_solve`` where the sizes are
within ``ops.riccati.supported`` (S <= 8, C <= 4, T <= 1024): its CUDA
kernel for a CUDA tensor, its plain version for a CPU tensor. Other sizes
(the quadrotor's S = 13, the racer models') and BoxQP take the eager scan,
as the JAX package takes its XLA scan there (ilqr.py:191-197); the choice is by
size alone, so a supported size whose dynamics has no compiled ladder
entry still raises on CUDA. ``use_kernel=False`` is the eager scan with
``torch.linalg.solve`` (the JAX package's XLA path), kept as the oracle.
Nothing here waits on the device.

The gains K[t] (C, S) give u_fb = K[t] (x - x_goal), as the reference's
device k() (DDP/ddp.cu:11-45).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jvp, vmap

from mppi_generic_tpu_torch.feedback.base import FeedbackController
from mppi_generic_tpu_torch.feedback.boxqp import boxqp, boxqp_gains
from mppi_generic_tpu_torch.ops import riccati


@dataclasses.dataclass
class DDPFeedbackState:
    """fb_gain_traj_ analog (DDP/ddp.cuh:28-53): the (T, C, S) gain
    trajectory and the solver's trajectory outputs for diagnostics."""

    gains: torch.Tensor  # (T, C, S)
    x_traj: torch.Tensor  # (T, S)
    u_traj: torch.Tensor  # (T, C)
    total_cost: torch.Tensor  # ()


def _alpha_ladder(n=14, device=None):
    return torch.pow(0.5, torch.arange(n, dtype=torch.float32, device=device))


def linearize(dynamics, xs, us, goal_x, goal_u, Q, R, Q_f, dt):
    """The backward pass's inputs along (xs, us): discrete Jacobians
    As = I + df/dx dt (T, S, S) and Bs = df/du dt (T, S, C), cost gradients
    dLx = Q (x - x*) (T, S) and dLu = R (u - u*) (T, C), and the terminal
    value Vxx_T = (Q_f + Q_f') / 2, Vx_T = Q_f (x_T - x*_T)."""
    # The whole trajectory in one call, in the models' axis-0 layout: x (S, T),
    # each component a (T,) vector. (Under a vmap over time each component
    # would be 0-d, and torch.func's forward mode multiplies a 0-d tangent by
    # a Python float in float64: the cartpole's and quadrotor's Jacobians
    # came back float64.) One tangent per input component, batched by vmap.
    X, U = xs.T, us.T

    def columns(fn, primal):
        n, T = primal.shape
        basis = torch.eye(n, dtype=primal.dtype, device=primal.device)
        tangents = basis[:, :, None].expand(n, n, T)
        d = vmap(lambda tangent: jvp(fn, (primal,), (tangent,))[1])(tangents)
        return d.permute(2, 1, 0)  # (n, S, T) -> (T, S, n)

    eye_s = torch.eye(xs.shape[1], dtype=torch.float32, device=xs.device)
    # the kernels take contiguous tensors
    As = (columns(lambda x: dynamics.state_deriv(x, U), X) * float(dt) + eye_s).contiguous()
    Bs = (columns(lambda u: dynamics.state_deriv(X, u), U) * float(dt)).contiguous()
    dLx = (xs - goal_x) @ Q.T
    dLu = (us - goal_u) @ R.T
    Vxx_T = 0.5 * (Q_f + Q_f.T)
    Vx_T = Q_f @ (xs[-1] - goal_x[-1])
    return As, Bs, dLx, dLu, Vxx_T, Vx_T


def ilqr_tracking(dynamics, x0, u_init, goal_x, goal_u, Q, R, Q_f, dt,
                  iterations: int = 1, u_min=None, u_max=None,
                  use_boxqp: bool = False, use_kernel: bool = True) -> DDPFeedbackState:
    """Run iLQR tracking. Shapes: x0 (S,), u_init (T, C), goal_x (T, S),
    goal_u (T, C). Returns a DDPFeedbackState with gains (T, C, S)."""
    T, C = u_init.shape
    S = x0.shape[0]
    dt = float(dt)
    if u_min is None:
        u_min = dynamics.control_ranges[:, 0]
    if u_max is None:
        u_max = dynamics.control_ranges[:, 1]
    # infinite ranges would break the clamping arithmetic
    u_min = torch.nan_to_num(u_min, neginf=-1e30)
    u_max = torch.nan_to_num(u_max, posinf=1e30)

    def f(x, u):
        return dynamics.state_deriv(x, u)

    def clamp(u):
        return torch.clamp(u, u_min, u_max)

    def forward_rollout(x, U):
        xs = []
        for t in range(T):
            xs.append(x)  # xs[t] is the state BEFORE U[t] (ddp.h x_ columns)
            x = x + f(x, clamp(U[t])) * dt
        return torch.stack(xs)

    def backward_pass(us, As, Bs, dLx, dLu, Vxx_T, Vx_T):
        Ks = torch.zeros((T, C, S), dtype=torch.float32, device=x0.device)
        ks = torch.zeros((T, C), dtype=torch.float32, device=x0.device)
        Vx, Vxx = Vx_T, Vxx_T
        reg = 1e-6 * torch.eye(C, dtype=torch.float32, device=x0.device)
        for t in range(T - 2, -1, -1):
            A, B = As[t], Bs[t]
            qx = dLx[t] * dt + A.T @ Vx
            qu = dLu[t] * dt + B.T @ Vx
            qux = B.T @ Vxx @ A
            qxx = Q * dt + A.T @ Vxx @ A
            quu = R * dt + B.T @ Vxx @ B + reg
            if use_boxqp:
                # the control-constrained QP on du, bounded relative to
                # the step's control (JAX ilqr.py:153-159)
                kk, free = boxqp(quu, qu, u_min - us[t], u_max - us[t])
                Kk = boxqp_gains(quu, qux, free)
            else:
                Kk = -torch.linalg.solve(quu, qux)
                kk = -torch.linalg.solve(quu, qu)
            Vxx = qxx + qux.T @ Kk
            Vxx = 0.5 * (Vxx + Vxx.T)
            Vx = qx + qux.T @ kk
            Ks[t], ks[t] = Kk, kk
        return Ks, ks

    def forward_pass(xs, us, Ks, ks, alphas):
        """Every alpha at once: returns (xs_new (n, T, S), us_new (n, T, C),
        costs (n,)) with the line-search cost sum_t<T-1 c_t dt + V_T."""
        x = xs[0].expand(alphas.shape[0], S)
        xo, uo = [], []
        for t in range(T):
            u = clamp(us[t] + alphas[:, None] * ks[t] + (x - xs[t]) @ Ks[t].T)
            xo.append(x)
            uo.append(u)
            x = x + f(x.T, u.T).T * dt
        xn, un = torch.stack(xo, dim=1), torch.stack(uo, dim=1)
        ex, eu = xn - goal_x, un - goal_u
        running = (torch.einsum("ntr,rc,ntc->nt", ex, Q, ex)
                   + torch.einsum("ntr,rc,ntc->nt", eu, R, eu))
        e_T = xn[:, -1] - goal_x[-1]
        terminal = torch.einsum("nr,rc,nc->n", e_T, Q_f, e_T)
        return xn, un, torch.sum(running[:, :-1], dim=1) * dt + terminal

    us = clamp(u_init)
    xs = forward_rollout(x0, us)
    prev_cost = torch.full((), float("inf"), dtype=torch.float32, device=x0.device)
    alphas = _alpha_ladder(device=x0.device)
    use_ladder = use_kernel and not use_boxqp and riccati.supported(S, C, T)
    gains = None
    for it in range(iterations):
        lin = linearize(dynamics, xs, us, goal_x, goal_u, Q, R, Q_f, dt)
        if use_ladder:
            gains, _, cs, xns, uns = riccati.riccati_ladder_solve(
                dynamics, xs, us, *lin[:4], Q, R, Q_f, lin[4], lin[5], goal_x,
                goal_u, alphas, u_min, u_max, dt, reg=1e-6)
        else:
            gains, ks = backward_pass(us, *lin)
            xns, uns, cs = forward_pass(xs, us, gains, ks, alphas)
        accept = cs <= prev_cost
        if it == 0:
            accept = torch.ones_like(accept)
        # first (largest) accepted alpha, else the smallest
        idx = torch.where(torch.any(accept), torch.argmax(accept.to(torch.int32)),
                          alphas.shape[0] - 1)
        xs = xns.index_select(0, idx.reshape(1))[0]
        us = uns.index_select(0, idx.reshape(1))[0]
        prev_cost = cs.index_select(0, idx.reshape(1))[0]
    return DDPFeedbackState(gains=gains, x_traj=xs, u_traj=us, total_cost=prev_cost)


class DDPFeedback(FeedbackController):
    """DDPFeedback analog (feedback_controllers/DDP/ddp.cuh:106-161): iLQR
    tracking of the nominal trajectory, gains applied as
    u_fb = K[t] (x - x_goal). Q, R and Q_f are buffers; ``dynamics`` is the
    model the controller steps (a shared submodule)."""

    def __init__(self, dynamics, dt, Q=None, R=None, Q_f=None,
                 num_iterations=1, use_boxqp=False, use_kernel=True):
        super().__init__()
        S, C = dynamics.STATE_DIM, dynamics.CONTROL_DIM
        dev = dynamics.control_ranges.device

        def f32(v, n):
            v = np.eye(n) if v is None else v
            return torch.tensor(np.asarray(v, np.float32), device=dev).reshape(n, n)

        self.dynamics = dynamics
        self.register_buffer("Q", f32(Q, S))
        self.register_buffer("R", f32(R, C))
        self.register_buffer("Q_f", f32(Q_f, S))
        self.dt = float(dt)
        self.num_iterations = int(num_iterations)
        self.use_boxqp = bool(use_boxqp)
        self.use_kernel = bool(use_kernel)

    @classmethod
    def create(cls, dynamics, dt, Q=None, R=None, Q_f=None, num_iterations=1,
               use_boxqp=False, use_kernel=True):
        return cls(dynamics, dt, Q, R, Q_f, num_iterations, use_boxqp, use_kernel)

    def init_feedback_state(self, num_timesteps):
        S, C = self.dynamics.STATE_DIM, self.dynamics.CONTROL_DIM
        f32 = dict(dtype=torch.float32, device=self.Q.device)
        return DDPFeedbackState(
            gains=torch.zeros((num_timesteps, C, S), **f32),
            x_traj=torch.zeros((num_timesteps, S), **f32),
            u_traj=torch.zeros((num_timesteps, C), **f32),
            total_cost=torch.zeros((), **f32),
        )

    def compute_feedback(self, x0, goal_traj, control_traj):
        return ilqr_tracking(
            self.dynamics, x0, control_traj, goal_traj,
            torch.zeros_like(control_traj), self.Q, self.R, self.Q_f, self.dt,
            iterations=self.num_iterations, use_boxqp=self.use_boxqp,
            use_kernel=self.use_kernel)

    def k(self, x, x_goal, t, fb_state: DDPFeedbackState):
        return fb_state.gains[t] @ (x - x_goal)
