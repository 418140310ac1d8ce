"""Control-contraction-metric (CCM) feedback, in PyTorch.

Counterpart of ``mppi_generic_tpu/feedback/ccm.py`` (the reference's
``feedback_controllers/CCM/ccm.h``, LinearCCM :104-248, experimental and
CPU-only upstream). The feedback law (u_feedback, :204-228):

    delta_x = x - x_nom
    E    = delta_x' M(x) delta_x                       (Riemannian energy)
    lhs  = 2 B(x)' M(x) delta_x
    rhs  = -2 lambda E
           - 2 delta_x' M(x) (f(x) - f(x_nom) + (B(x) - B(x_nom)) u_nom)
    u_fb = 0                  if rhs > 0 or |lhs| = 0
         = (rhs / |lhs|^2) lhs  otherwise

The dual metric W(x) is the 2 x 2 block matrix [[w1 I, w2 I], [w3 I, w4 I]]
with w_i = a_i (x0^2 + x1^2) + b_i, and M = W^-1 (:149-174; the defaults are
the reference's lambda = 3.5 synthesis for the double integrator). f and B
come from the dynamics (``state_deriv`` and ``state_jacobian``). The law runs
as plain PyTorch on the device of its tensors; no kernel computes it.

``chebyshev_points`` / ``chebyshev_polynomial`` reproduce the reference's
Chebyshev pseudospectral helpers (:22-89), which its law never calls.
"""

from __future__ import annotations

import math

import torch

from mppi_generic_tpu_torch.feedback.base import FeedbackController

# W(x)'s block coefficients [a, b] (ccm.h:167-170)
_W_DEFAULTS = {"w1": (0.0005948, 2.2416827), "w2": (-0.0044842, -8.2434395),
               "w3": (-0.0044842, -8.2434395), "w4": (0.0521421, 59.1072868)}


def chebyshev_points(n, device=None):
    """Chebyshev-Gauss-Lobatto points on [0, 1] and their Clenshaw-Curtis
    weights (ccm.h:22-53): (points (n,), weights (n,))."""
    f32 = dict(dtype=torch.float32, device=device)
    k = torch.arange(n, **f32)
    pts = 0.5 * (1.0 - torch.cos(math.pi * k / (n - 1)))
    N = n - 1
    js = torch.arange(1, N // 2 + 1, **f32)
    b = torch.where(2 * js == N, 1.0, 2.0)
    i = torch.arange(n, **f32)[:, None]
    theta = math.pi * i / N
    s = torch.sum(b / (4.0 * js**2 - 1.0) * torch.cos(2.0 * js * theta), dim=1)
    c = torch.where((i[:, 0] == 0) | (i[:, 0] == N), 1.0, 2.0)
    return pts, c / N * (1.0 - s) * 0.5


def chebyshev_polynomial(pts, degree):
    """The Chebyshev polynomials T_0 .. T_{degree-1} at ``pts`` mapped to
    [-1, 1] (ccm.h:55-70): (degree, n)."""
    x = 2.0 * pts - 1.0
    rows = [torch.ones_like(x), x]
    for _ in range(2, degree):
        rows.append(2.0 * x * rows[-1] - rows[-2])
    return torch.stack(rows[:degree])


class CCMFeedback(FeedbackController):
    """LinearCCM analog. Its feedback state is (x_nominal_traj (T, S),
    u_nominal_traj (T, C)). ``lam`` and the W coefficients are buffers on the
    dynamics' device."""

    def __init__(self, dynamics, lam=3.5, **w):
        super().__init__()
        unknown = set(w) - set(_W_DEFAULTS)
        if unknown:
            raise ValueError(f"unknown CCM coefficients {sorted(unknown)}")
        dev = dynamics.control_ranges.device
        self.dynamics = dynamics
        self.register_buffer("lam", torch.tensor(lam, dtype=torch.float32, device=dev))
        for name, default in _W_DEFAULTS.items():
            self.register_buffer(name, torch.tensor(w.get(name, default),
                                                    dtype=torch.float32, device=dev))

    @classmethod
    def create(cls, dynamics, lam=3.5, **w):
        return cls(dynamics, lam, **w)

    def metric(self, x):
        """M(x) = W(x)^-1 (ccm.h:149-174). The reference zeroes the
        state-dependent terms (x0_2 = x1_2 = 0, :152-153), and so does this:
        the polynomial coefficients are kept but evaluated at 0."""
        half = self.dynamics.STATE_DIM // 2
        r2 = torch.zeros((), dtype=torch.float32, device=x.device)
        eye = torch.eye(half, dtype=torch.float32, device=x.device)
        w1, w2, w3, w4 = ((w[0] * r2 + w[1]) * eye for w in (self.w1, self.w2, self.w3,
                                                               self.w4))
        W = torch.cat([torch.cat([w1, w2], dim=1), torch.cat([w3, w4], dim=1)], dim=0)
        return torch.linalg.inv(W)

    def energy(self, delta_x, x):
        return delta_x @ self.metric(x) @ delta_x

    def init_feedback_state(self, num_timesteps):
        S, C = self.dynamics.STATE_DIM, self.dynamics.CONTROL_DIM
        f32 = dict(dtype=torch.float32, device=self.lam.device)
        return (torch.zeros((num_timesteps, S), **f32), torch.zeros((num_timesteps, C), **f32))

    def compute_feedback(self, x0, goal_traj, control_traj):
        """No per-solve synthesis (initTrackingController is empty,
        ccm.h:131): the state is the nominal trajectories."""
        del x0
        return (goal_traj, control_traj)

    def u_feedback(self, x_act, x_nom, u_nom):
        """The contraction feedback law (ccm.h:204-228)."""
        dyn = self.dynamics
        delta_x = x_act - x_nom
        M = self.metric(x_act)
        _, B_act = dyn.state_jacobian(x_act, u_nom)
        _, B_nom = dyn.state_jacobian(x_nom, u_nom)
        zero_u = torch.zeros_like(u_nom)
        E = delta_x @ M @ delta_x
        lhs = 2.0 * B_act.T @ M @ delta_x
        lhs_norm2 = torch.sum(lhs * lhs)
        drift = (dyn.state_deriv(x_act, zero_u) - dyn.state_deriv(x_nom, zero_u)
                 + (B_act - B_nom) @ u_nom)
        rhs = -2.0 * self.lam * E - 2.0 * delta_x @ M @ drift
        return torch.where((rhs > 0) | (lhs_norm2 == 0), torch.zeros_like(u_nom),
                           rhs / torch.clamp_min(lhs_norm2, 1e-12) * lhs)

    def k(self, x, x_goal, t, fb_state):
        _, u_traj = fb_state
        T = u_traj.shape[0]
        return self.u_feedback(x, x_goal, u_traj[min(max(int(t), 0), T - 1)])
