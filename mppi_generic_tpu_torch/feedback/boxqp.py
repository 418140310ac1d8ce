"""Box-constrained QP solver, in PyTorch.

Counterpart of ``mppi_generic_tpu/feedback/boxqp.py`` (the reference's
projected-Newton ``BoxQP``, ddp/boxqp.h:79-296), which the DDP backward pass
uses under ``DDPFeedback(use_boxqp=True)`` to solve, per time step,

    min_u  0.5 u' H u + g' u    s.t.  lb <= u <= ub.

The same fixed-shape formulation as the JAX package: the clamped rows and
columns of H are masked to the identity and the clamped gradient entries
zeroed, so one full-size solve gives the free subspace's Newton step; a
fixed number of iterations replaces the convergence loop, and the Armijo
backtracking is the best point of a ladder of step sizes. Plain PyTorch
(no kernel): the JAX package runs it in its XLA scan only.
"""

from __future__ import annotations

import torch


def _masked(H, free):
    """H with the clamped rows and columns replaced by the identity's."""
    return H * free[:, None] * free[None, :] + torch.diag(1.0 - free)


def _clamped(x, grad, lb, ub):
    """The active set: at a bound with the gradient pushing outward
    (boxqp.h:140-146)."""
    return ((x <= lb) & (grad > 0)) | ((x >= ub) & (grad < 0))


def boxqp(H, g, lb, ub, x0=None, max_iter: int = 8, n_steps: int = 10):
    """Solve min 0.5 x' H x + g' x for lb <= x <= ub. Returns (x, free):
    ``free`` marks the dimensions not at an active bound at the end (the
    reference returns the free set's factorisation for the gains,
    boxqp.h:45-52)."""
    if x0 is None:
        x0 = torch.zeros_like(g)
    x = torch.minimum(torch.maximum(x0, lb), ub)
    alphas = torch.pow(0.5, torch.arange(n_steps, dtype=torch.float32, device=g.device))

    def objective(x):
        """0.5 x' H x + g' x of one point x (C,) or of each row of x (n, C)."""
        return ((0.5 * x) @ H * x).sum(-1) + (x * g).sum(-1)

    for _ in range(max_iter):
        grad = g + H @ x
        free = (~_clamped(x, grad, lb, ub)).to(torch.float32)
        dx = -torch.linalg.solve(_masked(H, free), grad * free)
        cands = torch.minimum(torch.maximum(x[None, :] + alphas[:, None] * dx[None, :], lb),
                              ub)
        vals = objective(cands)
        best = cands[torch.argmin(vals)]
        x = torch.where(torch.amin(vals) < objective(x), best, x)
    grad = g + H @ x
    return x, ~_clamped(x, grad, lb, ub)


def boxqp_gains(H, Qux, free_mask):
    """The feedback gains of the active set: zero rows for the clamped
    controls, K_free = -H_ff^-1 Qux_free for the free ones (the reference
    back-substitutes through the free set's Cholesky factor)."""
    free = free_mask.to(torch.float32)
    return -torch.linalg.solve(_masked(H, free), Qux * free[:, None])
