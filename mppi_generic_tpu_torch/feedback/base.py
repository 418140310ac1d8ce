"""Feedback-controller base, in PyTorch.

Counterpart of ``mppi_generic_tpu/feedback/base.py`` (the reference's
GPUFeedbackController / FeedbackController pair,
feedback_controllers/feedback.cuh:35-312). A feedback controller is an
``nn.Module`` with

* ``compute_feedback(x0, goal_traj, control_traj) -> fb_state``, the
  per-solve gain computation (the reference's CPU DDP solve), and
* ``k(x, x_goal, t, fb_state) -> u_fb``, the per-step feedback law that the
  RMPPI rollout evaluates inside its loop (the reference's __device__ k()).

``fb_state`` holds tensors only (for DDP, the (T, C, S) gain trajectory),
so it can be handed to the rollout kernels.
"""

from __future__ import annotations

import torch
from torch import nn


class FeedbackController(nn.Module):
    def init_feedback_state(self, num_timesteps):
        raise NotImplementedError

    def compute_feedback(self, x0, goal_traj, control_traj):
        """goal_traj: (T, S) target states; control_traj: (T, C). Returns
        the new feedback state (gains etc.)."""
        raise NotImplementedError

    def k(self, x, x_goal, t, fb_state):
        """Feedback control at step t: u_fb = K[t] (x - x_goal)."""
        raise NotImplementedError

    def interpolate_feedback(self, x, fb_state, rel_time, dt, goal_traj):
        """Feedback at a wall-clock offset ``rel_time`` (host float),
        linearly interpolating between the two neighbouring steps
        (controller.cuh interpolateFeedback:395-399)."""
        T = goal_traj.shape[0]
        idx_f = min(max(float(rel_time) / float(dt), 0.0), T - 1.0)
        lo = min(max(int(idx_f // 1), 0), T - 1)
        hi = min(lo + 1, T - 1)
        a = idx_f - lo
        u_lo = self.k(x, goal_traj[lo], lo, fb_state)
        u_hi = self.k(x, goal_traj[hi], hi, fb_state)
        return (1 - a) * u_lo + a * u_hi


class NoFeedback(FeedbackController):
    """Zero feedback (the reference runs controllers without feedback
    unless it is enabled; computeFeedback is gated on enable_feedback_)."""

    def __init__(self, control_dim=0, state_dim=0):
        super().__init__()
        self.CONTROL_DIM = int(control_dim)
        self.STATE_DIM = int(state_dim)

    def init_feedback_state(self, num_timesteps):
        return torch.zeros((num_timesteps, self.CONTROL_DIM, self.STATE_DIM))

    def compute_feedback(self, x0, goal_traj, control_traj):
        return torch.zeros((goal_traj.shape[0], self.CONTROL_DIM, self.STATE_DIM),
                           dtype=goal_traj.dtype, device=goal_traj.device)

    def k(self, x, x_goal, t, fb_state):
        return torch.zeros((self.CONTROL_DIM,), dtype=x.dtype, device=x.device)
