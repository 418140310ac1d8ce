from mppi_generic_tpu_torch.feedback.base import FeedbackController, NoFeedback
from mppi_generic_tpu_torch.feedback.ilqr import (
    DDPFeedback,
    DDPFeedbackState,
    ilqr_tracking,
)

__all__ = [
    "FeedbackController",
    "NoFeedback",
    "DDPFeedback",
    "DDPFeedbackState",
    "ilqr_tracking",
]
