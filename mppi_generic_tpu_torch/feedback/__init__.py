from mppi_generic_tpu_torch.feedback.base import FeedbackController, NoFeedback
from mppi_generic_tpu_torch.feedback.boxqp import boxqp, boxqp_gains
from mppi_generic_tpu_torch.feedback.ccm import (
    CCMFeedback,
    chebyshev_points,
    chebyshev_polynomial,
)
from mppi_generic_tpu_torch.feedback.ilqr import (
    DDPFeedback,
    DDPFeedbackState,
    ilqr_tracking,
)

__all__ = [
    "FeedbackController",
    "NoFeedback",
    "CCMFeedback",
    "DDPFeedback",
    "DDPFeedbackState",
    "boxqp",
    "boxqp_gains",
    "chebyshev_points",
    "chebyshev_polynomial",
    "ilqr_tracking",
]
