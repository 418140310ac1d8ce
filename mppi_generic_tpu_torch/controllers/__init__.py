from mppi_generic_tpu_torch.controllers.base import (
    ControllerBase,
    ControllerState,
    SolveResult,
)
from mppi_generic_tpu_torch.controllers.colored import ColoredMPPI
from mppi_generic_tpu_torch.controllers.robust import (
    RobustControllerState,
    RobustMPPI,
    RobustSolveResult,
    line_search_weights,
)
from mppi_generic_tpu_torch.controllers.tube import (
    TubeControllerState,
    TubeMPPI,
    TubeSolveResult,
)
from mppi_generic_tpu_torch.controllers.vanilla import VanillaMPPI

__all__ = [
    "ColoredMPPI",
    "ControllerBase",
    "ControllerState",
    "RobustControllerState",
    "RobustMPPI",
    "RobustSolveResult",
    "SolveResult",
    "TubeControllerState",
    "TubeMPPI",
    "TubeSolveResult",
    "VanillaMPPI",
    "line_search_weights",
]
