from mppi_generic_tpu_torch.controllers.base import (
    ControllerBase,
    ControllerState,
    SolveResult,
)
from mppi_generic_tpu_torch.controllers.vanilla import VanillaMPPI

__all__ = ["ControllerBase", "ControllerState", "SolveResult", "VanillaMPPI"]
