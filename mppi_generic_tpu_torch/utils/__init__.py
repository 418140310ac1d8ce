from mppi_generic_tpu_torch.utils import math_utils

__all__ = ["math_utils"]
