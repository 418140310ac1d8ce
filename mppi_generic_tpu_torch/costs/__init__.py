from mppi_generic_tpu_torch.costs.base import Cost
from mppi_generic_tpu_torch.costs.double_integrator import DoubleIntegratorCircleCost

__all__ = ["Cost", "DoubleIntegratorCircleCost"]
