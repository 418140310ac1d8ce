from mppi_generic_tpu_torch.costs.autorally import ARRobustCost, ARStandardCost
from mppi_generic_tpu_torch.costs.base import Cost
from mppi_generic_tpu_torch.costs.cartpole import CartpoleQuadraticCost
from mppi_generic_tpu_torch.costs.double_integrator import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.costs.quadratic import QuadraticCost
from mppi_generic_tpu_torch.costs.quadrotor import QuadrotorMapCost, QuadrotorQuadraticCost

__all__ = ["ARRobustCost", "ARStandardCost", "CartpoleQuadraticCost", "Cost",
           "DoubleIntegratorCircleCost", "QuadraticCost", "QuadrotorMapCost",
           "QuadrotorQuadraticCost"]
