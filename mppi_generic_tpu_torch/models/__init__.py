from mppi_generic_tpu_torch.models.autorally import AutorallyNNDynamics
from mppi_generic_tpu_torch.models.base import Dynamics, rollout_single
from mppi_generic_tpu_torch.models.bicycle_slip import BicycleSlipDynamics
from mppi_generic_tpu_torch.models.cartpole import CartpoleDynamics
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.models.dubins import DubinsDynamics
from mppi_generic_tpu_torch.models.quadrotor import QuadrotorDynamics

__all__ = ["AutorallyNNDynamics", "BicycleSlipDynamics", "CartpoleDynamics", "Dynamics",
           "DoubleIntegratorDynamics", "DubinsDynamics", "QuadrotorDynamics",
           "rollout_single"]
