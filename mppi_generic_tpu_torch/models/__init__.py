from mppi_generic_tpu_torch.models.autorally import AutorallyNNDynamics
from mppi_generic_tpu_torch.models.base import Dynamics, rollout_single
from mppi_generic_tpu_torch.models.bicycle_slip import BicycleSlipDynamics
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics

__all__ = ["AutorallyNNDynamics", "BicycleSlipDynamics", "Dynamics",
           "DoubleIntegratorDynamics", "rollout_single"]
