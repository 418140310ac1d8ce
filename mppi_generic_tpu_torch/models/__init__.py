from mppi_generic_tpu_torch.models.base import Dynamics, rollout_single
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics

__all__ = ["Dynamics", "DoubleIntegratorDynamics", "rollout_single"]
