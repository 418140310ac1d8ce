from mppi_generic_tpu_torch.models.autorally import AutorallyNNDynamics
from mppi_generic_tpu_torch.models.base import Dynamics, rollout_single
from mppi_generic_tpu_torch.models.bicycle_slip import BicycleSlipDynamics
from mppi_generic_tpu_torch.models.cartpole import CartpoleDynamics
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.models.dubins import DubinsDynamics
from mppi_generic_tpu_torch.models.quadrotor import QuadrotorDynamics
from mppi_generic_tpu_torch.models.racer_dubins import RacerDubinsDynamics
from mppi_generic_tpu_torch.models.racer_dubins_elevation import (
    RacerDubinsElevationDynamics,
    RacerDubinsElevationLSTMSteering,
    static_settling,
)
from mppi_generic_tpu_torch.models.racer_dubins_unc import (
    RacerDubinsElevationLSTMUncertainty,
    RacerDubinsElevationSuspension,
)

__all__ = ["AutorallyNNDynamics", "BicycleSlipDynamics", "CartpoleDynamics", "Dynamics",
           "DoubleIntegratorDynamics", "DubinsDynamics", "QuadrotorDynamics",
           "RacerDubinsDynamics", "RacerDubinsElevationDynamics",
           "RacerDubinsElevationLSTMSteering", "RacerDubinsElevationLSTMUncertainty",
           "RacerDubinsElevationSuspension", "rollout_single", "static_settling"]
