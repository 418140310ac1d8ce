from mppi_generic_tpu_torch.models.autorally import AutorallyNNDynamics
from mppi_generic_tpu_torch.models.base import Dynamics, rollout_single
from mppi_generic_tpu_torch.models.bicycle_slip import (
    BicycleSlipDynamics,
    BicycleSlipParametricElevation,
)
from mppi_generic_tpu_torch.models.cartpole import CartpoleDynamics
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.models.dubins import DubinsDynamics
from mppi_generic_tpu_torch.models.quadrotor import QuadrotorDynamics
from mppi_generic_tpu_torch.models.racer_dubins import RacerDubinsDynamics
from mppi_generic_tpu_torch.models.racer_dubins_elevation import (
    RacerDubinsElevationDynamics,
    RacerDubinsElevationLSTMSteering,
    body_frame_normals,
    static_settling,
)
from mppi_generic_tpu_torch.models.racer_dubins_unc import (
    RacerDubinsElevationLSTMUncertainty,
    RacerDubinsElevationSuspension,
)
from mppi_generic_tpu_torch.models.racer_suspension import RacerSuspensionDynamics

# the JAX package's models.__all__; rollout_single, static_settling and
# body_frame_normals are imported from here too
__all__ = ["AutorallyNNDynamics", "BicycleSlipDynamics", "BicycleSlipParametricElevation",
           "CartpoleDynamics", "Dynamics", "DoubleIntegratorDynamics", "DubinsDynamics",
           "QuadrotorDynamics", "RacerDubinsDynamics", "RacerDubinsElevationDynamics",
           "RacerDubinsElevationLSTMSteering", "RacerDubinsElevationLSTMUncertainty",
           "RacerDubinsElevationSuspension", "RacerSuspensionDynamics"]
