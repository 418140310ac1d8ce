"""Per-robot instantiations, in PyTorch.

Counterpart of ``mppi_generic_tpu/instantiations/__init__.py`` (the
reference's ``include/mppi/instantiations/*`` typedef headers). Each factory
wires a ``VanillaMPPI`` at the reference's published scales and returns it
with the ``DDPFeedback`` for its dynamics: (controller, feedback). Every knob
can be overridden through the keyword arguments, which go to
``VanillaMPPI`` (``kernel`` is one of the port's names, ``"fused"``,
``"fused_solve"`` or ``"combined"``; ``"combined"`` by default, as the JAX
package's). The device rule is the controllers': the card unless
``device="cpu"``.

The DDP feedback runs the ladder kernel for the double integrator, the
cartpole and AutoRally; the quadrotor's (S = 13) and the racer model's
(S = 26) sizes are outside ``ops.riccati.supported``, so their feedback
takes the eager scan, as the JAX package takes its XLA scan.
"""

from __future__ import annotations

from mppi_generic_tpu_torch.controllers.vanilla import VanillaMPPI
from mppi_generic_tpu_torch.costs.autorally import ARStandardCost
from mppi_generic_tpu_torch.costs.cartpole import CartpoleQuadraticCost
from mppi_generic_tpu_torch.costs.double_integrator import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.costs.quadrotor import QuadrotorMapCost, QuadrotorQuadraticCost
from mppi_generic_tpu_torch.feedback.ilqr import DDPFeedback
from mppi_generic_tpu_torch.models.autorally import AutorallyNNDynamics
from mppi_generic_tpu_torch.models.cartpole import CartpoleDynamics
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.models.quadrotor import QuadrotorDynamics
from mppi_generic_tpu_torch.models.racer_dubins_unc import RacerDubinsElevationLSTMUncertainty
from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution

__all__ = [
    "autorally_mppi",
    "cartpole_mppi",
    "double_integrator_mppi",
    "quadrotor_mppi",
    "quadrotor_waypoint_mppi",
    "racer_lstm_mppi",
]


def _controller(dynamics, cost, std_dev, *, num_rollouts, num_timesteps, dt=0.02,
                lam=1.0, alpha=0.0, num_iters=1, kernel="combined",
                control_cost_coeff=None, **kw):
    """The controller (Gaussian sampler of ``std_dev``, zero control-cost
    coefficients unless given) and its DDP feedback (Q, R, Q_f the
    identity), on the controller's device."""
    if control_cost_coeff is None:
        control_cost_coeff = [0.0] * dynamics.CONTROL_DIM
    ctrl = VanillaMPPI(
        dynamics, cost,
        GaussianDistribution.create(std_dev=std_dev, control_cost_coeff=control_cost_coeff),
        dt=dt, lam=lam, alpha=alpha, num_timesteps=num_timesteps,
        num_rollouts=num_rollouts, num_iters=num_iters, kernel=kernel, **kw)
    return ctrl, DDPFeedback.create(ctrl.dynamics, dt)


def autorally_mppi(num_rollouts=1920, num_timesteps=150, nn=None, costmap=None, **kw):
    """AutoRally NN-dynamics racing setup
    (instantiations/autorally_mppi/autorally_mppi.cuh:10-18: 1920 rollouts,
    150 timesteps, NeuralNetModel<7,2,3> + ARStandardCost + DDP feedback).
    ``nn``: an FNN (the 6-32-32-4 network of zeros without one);
    ``costmap``: a ``MapTexture2D`` track map (without one the track term is
    zero)."""
    return _controller(AutorallyNNDynamics.create(nn=nn), ARStandardCost(costmap=costmap),
                       [0.3, 0.5], num_rollouts=num_rollouts,
                       num_timesteps=num_timesteps, **kw)


def cartpole_mppi(num_rollouts=2048, num_timesteps=100, **kw):
    """Cartpole swing-up (instantiations/cartpole_mppi +
    examples/cartpole_example.cu:29-48 scales)."""
    return _controller(CartpoleDynamics.create(control_ranges=[[-5.0, 5.0]]),
                       CartpoleQuadraticCost(), [5.0], num_rollouts=num_rollouts,
                       num_timesteps=num_timesteps, **kw)


def double_integrator_mppi(num_rollouts=1024, num_timesteps=100, **kw):
    """Double-integrator circle tracking (instantiations/double_integrator_mppi)."""
    return _controller(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                       [1.0, 1.0], num_rollouts=num_rollouts,
                       num_timesteps=num_timesteps, **kw)


def quadrotor_mppi(num_rollouts=2048, num_timesteps=100, **kw):
    """Quadrotor hover/waypoint (instantiations/quadrotor_mppi)."""
    return _controller(QuadrotorDynamics.create(), QuadrotorQuadraticCost(),
                       [2.0, 0.5, 0.5, 0.5], num_rollouts=num_rollouts,
                       num_timesteps=num_timesteps, **kw)


def quadrotor_waypoint_mppi(num_rollouts=1024, num_timesteps=48, costmap=None, **kw):
    """Quadrotor gate-mission setup with the waypoint map cost
    (quadrotor_map_cost.*; examples/quadrotor_waypoint_example.py). Drive
    waypoints with ``ctrl.cost = ctrl.cost.update_waypoint(x, y, z,
    heading)``."""
    dyn = QuadrotorDynamics.create(control_ranges=[[-3.0, 3.0]] * 3 + [[0.0, 20.0]])
    cost = QuadrotorMapCost(costmap=costmap, dist_to_waypoint_coeff=8.0,
                            desired_speed=1.5)
    return _controller(dyn, cost, [0.5, 0.5, 0.5, 2.0], num_rollouts=num_rollouts,
                       num_timesteps=num_timesteps, **kw)


def racer_lstm_mppi(num_rollouts=1920, num_timesteps=150, elevation_map=None,
                    costmap=None, **kw):
    """RACER LSTM-uncertainty vehicle at the real-platform scale
    (racer_dubins_elevation_lstm_unc.*; 1920 rollouts x 150 steps), with
    ``ARStandardCost`` on the racer output layout (2, 3, 5, 6, 0, 1). The
    three LSTMs are random from numpy seeds 0, 1, 2 (the JAX package draws
    them from PRNGKey(0)); with an ``elevation_map`` the suspension reads the
    ground under the wheels and the static roll and pitch settle on it, in
    the kernels as in the eager path."""
    dyn = RacerDubinsElevationLSTMUncertainty.create(elevation_map=elevation_map)
    cost = ARStandardCost(costmap=costmap, output_indices=(2, 3, 5, 6, 0, 1))
    return _controller(dyn, cost, [0.3, 0.5], num_rollouts=num_rollouts,
                       num_timesteps=num_timesteps, **kw)
