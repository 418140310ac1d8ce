"""Build the port's objects from parameters carried across from JAX.

Each function here takes a dict of numpy arrays (or numbers) keyed by the JAX
package's field names, so that a JAX object and its counterpart here share
the same parameters. The dicts are made on the JAX side; nothing here
imports JAX.

* dynamics: ``control_ranges``, ``control_deadband``, ``zero_control``;
  the double integrator also ``system_noise``, AutoRally ``nn`` (an FNN:
  ``weights``, a list of (out, in) arrays, and ``biases``), the bicycle-slip
  model the names of ``models.bicycle_slip.PARAM_NAMES``, the cartpole
  ``cart_mass``, ``pole_mass``, ``pole_length``, the quadrotor ``mass``,
  ``tau_roll``, ``tau_pitch``, ``tau_yaw`` (dubins: nothing more); the
  racer models (RACER Dubins, its elevation, suspension-LSTM and
  LSTM-uncertainty variants, the rigid-body RacerSuspension) and the
  bicycle elevation model the names of their ``param_names()``, all but
  RACER Dubins ``elevation_map`` (None or a texture), the bicycle elevation
  model also ``normals_map``; the LSTM models ``lstm`` (an LSTM: ``W_im`` ...
  ``b_c``, ``initial_hidden``, ``initial_cell``, ``output_nn``, an FNN),
  ``warm_hidden``, ``warm_cell`` and optionally ``lstm_lstm`` (None or
  ``init_model``, ``pred_model``, two LSTMs, and ``init_len``); the
  uncertainty model also ``mean_lstm``, ``unc_lstm``, their
  ``mean_lstm_lstm``, ``unc_lstm_lstm`` and the warm states
  ``mean_warm_hidden``, ``mean_warm_cell``, ``unc_warm_hidden``,
  ``unc_warm_cell``;
* cost: the circle cost and the DI robust cost ``velocity_cost``,
  ``crash_cost``, ``velocity_desired``, ``inner_path_radius2``,
  ``outer_path_radius2``, ``angular_momentum_desired``, ``discount``; the
  AutoRally costs their
  ``PARAM_NAMES``, ``l1_speed_cost``, ``output_indices`` and ``costmap``
  (None, or a texture: ``data``, ``origin``, ``rotation``, ``resolution``,
  ``channel_major``); the cartpole cost ``coeffs``, ``desired_state``,
  ``terminal_cost_coeff``; ``QuadraticCost`` ``goal``, ``coeffs``,
  ``OUTPUT_DIM``, ``terminal_scale``, ``current_time``;
  ``QuadrotorQuadraticCost`` ``s_goal`` and its ``PARAM_NAMES``;
  ``QuadrotorMapCost`` its ``PARAM_NAMES`` and ``costmap``;
* sampler: ``std_dev``, ``control_cost_coeff``, ``pure_noise_percentage``,
  ``std_dev_decay``; Smooth-MPPI also ``dt_smooth`` and ``num_timesteps``;
  the colored sampler ``exponents``, ``offset_decay_rate`` and ``fmin``;
* shaping function: ``lam`` (normExp), ``gamma`` and ``r`` (Tsallis) or
  ``elite_fraction`` (CEM);
* controller: ``dt``, ``lam``, ``alpha``, ``num_timesteps``,
  ``num_rollouts``, ``num_iters``, optionally ``slide_scale``; for vanilla MPPI optionally
  ``tsallis_gamma``, ``tsallis_r``, ``cem_elite_fraction``; for ColoredMPPI
  also ``state_leash_dist`` (None: no leash); for RMPPI also
  ``value_function_threshold``,
  ``num_candidates``, ``samples_per_condition``; for Tube-MPPI
  ``nominal_threshold``;
* DDP feedback: ``Q``, ``R``, ``Q_f``, ``dt``, ``num_iterations``, and
  optionally ``use_pallas`` (the port's ``use_kernel``);
* state: ``control_mean``, ``control_history``, ``previous_baseline`` and
  optionally ``sampler_state`` (Smooth-MPPI's derivative mean); the
  robust and tube states add ``nominal_mean``, ``nominal_state``,
  ``nominal_initialized``, ``previous_baseline_real``,
  ``previous_baseline_nominal`` and ``feedback_state`` (a dict of
  ``gains``, ``x_traj``, ``u_traj``, ``total_cost``); the robust state also
  ``nominal_traj``, ``nominal_control_history``, ``best_index`` and
  ``nominal_stride``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mppi_generic_tpu_torch.controllers.base import ControllerState
from mppi_generic_tpu_torch.controllers.colored import ColoredMPPI
from mppi_generic_tpu_torch.controllers.robust import RobustControllerState, RobustMPPI
from mppi_generic_tpu_torch.controllers.tube import TubeControllerState, TubeMPPI
from mppi_generic_tpu_torch.controllers.vanilla import VanillaMPPI
from mppi_generic_tpu_torch.costs.autorally import ARRobustCost, ARStandardCost
from mppi_generic_tpu_torch.costs.cartpole import CartpoleQuadraticCost
from mppi_generic_tpu_torch.costs.double_integrator import (
    DoubleIntegratorCircleCost,
    DoubleIntegratorRobustCost,
)
from mppi_generic_tpu_torch.costs.quadratic import QuadraticCost
from mppi_generic_tpu_torch.costs.quadrotor import QuadrotorMapCost, QuadrotorQuadraticCost
from mppi_generic_tpu_torch.feedback.ilqr import DDPFeedback, DDPFeedbackState
from mppi_generic_tpu_torch.maps.texture import MapTexture2D
from mppi_generic_tpu_torch.models.autorally import AutorallyNNDynamics
from mppi_generic_tpu_torch.models.bicycle_slip import PARAM_NAMES as BICYCLE_PARAMS
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
)
from mppi_generic_tpu_torch.models.racer_dubins_unc import (
    RacerDubinsElevationLSTMUncertainty,
    RacerDubinsElevationSuspension,
)
from mppi_generic_tpu_torch.models.racer_suspension import RacerSuspensionDynamics
from mppi_generic_tpu_torch.nn.fnn import FNN
from mppi_generic_tpu_torch.nn.lstm import LSTM, LSTMLSTM
from mppi_generic_tpu_torch.sampling.colored import ColoredNoiseDistribution
from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution
from mppi_generic_tpu_torch.sampling.nln import NLNDistribution
from mppi_generic_tpu_torch.sampling.smooth import SmoothMPPIDistribution
from mppi_generic_tpu_torch.shaping import (
    CEMShapingFunction,
    ShapingFunction,
    TsallisShapingFunction,
)


def _arr(v):
    return np.asarray(v, np.float32)


def _scalar(v) -> float:
    return float(np.asarray(v, np.float32))


def double_integrator_from_params(p: dict, device="cpu") -> DoubleIntegratorDynamics:
    return DoubleIntegratorDynamics(
        system_noise=_scalar(p["system_noise"]),
        control_ranges=_arr(p["control_ranges"]),
        control_deadband=_arr(p["control_deadband"]),
        zero_control=_arr(p["zero_control"]),
        device=device,
    )


def fnn_from_params(p: dict, device="cpu") -> FNN:
    return FNN([_arr(w) for w in p["weights"]], [_arr(b) for b in p["biases"]],
               device=device)


def autorally_from_params(p: dict, device="cpu") -> AutorallyNNDynamics:
    return AutorallyNNDynamics(
        fnn_from_params(p["nn"]),
        control_ranges=_arr(p["control_ranges"]),
        control_deadband=_arr(p["control_deadband"]),
        zero_control=_arr(p["zero_control"]),
        device=device,
    )


def bicycle_slip_from_params(p: dict, device="cpu") -> BicycleSlipDynamics:
    return BicycleSlipDynamics(
        control_ranges=_arr(p["control_ranges"]),
        control_deadband=_arr(p["control_deadband"]),
        zero_control=_arr(p["zero_control"]),
        device=device,
        **{name: _arr(p[name]) for name in BICYCLE_PARAMS if name in p},
    )


def _constraints(p: dict) -> dict:
    return dict(control_ranges=_arr(p["control_ranges"]),
                control_deadband=_arr(p["control_deadband"]),
                zero_control=_arr(p["zero_control"]))


def cartpole_from_params(p: dict, device="cpu") -> CartpoleDynamics:
    return CartpoleDynamics(_scalar(p["cart_mass"]), _scalar(p["pole_mass"]),
                            _scalar(p["pole_length"]), device=device, **_constraints(p))


def quadrotor_from_params(p: dict, device="cpu") -> QuadrotorDynamics:
    return QuadrotorDynamics(*(_scalar(p[n]) for n in ("mass", "tau_roll", "tau_pitch",
                                                       "tau_yaw")),
                             device=device, **_constraints(p))


def dubins_from_params(p: dict, device="cpu") -> DubinsDynamics:
    return DubinsDynamics(device=device, **_constraints(p))


LSTM_FIELDS = ("W_im", "W_fm", "W_om", "W_cm", "W_ii", "W_fi", "W_oi", "W_ci",
               "b_i", "b_f", "b_o", "b_c")


def lstm_from_params(p: dict, device="cpu") -> LSTM:
    out = p.get("output_nn")
    return LSTM(*(_arr(p[n]) for n in LSTM_FIELDS), initial_hidden=_arr(p["initial_hidden"]),
                initial_cell=_arr(p["initial_cell"]),
                output_nn=None if out is None else fnn_from_params(out), device=device)


def lstm_lstm_from_params(p, device="cpu") -> LSTMLSTM | None:
    if p is None:
        return None
    return LSTMLSTM(lstm_from_params(p["init_model"]), lstm_from_params(p["pred_model"]),
                    int(p["init_len"])).to(device)


def _packed_kwargs(p: dict, cls) -> dict:
    """The constraints and the packed parameters of ``cls`` found in ``p``."""
    return dict(**_constraints(p),
                **{name: _arr(p[name]) for name in cls.param_names() if name in p})


def _texture_or_none(p):
    return None if p is None else texture_from_params(p)


def _racer_kwargs(p: dict, cls) -> dict:
    return dict(elevation_map=_texture_or_none(p.get("elevation_map")),
                lstm_lstm=lstm_lstm_from_params(p.get("lstm_lstm")), **_packed_kwargs(p, cls))


def racer_dubins_from_params(p: dict, device="cpu") -> RacerDubinsDynamics:
    return RacerDubinsDynamics(device=device, **_packed_kwargs(p, RacerDubinsDynamics))


def racer_elevation_from_params(p: dict, device="cpu") -> RacerDubinsElevationDynamics:
    cls = RacerDubinsElevationDynamics
    return cls(_texture_or_none(p.get("elevation_map")), device=device,
               **_packed_kwargs(p, cls))


def racer_elevation_suspension_from_params(p: dict,
                                           device="cpu") -> RacerDubinsElevationSuspension:
    cls = RacerDubinsElevationSuspension
    return cls(lstm_from_params(p["lstm"]), warm_hidden=_arr(p["warm_hidden"]),
               warm_cell=_arr(p["warm_cell"]), device=device, **_racer_kwargs(p, cls))


def racer_suspension_from_params(p: dict, device="cpu") -> RacerSuspensionDynamics:
    cls = RacerSuspensionDynamics
    return cls(_texture_or_none(p.get("elevation_map")), device=device,
               **_packed_kwargs(p, cls))


def bicycle_parametric_elevation_from_params(
        p: dict, device="cpu") -> BicycleSlipParametricElevation:
    cls = BicycleSlipParametricElevation
    return cls(_texture_or_none(p.get("elevation_map")), _texture_or_none(p.get("normals_map")),
               device=device, **_packed_kwargs(p, cls))


def racer_steering_from_params(p: dict, device="cpu") -> RacerDubinsElevationLSTMSteering:
    cls = RacerDubinsElevationLSTMSteering
    return cls(lstm_from_params(p["lstm"]), warm_hidden=_arr(p["warm_hidden"]),
               warm_cell=_arr(p["warm_cell"]), device=device, **_racer_kwargs(p, cls))


def racer_unc_from_params(p: dict, device="cpu") -> RacerDubinsElevationLSTMUncertainty:
    cls = RacerDubinsElevationLSTMUncertainty
    return cls(lstm_from_params(p["lstm"]), lstm_from_params(p["mean_lstm"]),
               lstm_from_params(p["unc_lstm"]),
               mean_lstm_lstm=lstm_lstm_from_params(p.get("mean_lstm_lstm")),
               unc_lstm_lstm=lstm_lstm_from_params(p.get("unc_lstm_lstm")),
               warm={n: _arr(p[n]) for n in cls.WARM}, device=device,
               **_racer_kwargs(p, cls))


def circle_cost_from_params(p: dict, device="cpu",
                            robust=False) -> DoubleIntegratorCircleCost:
    """``DoubleIntegratorCircleCost``, or ``DoubleIntegratorRobustCost`` with
    ``robust``."""
    return (DoubleIntegratorRobustCost if robust else DoubleIntegratorCircleCost)(
        **{name: _scalar(p[name]) for name in DoubleIntegratorCircleCost.PARAM_NAMES},
        device=device,
    )


def texture_from_params(p: dict, device="cpu") -> MapTexture2D:
    return MapTexture2D(_arr(p["data"]), origin=_arr(p["origin"]),
                        rotation=_arr(p["rotation"]), resolution=_arr(p["resolution"]),
                        channel_major=bool(p["channel_major"]), device=device)


def ar_cost_from_params(p: dict, device="cpu", robust=False) -> ARStandardCost:
    """``ARStandardCost``, or ``ARRobustCost`` with ``robust``."""
    costmap = p.get("costmap")
    return (ARRobustCost if robust else ARStandardCost)(
        **{name: _scalar(p[name]) for name in ARStandardCost.PARAM_NAMES},
        l1_speed_cost=bool(p.get("l1_speed_cost", False)),
        output_indices=tuple(int(i) for i in p.get("output_indices", range(6))),
        costmap=None if costmap is None else texture_from_params(costmap),
        device=device,
    )


def cartpole_cost_from_params(p: dict, device="cpu") -> CartpoleQuadraticCost:
    return CartpoleQuadraticCost(_arr(p["coeffs"]), _arr(p["desired_state"]),
                                 _scalar(p["terminal_cost_coeff"]), device=device)


def quadratic_cost_from_params(p: dict, device="cpu") -> QuadraticCost:
    return QuadraticCost(_arr(p["goal"]), _arr(p["coeffs"]),
                         output_dim=int(p["OUTPUT_DIM"]),
                         terminal_scale=_scalar(p["terminal_scale"]),
                         current_time=int(np.asarray(p.get("current_time", 0))),
                         device=device)


def quadrotor_quadratic_cost_from_params(p: dict, device="cpu") -> QuadrotorQuadraticCost:
    return QuadrotorQuadraticCost(
        _arr(p["s_goal"]), device=device,
        **{n: _scalar(p[n]) for n in QuadrotorQuadraticCost.PARAM_NAMES})


def quadrotor_map_cost_from_params(p: dict, device="cpu") -> QuadrotorMapCost:
    costmap = p.get("costmap")
    return QuadrotorMapCost(
        costmap=None if costmap is None else texture_from_params(costmap),
        device=device, **{n: _arr(p[n]) for n in QuadrotorMapCost.PARAM_NAMES})


DYNAMICS = {"double_integrator": double_integrator_from_params,
            "autorally": autorally_from_params,
            "bicycle_slip": bicycle_slip_from_params,
            "cartpole": cartpole_from_params,
            "quadrotor": quadrotor_from_params,
            "dubins": dubins_from_params,
            "racer_steering": racer_steering_from_params,
            "racer_unc": racer_unc_from_params,
            "racer_dubins": racer_dubins_from_params,
            "racer_elevation": racer_elevation_from_params,
            "racer_elev_susp": racer_elevation_suspension_from_params,
            "racer_suspension": racer_suspension_from_params,
            "bicycle_elevation": bicycle_parametric_elevation_from_params}
COSTS = {"circle": circle_cost_from_params,
         "di_robust": functools.partial(circle_cost_from_params, robust=True),
         "ar_standard": ar_cost_from_params,
         "ar_robust": functools.partial(ar_cost_from_params, robust=True),
         "cartpole": cartpole_cost_from_params,
         "quadratic": quadratic_cost_from_params,
         "quadrotor_quadratic": quadrotor_quadratic_cost_from_params,
         "quadrotor_map": quadrotor_map_cost_from_params}


def _gaussian_kwargs(p: dict) -> dict:
    return dict(
        std_dev=_arr(p["std_dev"]),
        control_cost_coeff=_arr(p["control_cost_coeff"]),
        pure_noise_percentage=_scalar(p["pure_noise_percentage"]),
        std_dev_decay=_scalar(p["std_dev_decay"]),
    )


def gaussian_from_params(p: dict, device="cpu") -> GaussianDistribution:
    return GaussianDistribution(**_gaussian_kwargs(p), device=device)


def nln_from_params(p: dict, device="cpu") -> NLNDistribution:
    return NLNDistribution(**_gaussian_kwargs(p), device=device)


def smooth_from_params(p: dict, device="cpu") -> SmoothMPPIDistribution:
    return SmoothMPPIDistribution(
        num_timesteps=int(p["num_timesteps"]), dt=_scalar(p["dt_smooth"]),
        **_gaussian_kwargs(p), device=device)


def colored_from_params(p: dict, device="cpu") -> ColoredNoiseDistribution:
    return ColoredNoiseDistribution(
        exponents=_arr(p["exponents"]),
        offset_decay_rate=_scalar(p["offset_decay_rate"]),
        fmin=float(p["fmin"]), **_gaussian_kwargs(p), device=device)


SAMPLERS = {"gaussian": gaussian_from_params, "nln": nln_from_params,
            "smooth": smooth_from_params, "colored": colored_from_params}


def shaping_from_params(p: dict, kind: str):
    """A shaping function: ``kind`` "norm_exp" (``lam``), "tsallis"
    (``gamma``, ``r``) or "cem" (``elite_fraction``)."""
    if kind == "norm_exp":
        return ShapingFunction(lam=_scalar(p["lam"]))
    if kind == "tsallis":
        return TsallisShapingFunction(gamma=_scalar(p["gamma"]), r=_scalar(p["r"]))
    if kind == "cem":
        return CEMShapingFunction(elite_fraction=_scalar(p["elite_fraction"]))
    raise ValueError(f"unknown shaping function {kind!r}")


def ddp_feedback_from_params(p: dict, dynamics) -> DDPFeedback:
    """A ``DDPFeedback`` for the port's ``dynamics`` (on its device)."""
    return DDPFeedback(
        dynamics, _scalar(p["dt"]), Q=_arr(p["Q"]), R=_arr(p["R"]),
        Q_f=_arr(p["Q_f"]), num_iterations=int(p["num_iterations"]),
        use_kernel=bool(p.get("use_pallas", True)))


def _controller_kwargs(controller: dict) -> dict:
    slide_scale = controller.get("slide_scale")
    # JAX pallas_split_cost and sequential_crash, where given
    extra = {}
    if controller.get("pallas_split_cost") is not None:
        extra["split_cost"] = bool(controller["pallas_split_cost"])
    if "sequential_crash" in controller:
        extra["sequential_crash"] = bool(controller["sequential_crash"])
    return dict(
        **extra,
        slide_scale=None if slide_scale is None else _arr(slide_scale),
        dt=_scalar(controller["dt"]),
        lam=_scalar(controller["lam"]),
        alpha=_scalar(controller["alpha"]),
        num_timesteps=int(controller["num_timesteps"]),
        num_rollouts=int(controller["num_rollouts"]),
        num_iters=int(controller["num_iters"]),
    )


def vanilla_from_params(dynamics: dict, cost: dict, sampler: dict,
                        controller: dict, device=None, kernel="fused",
                        sampler_kind="gaussian", weight_transform="exp",
                        dynamics_kind="double_integrator",
                        cost_kind="circle", shaping=None,
                        controller_cls=VanillaMPPI, **extra) -> VanillaMPPI:
    """A ``VanillaMPPI`` of the dynamics ``dynamics_kind`` (a key of
    ``DYNAMICS``), the cost ``cost_kind`` (a key of ``COSTS``) and the sampler ``sampler_kind``
    ("gaussian", "nln", "smooth" or "colored"), with an optional shaping
    function ``shaping`` = (params, kind) of ``shaping_from_params``; device
    rule as ``VanillaMPPI``: the card unless ``device="cpu"``."""
    transform = {name: _scalar(controller[name])
                 for name in ("tsallis_gamma", "tsallis_r", "cem_elite_fraction")
                 if name in controller}
    return controller_cls(
        DYNAMICS[dynamics_kind](dynamics),
        COSTS[cost_kind](cost),
        SAMPLERS[sampler_kind](sampler),
        kernel=kernel,
        weight_transform=weight_transform,
        shaping_function=None if shaping is None else shaping_from_params(*shaping),
        device=device,
        **transform,
        **extra,
        **_controller_kwargs(controller),
    )


def colored_mppi_from_params(dynamics: dict, cost: dict, sampler: dict,
                             controller: dict, device=None, kernel="fused",
                             weight_transform="exp",
                             dynamics_kind="double_integrator", cost_kind="circle",
                             shaping=None) -> ColoredMPPI:
    """A ``ColoredMPPI`` with a colored sampler, as ``vanilla_from_params``;
    ``controller`` may carry ``state_leash_dist``."""
    leash = controller.get("state_leash_dist")
    return vanilla_from_params(
        dynamics, cost, sampler, controller, device=device, kernel=kernel,
        sampler_kind="colored", weight_transform=weight_transform,
        dynamics_kind=dynamics_kind, cost_kind=cost_kind, shaping=shaping,
        controller_cls=ColoredMPPI,
        state_leash_dist=None if leash is None else _arr(leash))


def robust_from_params(dynamics: dict, cost: dict, sampler: dict,
                       controller: dict, feedback: dict, device=None,
                       kernel="fused", dynamics_kind="double_integrator",
                       cost_kind="circle") -> RobustMPPI:
    """A Gaussian ``RobustMPPI`` with DDP feedback of the dynamics
    ``dynamics_kind`` and the cost ``cost_kind`` (keys of ``DYNAMICS`` and
    ``COSTS``: the DI circle or robust cost, AutoRally with "ar_standard" or
    "ar_robust"); device rule as ``VanillaMPPI``."""
    dyn = DYNAMICS[dynamics_kind](dynamics)
    return RobustMPPI(
        dyn, COSTS[cost_kind](cost), gaussian_from_params(sampler),
        feedback=ddp_feedback_from_params(feedback, dyn),
        value_function_threshold=_scalar(controller["value_function_threshold"]),
        num_candidates=int(controller["num_candidates"]),
        samples_per_condition=int(controller["samples_per_condition"]),
        kernel=kernel, device=device, **_controller_kwargs(controller),
    )


def tube_from_params(dynamics: dict, cost: dict, sampler: dict,
                     controller: dict, feedback: dict, device=None,
                     kernel="fused", dynamics_kind="double_integrator",
                     cost_kind="circle") -> TubeMPPI:
    """A Gaussian ``TubeMPPI`` with DDP feedback, of the dynamics and cost
    kinds of ``robust_from_params``; device rule as ``VanillaMPPI``."""
    dyn = DYNAMICS[dynamics_kind](dynamics)
    return TubeMPPI(
        dyn, COSTS[cost_kind](cost), gaussian_from_params(sampler),
        feedback=ddp_feedback_from_params(feedback, dyn),
        nominal_threshold=_scalar(controller["nominal_threshold"]),
        kernel=kernel, device=device, **_controller_kwargs(controller),
    )


def state_from_params(p: dict, controller: VanillaMPPI,
                      seed: int = 0) -> ControllerState:
    f32 = dict(dtype=torch.float32, device=controller.device)
    state = controller.init_state(seed=seed)
    if p.get("sampler_state") is not None:
        state = state.replace(
            sampler_state=torch.tensor(_arr(p["sampler_state"]), **f32))
    return state.replace(
        control_mean=torch.tensor(_arr(p["control_mean"]), **f32),
        control_history=torch.tensor(_arr(p["control_history"]), **f32),
        previous_baseline=torch.tensor(_arr(p["previous_baseline"]), **f32),
    )


def _feedback_state(p: dict, device) -> DDPFeedbackState:
    return DDPFeedbackState(**{
        name: torch.tensor(_arr(p[name]), dtype=torch.float32, device=device)
        for name in ("gains", "x_traj", "u_traj", "total_cost")})


def _dual_state(p: dict, controller, seed, names):
    f32 = dict(dtype=torch.float32, device=controller.device)
    state = controller.init_state(seed=seed)
    return state.replace(
        nominal_initialized=bool(np.asarray(p["nominal_initialized"])),
        feedback_state=_feedback_state(p["feedback_state"], controller.device),
        **{name: torch.tensor(_arr(p[name]), **f32) for name in names})


def robust_state_from_params(p: dict, controller: RobustMPPI,
                             seed: int = 0) -> RobustControllerState:
    i64 = dict(dtype=torch.int64, device=controller.device)
    return _dual_state(p, controller, seed, (
        "control_mean", "nominal_mean", "nominal_state", "nominal_traj",
        "control_history", "nominal_control_history", "previous_baseline_real",
        "previous_baseline_nominal")).replace(
        best_index=torch.tensor(int(np.asarray(p["best_index"])), **i64),
        nominal_stride=torch.tensor(int(np.asarray(p["nominal_stride"])), **i64))


def tube_state_from_params(p: dict, controller: TubeMPPI,
                           seed: int = 0) -> TubeControllerState:
    return _dual_state(p, controller, seed, (
        "control_mean", "nominal_mean", "nominal_state", "control_history",
        "previous_baseline_real", "previous_baseline_nominal"))
