"""Build the port's objects from parameters carried across from JAX.

Each function here takes a dict of numpy arrays (or numbers) keyed by the JAX
package's field names, so that a JAX object and its counterpart here share
the same parameters. The dicts are made on the JAX side; nothing here
imports JAX.

* dynamics: ``control_ranges``, ``control_deadband``, ``zero_control``,
  ``system_noise``;
* cost: ``velocity_cost``, ``crash_cost``, ``velocity_desired``,
  ``inner_path_radius2``, ``outer_path_radius2``,
  ``angular_momentum_desired``, ``discount``;
* sampler: ``std_dev``, ``control_cost_coeff``, ``pure_noise_percentage``,
  ``std_dev_decay``;
* controller: ``dt``, ``lam``, ``alpha``, ``num_timesteps``,
  ``num_rollouts``, ``num_iters``;
* state: ``control_mean``, ``control_history``, ``previous_baseline``.
"""

from __future__ import annotations

import numpy as np
import torch

from mppi_generic_tpu_torch.controllers.base import ControllerState
from mppi_generic_tpu_torch.controllers.vanilla import VanillaMPPI
from mppi_generic_tpu_torch.costs.double_integrator import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution


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


def circle_cost_from_params(p: dict, device="cpu") -> DoubleIntegratorCircleCost:
    return DoubleIntegratorCircleCost(
        **{name: _scalar(p[name]) for name in DoubleIntegratorCircleCost.PARAM_NAMES},
        device=device,
    )


def gaussian_from_params(p: dict, device="cpu") -> GaussianDistribution:
    return GaussianDistribution(
        std_dev=_arr(p["std_dev"]),
        control_cost_coeff=_arr(p["control_cost_coeff"]),
        pure_noise_percentage=_scalar(p["pure_noise_percentage"]),
        std_dev_decay=_scalar(p["std_dev_decay"]),
        device=device,
    )


def vanilla_from_params(dynamics: dict, cost: dict, sampler: dict,
                        controller: dict, device=None,
                        kernel="fused") -> VanillaMPPI:
    """A DI circle-cost Gaussian ``VanillaMPPI`` (device rule as
    ``VanillaMPPI``: the card unless ``device="cpu"``)."""
    return VanillaMPPI(
        double_integrator_from_params(dynamics),
        circle_cost_from_params(cost),
        gaussian_from_params(sampler),
        dt=_scalar(controller["dt"]),
        lam=_scalar(controller["lam"]),
        alpha=_scalar(controller["alpha"]),
        num_timesteps=int(controller["num_timesteps"]),
        num_rollouts=int(controller["num_rollouts"]),
        num_iters=int(controller["num_iters"]),
        kernel=kernel,
        device=device,
    )


def state_from_params(p: dict, controller: VanillaMPPI,
                      seed: int = 0) -> ControllerState:
    f32 = dict(dtype=torch.float32, device=controller.device)
    state = controller.init_state(seed=seed)
    return state.replace(
        control_mean=torch.tensor(_arr(p["control_mean"]), **f32),
        control_history=torch.tensor(_arr(p["control_history"]), **f32),
        previous_baseline=torch.tensor(_arr(p["previous_baseline"]), **f32),
    )
