from mppi_generic_tpu_torch.ops._build import launch_counts, reset_launch_counts
from mppi_generic_tpu_torch.ops.autotune import (
    DEFAULT_CANDIDATES,
    choose_appropriate_kernel,
    time_solve,
)
from mppi_generic_tpu_torch.ops.fused_rollout import (
    KernelIncompatible,
    flash_combine,
    fused_rmppi_rollout,
    fused_rollout_costs,
    fused_sample_rollout_costs,
    fused_weighted_rollout,
    tsallis_reduce,
)
from mppi_generic_tpu_torch.ops.fused_solve import fused_solve_iteration
from mppi_generic_tpu_torch.ops.riccati import riccati_backward, riccati_ladder_solve
from mppi_generic_tpu_torch.ops.rollout import (
    rollout_combined,
    rollout_outputs,
    trajectory_state_costs,
)
from mppi_generic_tpu_torch.ops.weights import (
    FreeEnergyStats,
    cem_weights,
    compute_free_energy,
    norm_exp_weights,
    tsallis_weights,
)

__all__ = [
    "DEFAULT_CANDIDATES",
    "FreeEnergyStats",
    "KernelIncompatible",
    "cem_weights",
    "choose_appropriate_kernel",
    "compute_free_energy",
    "flash_combine",
    "fused_rmppi_rollout",
    "fused_rollout_costs",
    "fused_sample_rollout_costs",
    "fused_solve_iteration",
    "fused_weighted_rollout",
    "launch_counts",
    "norm_exp_weights",
    "reset_launch_counts",
    "riccati_backward",
    "riccati_ladder_solve",
    "rollout_combined",
    "rollout_outputs",
    "time_solve",
    "trajectory_state_costs",
    "tsallis_reduce",
    "tsallis_weights",
]
