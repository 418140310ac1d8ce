from mppi_generic_tpu_torch.ops.fused_rollout import (
    flash_combine,
    fused_rollout_costs,
    fused_weighted_rollout,
    launch_counts,
    reset_launch_counts,
)
from mppi_generic_tpu_torch.ops.rollout import rollout_combined
from mppi_generic_tpu_torch.ops.weights import (
    FreeEnergyStats,
    compute_free_energy,
    norm_exp_weights,
)

__all__ = [
    "FreeEnergyStats",
    "compute_free_energy",
    "flash_combine",
    "fused_rollout_costs",
    "fused_weighted_rollout",
    "launch_counts",
    "norm_exp_weights",
    "reset_launch_counts",
    "rollout_combined",
]
