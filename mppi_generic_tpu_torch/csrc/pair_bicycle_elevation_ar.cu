// The kernel entries of the pair BicycleElevation (csrc/bicycle_elevation.cuh:
// the bicycle-slip model with the propagated covariance and static settling
// on its elevation map through map_texture.cuh, B9) + ARStandardCost on the
// racer output layout (ARCostT<2, 3, 5, 6, 0, 1>: x, y, yaw, roll, v_x and
// v_y of its 14 outputs, csrc/ar_standard_cost.cuh): the fused rollout (B1,
// rollout_kernel.cuh), the fused solve (B3) and the fused sampling kernel
// (B4), sample_kernels.cuh, each in its staged form. One library per pair,
// so that nvcc builds the pairs in parallel.

#include "ar_standard_cost.cuh"
#include "bicycle_elevation.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_bicycle_elevation_ar, BicycleElevation, ARCostRacer, false)
SOLVE_ENTRY(fused_solve_bicycle_elevation_ar, BicycleElevation, ARCostRacer)
SAMPLE_ENTRY(fused_sample_rollout_bicycle_elevation_ar, BicycleElevation, ARCostRacer)
}  // extern "C"
