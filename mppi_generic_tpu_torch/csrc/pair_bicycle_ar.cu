// The kernel entries of the pair BicycleSlip (csrc/bicycle_slip.cuh) +
// ARStandardCost / ARRobustCost on the bicycle's output layout
// (ARCostT<0, 1, 2, 8, 5, 6>, csrc/ar_standard_cost.cuh): the fused rollout
// (B1, rollout_kernel.cuh), the fused solve (B3: the Gaussian and NLN
// samplers on kernel="fused_solve") and the fused sampling kernel (B4:
// Tsallis, CEM and Smooth-MPPI there), sample_kernels.cuh. One library per
// pair, so that nvcc builds the pairs in parallel.

#include "ar_standard_cost.cuh"
#include "bicycle_slip.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_bicycle_ar, BicycleSlip, ARCostBicycle, false)
SOLVE_ENTRY(fused_solve_bicycle_ar, BicycleSlip, ARCostBicycle)
SAMPLE_ENTRY(fused_sample_rollout_bicycle_ar, BicycleSlip, ARCostBicycle)
}  // extern "C"
