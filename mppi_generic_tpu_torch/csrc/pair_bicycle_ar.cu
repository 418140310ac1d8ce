// The kernel entry of the pair BicycleSlip (csrc/bicycle_slip.cuh) +
// ARStandardCost / ARRobustCost on the bicycle's output layout
// (ARCostT<0, 1, 2, 8, 5, 6>, csrc/ar_standard_cost.cuh): the fused rollout
// (B1, rollout_kernel.cuh). One library per pair, so that nvcc builds the
// pairs in parallel.

#include "ar_standard_cost.cuh"
#include "bicycle_slip.cuh"
#include "rollout_kernel.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_bicycle_ar, BicycleSlip, ARCostBicycle, false)
}  // extern "C"
