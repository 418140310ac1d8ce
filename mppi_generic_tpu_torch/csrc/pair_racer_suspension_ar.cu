// The kernel entries of the pair RacerSuspension (csrc/racer_suspension.cuh:
// the rigid body on four spring-damper wheels, the terrain under each wheel
// through map_texture.cuh, B9) + ARStandardCost on the layout the JAX
// package's kernel test of the model reads (ARCostSuspension =
// ARCostT<0, 1, 5, 6, 3, 4>, csrc/ar_standard_cost.cuh): the fused rollout
// (B1, rollout_kernel.cuh), the fused solve (B3) and the fused sampling
// kernel (B4), sample_kernels.cuh, each in its staged form. One library per
// pair, so that nvcc builds the pairs in parallel.

#include "ar_standard_cost.cuh"
#include "racer_suspension.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_racer_suspension_ar, RacerSuspension, ARCostSuspension, false)
SOLVE_ENTRY(fused_solve_racer_suspension_ar, RacerSuspension, ARCostSuspension)
SAMPLE_ENTRY(fused_sample_rollout_racer_suspension_ar, RacerSuspension, ARCostSuspension)
}  // extern "C"
