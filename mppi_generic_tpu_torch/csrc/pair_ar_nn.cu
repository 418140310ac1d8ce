// The kernel entries of the pair AutorallyNN (6-32-32-4 network,
// csrc/autorally_nn.cuh with the FNN of fnn.cuh, B10) + ARStandardCost /
// ARRobustCost on AutoRally's output layout (csrc/ar_standard_cost.cuh, the
// costmap through map_texture.cuh, B9): the fused rollout (B1,
// rollout_kernel.cuh) and the fused solve (B3, sample_kernels.cuh). One
// library per pair, so that nvcc builds the pairs in parallel.

#include "ar_standard_cost.cuh"
#include "autorally_nn.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_ar_nn, AutorallyNN, ARCost, false)
SOLVE_ENTRY(fused_solve_ar_nn, AutorallyNN, ARCost)
}  // extern "C"
