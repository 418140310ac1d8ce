// The kernel entries of the pair Dubins + QuadraticCost (O = 3;
// csrc/dubins.cuh, csrc/quadratic_cost.cuh, the fixed goal or the goal
// trajectory): the fused rollout (B1, rollout_kernel.cuh) and the fused
// solve (B3, sample_kernels.cuh). One library per pair, so that nvcc builds
// the pairs in parallel.

#include "dubins.cuh"
#include "quadratic_cost.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_dubins_quadratic, Dubins, QuadraticCostT<3>, false)
SOLVE_ENTRY(fused_solve_dubins_quadratic, Dubins, QuadraticCostT<3>)
}  // extern "C"
