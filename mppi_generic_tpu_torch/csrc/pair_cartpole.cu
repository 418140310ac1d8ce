// The kernel entries of the pair Cartpole + CartpoleQuadraticCost
// (csrc/cartpole.cuh, csrc/cartpole_quadratic_cost.cuh): the fused rollout
// (B1, rollout_kernel.cuh), the fused solve (B3, the bench row
// cartpole_example_K8192) and the fused sampling kernel (B4, Tsallis, CEM
// and Smooth-MPPI on kernel="fused_solve"), sample_kernels.cuh. One library
// per pair, so that nvcc builds the pairs in parallel.

#include "cartpole.cuh"
#include "cartpole_quadratic_cost.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_cartpole, Cartpole, CartpoleQuadraticCost, false)
SOLVE_ENTRY(fused_solve_cartpole, Cartpole, CartpoleQuadraticCost)
SAMPLE_ENTRY(fused_sample_rollout_cartpole, Cartpole, CartpoleQuadraticCost)
}  // extern "C"
