// The kernel entries of the pair Quadrotor + QuadrotorMapCost
// (csrc/quadrotor.cuh, csrc/quadrotor_map_cost.cuh, the costmap through
// map_texture.cuh, B9): the fused rollout (B1, rollout_kernel.cuh) and the
// fused solve (B3, sample_kernels.cuh). One library per pair, so that nvcc
// builds the pairs in parallel.

#include "quadrotor.cuh"
#include "quadrotor_map_cost.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_quadrotor_map, Quadrotor, QuadrotorMapCost, false)
SOLVE_ENTRY(fused_solve_quadrotor_map, Quadrotor, QuadrotorMapCost)
}  // extern "C"
