// The kernel entries of the pair Quadrotor + QuadrotorQuadraticCost
// (csrc/quadrotor.cuh, csrc/quadrotor_quadratic_cost.cuh): the fused rollout
// (B1, rollout_kernel.cuh), the fused solve (B3) and the fused sampling
// kernel (B4: Tsallis, CEM and Smooth-MPPI on kernel="fused_solve"),
// sample_kernels.cuh. One library per pair, so that nvcc builds the pairs in
// parallel.

#include "quadrotor.cuh"
#include "quadrotor_quadratic_cost.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_quadrotor_quadratic, Quadrotor, QuadrotorQuadraticCost, false)
SOLVE_ENTRY(fused_solve_quadrotor_quadratic, Quadrotor, QuadrotorQuadraticCost)
SAMPLE_ENTRY(fused_sample_rollout_quadrotor_quadratic, Quadrotor, QuadrotorQuadraticCost)
}  // extern "C"
