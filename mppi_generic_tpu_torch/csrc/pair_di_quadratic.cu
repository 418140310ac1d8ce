// The kernel entries of the pair DoubleIntegrator + QuadraticCost (O = 4;
// csrc/double_integrator.cuh, csrc/quadratic_cost.cuh, the fixed goal or the
// goal trajectory), the pair of examples/double_integrator_example.py: the
// fused rollout (B1, rollout_kernel.cuh), the fused solve (B3) and the fused
// sampling kernel (B4: Tsallis, CEM and Smooth-MPPI on kernel="fused_solve"),
// sample_kernels.cuh. One library per pair, so that nvcc builds the pairs in
// parallel.

#include "double_integrator.cuh"
#include "quadratic_cost.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_di_quadratic, DoubleIntegrator, QuadraticCostT<4>, false)
SOLVE_ENTRY(fused_solve_di_quadratic, DoubleIntegrator, QuadraticCostT<4>)
SAMPLE_ENTRY(fused_sample_rollout_di_quadratic, DoubleIntegrator, QuadraticCostT<4>)
}  // extern "C"
