// The robust family's entries of the double integrator with QuadraticCost: B1
// from one x0 per sample (rollout_kernel.cuh: RMPPI's candidate nominal states,
// stage 1); B1's split dynamics pass from one x0 per sample (split_kernels.cuh;
// the cost pass is split_di_quadratic.cu's); the RMPPI rollout (B8,
// rmppi_kernel.cuh: stage 2). A source of its own per pair, so that nvcc builds
// these entries in parallel with the pair's other sources.

#include "double_integrator.cuh"
#include "quadratic_cost.cuh"
#include "rmppi_kernel.cuh"
#include "split_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_x0_di_quadratic, DoubleIntegrator, QuadraticCostT<4>, true)
SPLIT_DYNAMICS_X0_ENTRY(di_quadratic, DoubleIntegrator)
RMPPI_ENTRY(rmppi_rollout_di_quadratic, DoubleIntegrator, QuadraticCostT<4>)
}  // extern "C"
