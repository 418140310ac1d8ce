// The kernel entries of the pair DoubleIntegrator + DoubleIntegratorCircleCost
// (csrc/double_integrator.cuh, csrc/double_integrator_circle_cost.cuh): the
// fused rollout (B1, rollout_kernel.cuh; its per-sample-x0 entry for RMPPI's
// candidates is in rollout_x0.cu), the fused solve (B3) and the fused
// sampling kernel (B4, sample_kernels.cuh). One library per pair, so that
// nvcc builds the pairs in parallel.

#include "double_integrator.cuh"
#include "double_integrator_circle_cost.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_di_circle, DoubleIntegrator, DoubleIntegratorCircleCost, false)
SOLVE_ENTRY(fused_solve_di_circle, DoubleIntegrator, DoubleIntegratorCircleCost)
SAMPLE_ENTRY(fused_sample_rollout_di_circle, DoubleIntegrator,
             DoubleIntegratorCircleCost)
}  // extern "C"
