// The kernel entries of the pair DoubleIntegrator + DoubleIntegratorRobustCost
// (csrc/double_integrator.cuh, csrc/double_integrator_robust_cost.cuh), the
// cost of the JAX suite's RMPPI loop, for a vanilla or Tube controller on that
// cost: the fused rollout from one x0 (B1, rollout_kernel.cuh: kernel="fused"),
// the fused solve (B3) and the fused sampling kernel (B4: Tsallis, CEM and
// Smooth-MPPI on kernel="fused_solve"), sample_kernels.cuh. Its B1 with one
// x0 per sample is in rollout_x0.cu, its split entries in split_di_robust.cu.

#include "double_integrator.cuh"
#include "double_integrator_robust_cost.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_di_robust, DoubleIntegrator, DoubleIntegratorRobustCost, false)
SOLVE_ENTRY(fused_solve_di_robust, DoubleIntegrator, DoubleIntegratorRobustCost)
SAMPLE_ENTRY(fused_sample_rollout_di_robust, DoubleIntegrator, DoubleIntegratorRobustCost)
}  // extern "C"
