// The split-form entries (csrc/split_kernels.cuh) of the pair DoubleIntegrator
// + DoubleIntegratorRobustCost, the cost of the JAX suite's RMPPI loop: B1's
// dynamics pass from one x0 per sample (RMPPI's candidate nominal states,
// stage 1) and the cost pass. This pair has no single-x0 B1 or B3, so these
// are its only split entries.

#include "double_integrator.cuh"
#include "double_integrator_robust_cost.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_DYNAMICS_X0_ENTRY(di_robust, DoubleIntegrator)
SPLIT_COST_ENTRY(di_robust, DoubleIntegrator, DoubleIntegratorRobustCost)
}  // extern "C"
