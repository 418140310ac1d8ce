// The split-form entries (csrc/split_kernels.cuh) of the pair DoubleIntegrator
// + DoubleIntegratorRobustCost, the cost of the JAX suite's RMPPI loop: B1's
// and B3's dynamics passes from one x0 (a vanilla or Tube controller on that
// cost with split_cost), B1's dynamics pass from one x0 per sample (RMPPI's
// candidate nominal states, stage 1) and the cost pass.

#include "double_integrator.cuh"
#include "double_integrator_robust_cost.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_ENTRY(di_robust, DoubleIntegrator, DoubleIntegratorRobustCost)
SPLIT_DYNAMICS_X0_ENTRY(di_robust, DoubleIntegrator)
}  // extern "C"
