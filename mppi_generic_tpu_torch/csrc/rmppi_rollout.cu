// The RMPPI kernel's (B8, csrc/rmppi_kernel.cuh) entries: the double
// integrator with its circle cost (the bench's RMPPI row) and with its robust
// cost (the JAX suite's RMPPI loop, tests/test_tube_robust.py:38-57), and the
// AutoRally network dynamics (csrc/autorally_nn.cuh, the layers' output loops
// rolled) with ARStandardCost / ARRobustCost on AutoRally's output layout
// (csrc/ar_standard_cost.cuh, the track map through map_texture.cuh).

#include "ar_standard_cost.cuh"
#include "autorally_nn.cuh"
#include "double_integrator.cuh"
#include "double_integrator_circle_cost.cuh"
#include "double_integrator_robust_cost.cuh"
#include "rmppi_kernel.cuh"

extern "C" {
RMPPI_ENTRY(rmppi_rollout_di_circle, DoubleIntegrator, DoubleIntegratorCircleCost)
RMPPI_ENTRY(rmppi_rollout_di_robust, DoubleIntegrator, DoubleIntegratorRobustCost)
RMPPI_ENTRY(rmppi_rollout_ar_nn, AutorallyNNRolled, ARCost)
}  // extern "C"
