// The per-sample-x0 entries of the fused rollout (B1, rollout_kernel.cuh):
// sample k starts from row k of a (K, S) x0, which is how RMPPI evaluates its
// candidate nominal states in one launch (the TPU kernel's per_sample_x0
// mode, mppi_generic_tpu/ops/pallas_rollout.py:646, :1028). Kept apart from
// the pairs' sources, whose entries take one x0, so that each source builds
// half of the rollout kernel's variants and the heaviest pair (AutoRally's
// network) builds in two processes instead of one. The pairs: the double
// integrator with its circle cost (RMPPI's), AutoRally with its costs, the
// bicycle slip with the AutoRally costs.

#include "ar_standard_cost.cuh"
#include "autorally_nn.cuh"
#include "bicycle_slip.cuh"
#include "double_integrator.cuh"
#include "double_integrator_circle_cost.cuh"
#include "rollout_kernel.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_x0_di_circle, DoubleIntegrator, DoubleIntegratorCircleCost,
              true)
ROLLOUT_ENTRY(rollout_costs_x0_ar_nn, AutorallyNN, ARCost, true)
ROLLOUT_ENTRY(rollout_costs_x0_bicycle_ar, BicycleSlip, ARCostBicycle, true)
}  // extern "C"
