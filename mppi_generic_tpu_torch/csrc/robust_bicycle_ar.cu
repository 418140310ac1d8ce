// The robust family's entries of the bicycle-slip model with the AutoRally
// costs on its output layout: B1's split dynamics pass from one x0 per sample
// (split_kernels.cuh, its lane-group form; the cost pass is
// split_bicycle_ar.cu's) and the RMPPI rollout (B8, rmppi_kernel.cuh: stage
// 2; the cost's crash is sticky, so B8 takes its one-thread form,
// rmppi_form). Its B1 from one x0 per sample is in rollout_x0.cu. A source of
// its own, so that nvcc builds these entries in parallel with the pair's
// other sources.

#include "ar_standard_cost.cuh"
#include "bicycle_slip.cuh"
#include "rmppi_kernel.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_DYNAMICS_X0_ENTRY(bicycle_ar, BicycleSlip)
RMPPI_ENTRY(rmppi_rollout_bicycle_ar, BicycleSlip, ARCostBicycle)
}  // extern "C"
