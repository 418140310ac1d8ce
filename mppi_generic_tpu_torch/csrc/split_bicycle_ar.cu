// The split-form entries (csrc/split_kernels.cuh) of the pair BicycleSlip +
// ARStandardCost / ARRobustCost on the bicycle's output layout: B1's and B3's
// dynamics passes and the cost pass (the bicycle step; the cost pass evaluates
// AutoRally's sticky crash by dual evaluation, as for ar_nn). A source of their
// own, so that nvcc builds them in parallel with the pair's other kernels
// (pair_bicycle_ar.cu).

#include "ar_standard_cost.cuh"
#include "bicycle_slip.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_ENTRY(bicycle_ar, BicycleSlip, ARCostBicycle)
}  // extern "C"
