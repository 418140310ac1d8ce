// The kernel entries of the pair RacerElevSusp (csrc/racer_elev_susp.cuh: the
// steering LSTM step of lstm.cuh, B10, the four-wheel suspension on the
// elevation map through map_texture.cuh, B9, and the propagated covariance)
// + ARStandardCost on the racer output layout (ARCostT<2, 3, 5, 6, 0, 1>,
// csrc/ar_standard_cost.cuh): the fused rollout (B1, rollout_kernel.cuh) and
// the fused solve (B3, sample_kernels.cuh), each in its warp form. One
// library per pair, so that nvcc builds the pairs in parallel; B4 is in
// sample_racer_elev_susp_ar.cu.

#include "ar_standard_cost.cuh"
#include "racer_elev_susp.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_racer_elev_susp_ar, RacerElevSusp, ARCostRacer, false)
SOLVE_ENTRY(fused_solve_racer_elev_susp_ar, RacerElevSusp, ARCostRacer)
}  // extern "C"
