// The kernel entries of the pair RacerElevation (csrc/racer_dubins.cuh: the
// RACER Dubins elevation model without an LSTM, static settling on its
// elevation map through map_texture.cuh, B9) + ARStandardCost on the racer
// output layout (ARCostT<2, 3, 5, 6, 0, 1>, csrc/ar_standard_cost.cuh): the
// fused rollout (B1, rollout_kernel.cuh), the fused solve (B3) and the fused
// sampling kernel (B4), sample_kernels.cuh, each in its staged form. One
// library per pair, so that nvcc builds the pairs in parallel.

#include "ar_standard_cost.cuh"
#include "racer_dubins.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_racer_elevation_ar, RacerElevation, ARCostRacer, false)
SOLVE_ENTRY(fused_solve_racer_elevation_ar, RacerElevation, ARCostRacer)
SAMPLE_ENTRY(fused_sample_rollout_racer_elevation_ar, RacerElevation, ARCostRacer)
}  // extern "C"
