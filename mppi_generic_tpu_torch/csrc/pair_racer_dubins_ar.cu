// The kernel entries of the pair RacerDubins (csrc/racer_dubins.cuh) +
// ARStandardCost on the racer output layout (ARCostT<2, 3, 5, 6, 0, 1>,
// csrc/ar_standard_cost.cuh, the track costmap through map_texture.cuh): the
// fused rollout (B1, rollout_kernel.cuh), the fused solve (B3) and the fused
// sampling kernel (B4), sample_kernels.cuh, each in its staged form. One
// library per pair, so that nvcc builds the pairs in parallel.

#include "ar_standard_cost.cuh"
#include "racer_dubins.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_racer_dubins_ar, RacerDubins, ARCostRacer, false)
SOLVE_ENTRY(fused_solve_racer_dubins_ar, RacerDubins, ARCostRacer)
SAMPLE_ENTRY(fused_sample_rollout_racer_dubins_ar, RacerDubins, ARCostRacer)
}  // extern "C"
