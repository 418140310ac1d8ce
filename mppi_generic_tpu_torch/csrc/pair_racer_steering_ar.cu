// The kernel entries of the pair RacerDubinsElevationLSTMSteering
// (csrc/racer_lstm_steering.cuh: the LSTM step of lstm.cuh, B10, and static
// settling on the elevation map through map_texture.cuh, B9) +
// ARStandardCost / ARRobustCost on the racer output layout
// (ARCostT<2, 3, 5, 6, 0, 1>, csrc/ar_standard_cost.cuh, the track costmap
// through map_texture.cuh): the fused rollout (B1, rollout_kernel.cuh) and
// the fused solve (B3, sample_kernels.cuh). One library per pair, so that
// nvcc builds the pairs in parallel.

#include "ar_standard_cost.cuh"
#include "racer_lstm_steering.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_racer_steering_ar, RacerLSTMSteering, ARCostRacer, false)
SOLVE_ENTRY(fused_solve_racer_steering_ar, RacerLSTMSteering, ARCostRacer)
}  // extern "C"
