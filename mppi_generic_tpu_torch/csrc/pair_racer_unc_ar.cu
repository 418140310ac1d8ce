// The kernel entries of the pair RacerDubinsElevationLSTMUncertainty on flat
// ground or an elevation map (csrc/racer_lstm_unc.cuh: three LSTM steps of
// lstm.cuh, B10, the suspension and the propagated covariance) + ARStandardCost / ARRobustCost
// on the racer output layout (ARCostT<2, 3, 5, 6, 0, 1>,
// csrc/ar_standard_cost.cuh; the bench row has no costmap): the fused
// rollout (B1, rollout_kernel.cuh) and the fused solve (B3,
// sample_kernels.cuh). One library per pair, so that nvcc builds the pairs
// in parallel.

#include "ar_standard_cost.cuh"
#include "racer_lstm_unc.cuh"
#include "rollout_kernel.cuh"
#include "sample_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_racer_unc_ar, RacerLSTMUnc, ARCostRacer, false)
SOLVE_ENTRY(fused_solve_racer_unc_ar, RacerLSTMUnc, ARCostRacer)
}  // extern "C"
