// The split-form entries (csrc/split_kernels.cuh) of the pair
// RacerDubinsElevationLSTMUncertainty (flat ground or a map) + ARStandardCost
// on the racer output layout: B1's and B3's dynamics passes and the cost pass (the
// three LSTM steps, the suspension and the covariance, the (h, c) carries
// riding the dynamics pass; the cost pass evaluates AutoRally's sticky crash by
// dual evaluation, as for ar_nn). A source of their own, so that nvcc builds
// them in parallel with the pair's other kernels (pair_racer_unc_ar.cu).

#include "ar_standard_cost.cuh"
#include "racer_lstm_unc.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_ENTRY(racer_unc_ar, RacerLSTMUnc, ARCostRacer)
}  // extern "C"
