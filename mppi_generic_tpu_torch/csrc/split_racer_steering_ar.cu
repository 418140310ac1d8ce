// The split-form entries (csrc/split_kernels.cuh) of the pair
// RacerDubinsElevationLSTMSteering + ARStandardCost on the racer output layout:
// B1's and B3's dynamics passes and the cost pass (the LSTM step (B10) and the
// settling on the elevation map, the (h, c) carry riding the dynamics pass; the
// cost pass evaluates AutoRally's sticky crash by dual evaluation, as for
// ar_nn). A source of their own, so that nvcc builds them in parallel with the
// pair's other kernels (pair_racer_steering_ar.cu).

#include "ar_standard_cost.cuh"
#include "racer_lstm_steering.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_ENTRY(racer_steering_ar, RacerLSTMSteering, ARCostRacer)
}  // extern "C"
