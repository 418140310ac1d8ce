// The fused sampling kernel (B4, sample_kernels.cuh) of the pair
// RacerDubinsElevationLSTMSteering (csrc/racer_lstm_steering.cuh: the LSTM
// step of lstm.cuh, B10, and the settling on the elevation map) +
// ARStandardCost on the racer output layout, in its recurrent mode: the
// (h, c) carry starts from the model's warm state and rides the horizon loop,
// as the TPU kernel carries it (pallas_rollout.py:1746, :1822). A source of
// its own, so that nvcc builds it in parallel with the pair's B1 and B3
// (pair_racer_steering_ar.cu).

#include "ar_standard_cost.cuh"
#include "racer_lstm_steering.cuh"
#include "sample_kernels.cuh"

extern "C" {
SAMPLE_ENTRY(fused_sample_rollout_racer_steering_ar, RacerLSTMSteering, ARCostRacer)
}  // extern "C"
