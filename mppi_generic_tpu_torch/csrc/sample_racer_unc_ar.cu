// The fused sampling kernel (B4, sample_kernels.cuh) of the pair
// RacerDubinsElevationLSTMUncertainty on flat ground or an elevation map
// (csrc/racer_lstm_unc.cuh: three LSTM steps, the suspension and the
// propagated covariance) +
// ARStandardCost on the racer output layout, in its recurrent mode: each
// LSTM's (h, c) starts from the model's warm state and rides the horizon
// loop, as the TPU kernel carries it (pallas_rollout.py:1746, :1822). A
// source of its own, so that nvcc builds it in parallel with the pair's B1
// and B3 (pair_racer_unc_ar.cu).

#include "ar_standard_cost.cuh"
#include "racer_lstm_unc.cuh"
#include "sample_kernels.cuh"

extern "C" {
SAMPLE_ENTRY(fused_sample_rollout_racer_unc_ar, RacerLSTMUnc, ARCostRacer)
}  // extern "C"
