// The fused sampling kernel (B4, sample_kernels.cuh) of the pair
// RacerElevSusp (csrc/racer_elev_susp.cuh: the steering LSTM, the suspension
// on the elevation map and the propagated covariance) + ARStandardCost on the
// racer output layout, in its recurrent mode: the LSTM's (h, c) starts from
// the model's warm state and rides the horizon loop. A source of its own, so
// that nvcc builds it in parallel with the pair's B1 and B3
// (pair_racer_elev_susp_ar.cu).

#include "ar_standard_cost.cuh"
#include "racer_elev_susp.cuh"
#include "sample_kernels.cuh"

extern "C" {
SAMPLE_ENTRY(fused_sample_rollout_racer_elev_susp_ar, RacerElevSusp, ARCostRacer)
}  // extern "C"
