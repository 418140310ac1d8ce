// The robust family's entries of the racer LSTM-uncertainty model with
// ARStandardCost (no B8, as for the steering model; x from x0, (h, c) from the
// warm state): B1 from one x0 per sample (rollout_kernel.cuh: RMPPI's candidate
// nominal states, stage 1); B1's split dynamics pass from one x0 per sample
// (split_kernels.cuh; the cost pass is split_racer_unc_ar.cu's). A source of
// its own per pair, so that nvcc builds these entries in parallel with the
// pair's other sources.

#include "ar_standard_cost.cuh"
#include "racer_lstm_unc.cuh"
#include "split_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_x0_racer_unc_ar, RacerLSTMUnc, ARCostRacer, true)
SPLIT_DYNAMICS_X0_ENTRY(racer_unc_ar, RacerLSTMUnc)
}  // extern "C"
