// The robust family's entries of the racer LSTM-steering model on its elevation
// map with ARStandardCost (no B8: the JAX package refuses a recurrent model
// there, pallas_rollout.py:302, and RMPPI's stage 2 runs the eager augmented
// rollout; x comes from x0, (h, c) from the warm state for every sample, as
// pallas_rollout.py:646-662): B1 from one x0 per sample (rollout_kernel.cuh:
// RMPPI's candidate nominal states, stage 1); B1's split dynamics pass from one
// x0 per sample (split_kernels.cuh; the cost pass is
// split_racer_steering_ar.cu's). A source of its own per pair, so that nvcc
// builds these entries in parallel with the pair's other sources.

#include "ar_standard_cost.cuh"
#include "racer_lstm_steering.cuh"
#include "split_kernels.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_x0_racer_steering_ar, RacerLSTMSteering, ARCostRacer, true)
SPLIT_DYNAMICS_X0_ENTRY(racer_steering_ar, RacerLSTMSteering)
}  // extern "C"
