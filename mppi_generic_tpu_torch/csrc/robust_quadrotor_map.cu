// The robust family's entries of the quadrotor with its map cost (no split: the
// cost is not time-parallel): B1 from one x0 per sample (rollout_kernel.cuh:
// RMPPI's candidate nominal states, stage 1); the RMPPI rollout (B8,
// rmppi_kernel.cuh: stage 2). A source of its own per pair, so that nvcc builds
// these entries in parallel with the pair's other sources.

#include "quadrotor.cuh"
#include "quadrotor_map_cost.cuh"
#include "rmppi_kernel.cuh"
#include "rollout_kernel.cuh"

extern "C" {
ROLLOUT_ENTRY(rollout_costs_x0_quadrotor_map, Quadrotor, QuadrotorMapCost, true)
RMPPI_ENTRY(rmppi_rollout_quadrotor_map, Quadrotor, QuadrotorMapCost)
}  // extern "C"
