// The fused sampling kernel (B4, sample_kernels.cuh) of the pair AutorallyNN
// (6-32-32-4 network, its layers unrolled as in pair_ar_nn.cu) +
// ARStandardCost / ARRobustCost on AutoRally's output layout: Tsallis, CEM and
// Smooth-MPPI on kernel="fused_solve". A source of its own, so that nvcc
// builds it in parallel with the pair's B1 and B3 (pair_ar_nn.cu): each
// unrolled network adds about as much to a source's build as that source
// takes.

#include "ar_standard_cost.cuh"
#include "autorally_nn.cuh"
#include "sample_kernels.cuh"

extern "C" {
SAMPLE_ENTRY(fused_sample_rollout_ar_nn, AutorallyNN, ARCost)
}  // extern "C"
