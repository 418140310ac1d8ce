// B1's split dynamics pass from one x0 per sample (csrc/split_kernels.cuh)
// for AutorallyNN (its layers unrolled as in split_ar_nn.cu): RMPPI's
// candidate nominal states in stage 1; the cost pass is split_ar_nn.cu's. A
// source of its own, so that nvcc builds it in parallel with split_ar_nn.cu:
// each unrolled network adds about as much to a source's build as that
// source takes.

#include "ar_standard_cost.cuh"
#include "autorally_nn.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_DYNAMICS_X0_ENTRY(ar_nn, AutorallyNN)
}  // extern "C"
