// The split-form entries (csrc/split_kernels.cuh) of the pair AutorallyNN
// (6-32-32-4 network, its layers unrolled as in pair_ar_nn.cu) + ARStandardCost
// / ARRobustCost on AutoRally's output layout: B1's and B3's dynamics passes
// (the network step) and the cost pass (the two map queries, the sticky crash
// by dual evaluation). A source of their own, so that nvcc builds them in
// parallel with the pair's other kernels (pair_ar_nn.cu).

#include "ar_standard_cost.cuh"
#include "autorally_nn.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_ENTRY(ar_nn, AutorallyNN, ARCost)
}  // extern "C"
