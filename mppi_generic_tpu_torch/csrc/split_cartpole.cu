// The split-form entries (csrc/split_kernels.cuh) of the pair Cartpole +
// CartpoleQuadraticCost: B1's and B3's dynamics passes and the cost pass (the
// cartpole step; the cost reads no crash). A source of their own, so that nvcc
// builds them in parallel with the pair's other kernels (pair_cartpole.cu).

#include "cartpole.cuh"
#include "cartpole_quadratic_cost.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_ENTRY(cartpole, Cartpole, CartpoleQuadraticCost)
}  // extern "C"
