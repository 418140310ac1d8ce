// The split-form entries (csrc/split_kernels.cuh) of the pair Dubins +
// QuadraticCost (O = 3): B1's and B3's dynamics passes and the cost pass (the
// Dubins step; the cost with a fixed goal only: a goal trajectory is refused
// before any launch, as in JAX). A source of their own, so that nvcc builds
// them in parallel with the pair's other kernels (pair_dubins_quadratic.cu).

#include "dubins.cuh"
#include "quadratic_cost.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_ENTRY(dubins_quadratic, Dubins, QuadraticCostT<3>)
}  // extern "C"
