// The split-form entries (csrc/split_kernels.cuh) of the pair DoubleIntegrator
// + QuadraticCost (O = 4): B1's and B3's dynamics passes and the cost pass (the
// Euler step; the cost with a fixed goal only: a goal trajectory is refused
// before any launch, as in JAX). A source of their own, so that nvcc builds
// them in parallel with the pair's other kernels (pair_di_quadratic.cu).

#include "double_integrator.cuh"
#include "quadratic_cost.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_ENTRY(di_quadratic, DoubleIntegrator, QuadraticCostT<4>)
}  // extern "C"
