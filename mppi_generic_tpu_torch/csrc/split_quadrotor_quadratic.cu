// The split-form entries (csrc/split_kernels.cuh) of the pair Quadrotor +
// QuadrotorQuadraticCost: B1's and B3's dynamics passes and the cost pass (the
// quadrotor step; the cost reads no crash). A source of their own, so that nvcc
// builds them in parallel with the pair's other kernels
// (pair_quadrotor_quadratic.cu).

#include "quadrotor.cuh"
#include "quadrotor_quadratic_cost.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_ENTRY(quadrotor_quadratic, Quadrotor, QuadrotorQuadraticCost)
}  // extern "C"
