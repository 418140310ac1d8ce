// The split-form entries (csrc/split_kernels.cuh) of the pair DoubleIntegrator
// + DoubleIntegratorCircleCost: B1's and B3's dynamics passes, B1's dynamics
// pass from one x0 per sample (the bench's RMPPI row, stage 1, with
// split_cost) and the cost pass. A source of their own, so that nvcc builds
// them beside the pair's other kernels (pair_di_circle.cu).

#include "double_integrator.cuh"
#include "double_integrator_circle_cost.cuh"
#include "split_kernels.cuh"

extern "C" {
SPLIT_ENTRY(di_circle, DoubleIntegrator, DoubleIntegratorCircleCost)
SPLIT_DYNAMICS_X0_ENTRY(di_circle, DoubleIntegrator)
}  // extern "C"
