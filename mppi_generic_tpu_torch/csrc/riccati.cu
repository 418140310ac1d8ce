// The entries of the DDP kernels (csrc/riccati_kernels.cuh): the backward
// recursion (B6, over a warp) for (S, C) = (4, 2), the double integrator's
// sizes, (4, 1), the cartpole's, and (7, 2), AutoRally's; the line-search
// ladder (B7) for the double integrator, the cartpole, the Dubins car (its
// derivative unwrapped, as the TPU kernel steps it) and the AutoRally network
// (its layers' output loops rolled; the warp form's network is
// FNN3::forward_warp).

#include "autorally_nn.cuh"
#include "cartpole.cuh"
#include "double_integrator.cuh"
#include "dubins.cuh"
#include "riccati_kernels.cuh"

extern "C" {

// Most line-search steps one ladder launch takes.
int riccati_max_alphas() { return kMaxAlphas; }

// Which ladder kernel the LADDER_ENTRY entries launch: 1 the warp form
// (riccati_ladder_warp_kernel), 0 the one-thread kernel
// (riccati_ladder_kernel, built with -DMPPI_LADDER_ONE_THREAD).
int riccati_ladder_form() { return kLadderForm; }

// Which backward kernel the BACKWARD_ENTRY entries launch: 1 the warp form
// (riccati_backward_warp_kernel), 0 the one-thread kernel
// (riccati_backward_kernel, built with -DMPPI_BACKWARD_ONE_THREAD).
int riccati_backward_form() { return kBackwardForm; }

BACKWARD_ENTRY(riccati_backward_s4c2, 4, 2)
BACKWARD_ENTRY(riccati_backward_s4c1, 4, 1)
BACKWARD_ENTRY(riccati_backward_s7c2, 7, 2)
LADDER_ENTRY(riccati_ladder_di, DoubleIntegrator)
LADDER_ENTRY(riccati_ladder_cartpole, Cartpole)
LADDER_ENTRY(riccati_ladder_dubins, Dubins)
LADDER_ENTRY(riccati_ladder_ar_nn, AutorallyNNRolled)

}  // extern "C"
