// The model traits of the warp form (one warp per sample, one network unit
// per lane): which models have it and how a kernel stages their table and
// starts their carry. The split dynamics passes (split_warp.cuh), B4's warp
// form (sample_warp.cuh) and B8's (rmppi_warp.cuh) include this header, and
// each entry picks its form at compile time from HasWarpStep<Dyn>.
#pragma once

#include <type_traits>

#include "mppi_common.cuh"
#include "warp.cuh"

namespace {

// A model with the warp form declares kWarpStep = true, kWarpSamples (the
// samples, one warp each, of a block) and has stage_warp(params[, dyn_map],
// sh), step_warp(sh, x, rec, u, t, dt, y) and, if recurrent, RW (the warp
// form's carry floats) and init_rec_warp(sh, rec). On an H100 AutoRally's
// small table (5.6 KB) takes 4 samples a block, whose finer blocks balance
// the SMs better (RMPPI's 2,304 samples: 576 blocks), and the racer models'
// tables (7 and 26 KB), staged by every block, take 8 (PERF.md §6).
template <class D, class = void>
struct HasWarpStep : std::false_type {};
template <class D>
struct HasWarpStep<D, std::void_t<decltype(D::kWarpStep)>>
    : std::integral_constant<bool, D::kWarpStep> {};

template <class D, class = void>
struct WarpRecDim {
  static constexpr int value = 0;
};
template <class D>
struct WarpRecDim<D, std::void_t<decltype(D::RW)>> {
  static constexpr int value = D::RW;
};

template <class Dyn>
__device__ inline void stage_model_warp(const ModelArgs& m, typename Dyn::Shared* sh) {
  if constexpr (ReadsDynMap<Dyn>::value) {
    Dyn::stage_warp(m.dyn_params, m.dyn_map, sh);
  } else {
    Dyn::stage_warp(m.dyn_params, sh);
  }
}

template <class Dyn>
__device__ inline void init_rec_warp(const typename Dyn::Shared& sh, float* rec) {
  if constexpr (WarpRecDim<Dyn>::value > 0) Dyn::init_rec_warp(sh, rec);
}

}  // namespace
