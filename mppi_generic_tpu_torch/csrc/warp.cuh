// What the warp form of the network steps shares (fnn.cuh forward_warp,
// lstm.cuh forward_warp, split_warp.cuh): one warp per sample, one output
// unit per lane.
#pragma once

// every lane of a warp takes part in each shuffle
constexpr unsigned kFullMask = 0xffffffffu;

// The slot of entry i of a weight block W (OUT, IN) row-major at offset off
// (off <= i) in the warp form's table, where the block is stored transposed,
// W^T (IN, OUT): the 32 lanes, one output row each, then read 32 consecutive
// words. Entries past the block (a bias) keep their slot.
__host__ __device__ constexpr int transposed_slot(int i, int off, int in, int out) {
  return i - off >= in * out ? i : off + ((i - off) % in) * out + (i - off) / in;
}
