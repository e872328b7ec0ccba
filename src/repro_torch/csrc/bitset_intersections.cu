// All-pairs intersection popcounts of a batch of packed neighbor bitmaps.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/bitset_jaccard/kernel.py::batch_masked_intersection_kernel`
// (block function `_masked_batch_block`): for every batch row b < valid and
// every row pair (i, j) of its (G, W) uint32 bitmap,
//     out[b, i, j] = sum_w popcount(bits[b, i, w] & bits[b, j, w]),
// and out[b, i, j] = 0 for the padding rows b >= valid.
//
// What bounds it on an H100: the main path calls it on tiles of
// (64, G, W) with G in 8..128 and W in 8..256 (powers of two). The work is
// G*G*W AND+POPC pairs per row, against G*W*4 bytes read and G*G*4 written,
// so for G >= 16 the instruction throughput of the per-word-pair work (two
// loads, an AND, a POPC at quarter rate, an add) bounds it, not HBM; at
// G = 8 the output write and the launch itself dominate.
//
// Design: one thread per (b, i, j), a 16x16 thread block per (i, j) tile,
// grid.z over the batch. The TPU kernel's sequential W-grid accumulation
// becomes the in-thread loop over W words with `__popc`, so no partial sum
// leaves a register and no atomics are needed. Reads go through the
// read-only path (`__ldg`) and hit L1/L2: a block touches only 32 rows of
// one group. Staging the group in shared memory and computing only the
// upper triangle (the matrix is symmetric) are the next steps for speed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;

__global__ void bitset_intersections_kernel(const uint32_t* __restrict__ bits,
                                            int32_t* __restrict__ out,
                                            int64_t G, int64_t W,
                                            int64_t valid) {
  const int64_t b = blockIdx.z;
  const int64_t i = static_cast<int64_t>(blockIdx.y) * kTile + threadIdx.y;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (i >= G || j >= G) return;
  int32_t acc = 0;
  if (b < valid) {
    const uint32_t* ri = bits + (b * G + i) * W;
    const uint32_t* rj = bits + (b * G + j) * W;
    for (int64_t w = 0; w < W; ++w) {
      acc += __popc(__ldg(ri + w) & __ldg(rj + w));
    }
  }
  out[(b * G + i) * G + j] = acc;
}

}  // namespace

extern "C" int bitset_intersections_launch(const void* bits, void* out,
                                           int64_t B, int64_t G, int64_t W,
                                           int64_t valid, void* stream) {
  if (B <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  dim3 block(kTile, kTile);
  dim3 grid(static_cast<unsigned>((G + kTile - 1) / kTile),
            static_cast<unsigned>((G + kTile - 1) / kTile),
            static_cast<unsigned>(B));
  bitset_intersections_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<int32_t*>(out), G, W,
      valid);
  return static_cast<int>(cudaGetLastError());
}
