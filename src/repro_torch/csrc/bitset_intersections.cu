// All-pairs intersection popcounts of a batch of packed neighbor bitmaps.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/bitset_jaccard/kernel.py::batch_masked_intersection_kernel`
// (block function `_masked_batch_block`): for every batch row b < valid and
// every row pair (i, j) of its (G, W) uint32 bitmap,
//     out[b, i, j] = sum_w popcount(bits[b, i, w] & bits[b, j, w]),
// and out[b, i, j] = 0 for the padding rows b >= valid, which are never
// read.
//
// What bounds it on an H100: the main path calls it on tiles of
// (64, G, W) with G in 8..128 and W in 8..256 (powers of two). The work is
// G*(G+1)/2*W word pairs per row (the matrix is symmetric) against G*W*4
// bytes read and G*G*4 written. On the tensor cores' binary multiply (see
// `popc_gram.cuh`) the operations take far less than the bytes at every
// one of those shapes, so moving the rows bounds it, and at the main
// path's G = 8 and 16 the launch itself.
//
// Design: the tile routine of `popc_gram.cuh` (32 x 32 output tiles by
// `mma.m16n8k256.b1.and.popc`, rows staged in shared memory by
// double-buffered `cp.async`, fragments by `ldmatrix`). For G > 32, one
// block per (b, upper-triangle tile pair), each count written to (i, j)
// and (j, i). For G <= 32, one block per run of k = 32 / G consecutive
// groups: their k*G rows are consecutive in memory, so they form one
// diagonal tile whose G x G diagonal blocks are the groups' outputs (the
// rest of the tile is not written), and a block is not mostly idle on the
// main path's G = 8 and 16. Rows of groups b >= valid load as zero without
// a read, so their outputs are zeros.
#include <cstdint>
#include <cuda_runtime.h>

#include "popc_gram.cuh"

namespace {

using namespace popc_gram;

// per_tile > 0: G <= kTile, per_tile groups a block; else one block per
// (b, tile pair) of a T x T tile grid with `pairs` upper-triangle pairs
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    bitset_intersections_kernel(const uint32_t* __restrict__ bits,
                                int32_t* __restrict__ out, int64_t B,
                                int64_t G, int64_t W, int64_t valid,
                                int64_t per_tile, int64_t T, int64_t pairs) {
  __shared__ Stage st[kStages];
  Counts acc = {};
  if (per_tile > 0) {
    const int64_t b0 = static_cast<int64_t>(blockIdx.x) * per_tile;
    const int64_t nb = B - b0 < per_tile ? B - b0 : per_tile;
    const int64_t live = valid - b0 < nb ? valid - b0 : nb;  // groups read
    if (live > 0) {
      const Rows rows{bits + b0 * G * W, static_cast<int>(live * G)};
      gram_tile<kVec>(st, rows, rows, true, W, 0, W, acc);
    }
    // r / G as (r + 1/2) * (1/G) in f32: exact for r < kTile, G <= kTile
    // (the product is at least 1/(2G) from an integer), and far cheaper
    // than an integer division
    const int g = static_cast<int>(G), span = static_cast<int>(nb) * g;
    const float inv = 1.0f / static_cast<float>(g);
    int32_t* o = out + b0 * G * G;
    for_each_count(acc, true, [&](int r, int c, int v) {
      const int k = static_cast<int>((r + 0.5f) * inv);
      if (c < span && k == static_cast<int>((c + 0.5f) * inv)) {  // r <= c
        // group k's (i, j) = (r - kg, c - kg) lies at o[(kg + i) g + j]
        o[r * g + c - k * g] = v;
        o[c * g + r - k * g] = v;
      }
    });
    return;
  }
  const int64_t b = blockIdx.x / pairs;
  int64_t ti, tj;
  tile_pair(blockIdx.x % pairs, T, ti, tj);
  const int64_t i0 = ti * kTile, j0 = tj * kTile;
  if (b < valid) {
    const uint32_t* g = bits + b * G * W;
    gram_tile<kVec>(
        st, Rows{g + i0 * W, static_cast<int>(G - i0 < kTile ? G - i0 : kTile)},
        Rows{g + j0 * W, static_cast<int>(G - j0 < kTile ? G - j0 : kTile)},
        ti == tj, W, 0, W, acc);
  }
  int32_t* o = out + b * G * G;
  for_each_count(acc, ti == tj, [&](int r, int c, int v) {
    const int64_t i = i0 + r, j = j0 + c;
    if (i < G && j < G) {
      o[i * G + j] = v;
      o[j * G + i] = v;
    }
  });
}

}  // namespace

extern "C" int bitset_intersections_launch(const void* bits, void* out,
                                           int64_t B, int64_t G, int64_t W,
                                           int64_t valid, void* stream) {
  if (B <= 0 || G <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t per_tile = G <= kTile ? kTile / G : 0;
  const int64_t T = (G + kTile - 1) / kTile;
  const int64_t pairs = T * (T + 1) / 2;
  const int64_t blocks = per_tile ? (B + per_tile - 1) / per_tile : B * pairs;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = vec4_ok(bits, W) ? &bitset_intersections_kernel<4>
                                  : &bitset_intersections_kernel<1>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<int32_t*>(out), B, G, W,
      valid, per_tile, T, pairs);
  return static_cast<int>(cudaGetLastError());
}
