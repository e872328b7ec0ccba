// All-pairs intersection popcounts of one set of packed bitmaps:
//   out[i, j] = sum_w popcount(bits[i, w] & bits[j, w]),  bits (G, W) uint32.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/bitset_jaccard/kernel.py::pairwise_intersection_kernel`
// (block function `_jaccard_block`), which tiles the (G, G) output in
// (128, 128) blocks and streams W through VMEM in 128-word chunks, masking
// the words past W.
//
// What bounds it on an H100: G*(G+1)/2*W word pairs (the matrix is
// symmetric) against G*W*4 bytes read and G*G*4 written. On the tensor
// cores' binary multiply (see `popc_gram.cuh`) one instruction does 1,024
// word pairs, so at `group_jaccard`'s shapes (G up to 512 rows over a
// universe of thousands of words) what bounds it is moving each tile's
// rows from L2 into shared memory; the bytes read from HBM once are small.
//
// Design: the tile routine of `popc_gram.cuh` (32 x 32 output tiles by
// `mma.m16n8k256.b1.and.popc`, rows staged in shared memory by
// double-buffered `cp.async`, fragments by `ldmatrix`) over the
// upper-triangle tiles only, each count written to (i, j) and (j, i). At
// G = 512 that is 136 tiles for 132 SMs, too few and too uneven to keep
// every SM busy, so W is split into `split` (<= 8) runs of whole chunks,
// one block per (tile, run), about kUnitsPerSm blocks an SM. The blocks of
// one tile form a thread block cluster: each leaves its partial counts in
// its shared memory, and after a cluster barrier each sums a slice of the
// tile over all of them through distributed shared memory and stores it.
// Integer sums, so the order does not matter; no atomics and no zeroing
// pass.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "popc_gram.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace popc_gram;

constexpr int64_t kUnitsPerSm = 8;
constexpr int64_t kMaxSplit = 8;  // the portable cluster size

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    pairwise_intersections_kernel(const uint32_t* __restrict__ bits,
                                  int32_t* __restrict__ out, int64_t G,
                                  int64_t W, int64_t T, int64_t split,
                                  int64_t run_words) {
  static_assert(kTile * kTile * sizeof(int) <= sizeof(Stage),
                "a tile's partial counts fit in a stage");
  __shared__ Stage st[kStages];
  Counts acc = {};
  int64_t ti, tj;
  tile_pair(blockIdx.x / split, T, ti, tj);
  const int64_t w0 = (blockIdx.x % split) * run_words;
  const int64_t w1 = w0 + run_words < W ? w0 + run_words : W;
  const int64_t i0 = ti * kTile, j0 = tj * kTile;
  const bool diag = ti == tj;
  gram_tile<kVec>(
      st, Rows{bits + i0 * W, static_cast<int>(G - i0 < kTile ? G - i0 : kTile)},
      Rows{bits + j0 * W, static_cast<int>(G - j0 < kTile ? G - j0 : kTile)},
      diag, W, w0, w1, acc);
  int* part = reinterpret_cast<int*>(st);  // this block's partial tile
  __syncthreads();  // every warp is done with the stages
  for_each_count(acc, diag, [&](int r, int c, int v) { part[r * kTile + c] = v; });
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block of the tile has its partial in place
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = rank * kThreads + threadIdx.x; e < kTile * kTile;
       e += static_cast<int>(split) * kThreads) {
    const int r = e / kTile, c = e % kTile;
    const int64_t i = i0 + r, j = j0 + c;
    if ((diag && r > c) || i >= G || j >= G) continue;  // r > c: not computed
    int sum = 0;
    for (int q = 0; q < split; ++q) sum += cluster.map_shared_rank(part, q)[e];
    out[i * G + j] = sum;
    out[j * G + i] = sum;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

}  // namespace

// `sms`: the device's SM count (the caller reads it once, so a launch makes
// no runtime query)
extern "C" int pairwise_intersections_launch(const void* bits, void* out,
                                             int64_t G, int64_t W,
                                             int64_t sms, void* stream) {
  if (G <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t T = (G + kTile - 1) / kTile;
  const int64_t pairs = T * (T + 1) / 2;
  // runs of whole chunks, about kUnitsPerSm blocks an SM in all
  const int64_t chunks = (W + kChunk - 1) / kChunk;
  int64_t split = (kUnitsPerSm * sms + pairs - 1) / pairs;
  split = split < kMaxSplit ? split : kMaxSplit;
  split = split < chunks ? split : (chunks > 1 ? chunks : 1);
  const int64_t run_chunks = chunks > 0 ? (chunks + split - 1) / split : 1;
  split = chunks > 0 ? (chunks + run_chunks - 1) / run_chunks : 1;
  if (pairs * split > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(split);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(pairs * split));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  auto* kernel = vec4_ok(bits, W) ? &pairwise_intersections_kernel<4>
                                  : &pairwise_intersections_kernel<1>;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint32_t*>(bits),
      static_cast<int32_t*>(out), G, W, T, split, run_chunks * kChunk);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
