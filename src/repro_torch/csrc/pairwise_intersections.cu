// All-pairs intersection popcounts of one set of packed bitmaps:
//   out[i, j] = sum_w popcount(bits[i, w] & bits[j, w]),  bits (G, W) uint32.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/bitset_jaccard/kernel.py::pairwise_intersection_kernel`
// (block function `_jaccard_block`), which tiles the (G, G) output in
// (128, 128) blocks and streams W through VMEM in 128-word chunks, masking
// the words past W.
//
// What bounds it on an H100: G*G*W word pairs (an AND, a POPC at a quarter
// of the integer rate, an add) against G*W*4 bytes read and G*G*4 written.
// At `group_jaccard`'s shapes (G up to 512 rows over a universe of
// thousands of words) the POPC rate bounds it, by two orders of magnitude
// over the bytes, provided each row is read from HBM only a few times.
//
// Why not the batched kernel (`bitset_intersections.cu`) with a batch of
// one: that kernel gives each (i, j) pair one thread that loops over all W
// words from global memory, which suits its small groups (G <= 128, W <=
// 256) but here re-reads every row G times: 512 * 512 * W words through
// L1/L2 instead of 512 * W.
//
// Design: one block per 32 x 32 output tile, 32 x 8 threads, each thread
// owning one column j and four rows i (i = ty + 8k) and their four counts in
// registers. The block stages 32 words of its 32 row bitmaps and its 32
// column bitmaps in shared memory per step (each warp loads 128 contiguous
// bytes of a row), so each word read from global memory serves 32 outputs.
// The tiles are padded to 33 words per row: a warp then reads its 32
// columns' word from 32 distinct banks, and the row word is one broadcast.
// Rows past G and words past W load as 0 and add nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;   // output rows and columns per block
constexpr int kYs = 8;      // threadIdx.y extent; rows per thread = kTile / kYs
constexpr int kWords = 32;  // words staged per step

__global__ void pairwise_intersections_kernel(const uint32_t* __restrict__ bits,
                                              int32_t* __restrict__ out,
                                              int64_t G, int64_t W) {
  __shared__ uint32_t sa[kTile][kWords + 1];
  __shared__ uint32_t sb[kTile][kWords + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTile;
  int32_t acc[kTile / kYs] = {0, 0, 0, 0};
  for (int64_t w0 = 0; w0 < W; w0 += kWords) {
    const int64_t w = w0 + tx;
#pragma unroll
    for (int k = 0; k < kTile / kYs; ++k) {
      const int r = ty + kYs * k;
      const int64_t ia = i0 + r;
      const int64_t jb = j0 + r;
      sa[r][tx] = (ia < G && w < W) ? __ldg(bits + ia * W + w) : 0u;
      sb[r][tx] = (jb < G && w < W) ? __ldg(bits + jb * W + w) : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kWords; ++kk) {
      const uint32_t col = sb[tx][kk];
#pragma unroll
      for (int k = 0; k < kTile / kYs; ++k) {
        acc[k] += __popc(sa[ty + kYs * k][kk] & col);
      }
    }
    __syncthreads();
  }
  const int64_t j = j0 + tx;
#pragma unroll
  for (int k = 0; k < kTile / kYs; ++k) {
    const int64_t i = i0 + ty + kYs * k;
    if (i < G && j < G) out[i * G + j] = acc[k];
  }
}

}  // namespace

extern "C" int pairwise_intersections_launch(const void* bits, void* out,
                                             int64_t G, int64_t W,
                                             void* stream) {
  if (G <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned tiles = static_cast<unsigned>((G + kTile - 1) / kTile);
  dim3 grid(tiles, tiles);
  dim3 block(kTile, kYs);
  pairwise_intersections_kernel<<<grid, block, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<int32_t*>(out), G, W);
  return static_cast<int>(cudaGetLastError());
}
