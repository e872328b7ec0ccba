// Row minimum of the shingle hash over fixed-width packed adjacency rows:
//   out[r] = min over w < W with nbr[r, w] != 0xFFFFFFFF of h(nbr[r, w]),
//   h(x) = x*a + b; h ^= h >> 16; h *= 0x7FEB352D; h ^= h >> 15  (mod 2^32),
// and 0xFFFFFFFF for a row of sentinels only.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/minhash/kernel.py::rowmin_hash_kernel` (block function
// `_minhash_block`), which streams (BR, BW) blocks through VMEM and reduces
// the W axis across sequential grid steps into the (BR,) output block.
//
// What bounds it on an H100: each word is read once (4 bytes) and costs
// about nine 32-bit integer operations (two multiplies, an add, two shifts,
// two xors, the sentinel compare and the min); at 4 bytes per nine
// operations HBM is the limit, not the integer lanes. R*W*4 bytes are read
// and R*4 written.
//
// Design: one warp per row, in a grid-stride loop over rows. The lanes take
// the row's words 32 at a time (128 contiguous bytes, one coalesced load per
// step), hash in uint32_t, where wrap-around is defined and is exactly the
// TPU's uint32 arithmetic, keep a running min in a register, and a
// shuffle-xor reduction gives every lane the row's min. Sentinels and
// columns past W never enter the min. The int32 tensor holding the u32 bit
// pattern is read as `const uint32_t*`, so bit 31 compares unsigned.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix(uint32_t x, uint32_t a, uint32_t b) {
  uint32_t h = x * a + b;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return h;
}

__global__ void rowmin_hash_kernel(const uint32_t* __restrict__ nbr,
                                   uint32_t* __restrict__ out, int64_t R,
                                   int64_t W, uint32_t a, uint32_t b) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x / 32);
  for (int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) / 32;
       r < R; r += warps) {
    const uint32_t* row = nbr + r * W;
    uint32_t m = kSentinel;
    for (int64_t w = lane; w < W; w += 32) {
      const uint32_t x = __ldg(row + w);
      if (x != kSentinel) m = min(m, mix(x, a, b));
    }
    for (int off = 16; off > 0; off >>= 1) {
      m = min(m, __shfl_xor_sync(kFull, m, off));
    }
    if (lane == 0) out[r] = m;
  }
}

}  // namespace

extern "C" int rowmin_hash_launch(const void* nbr, void* out, int64_t R,
                                  int64_t W, int64_t a, int64_t b,
                                  void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int64_t kWarps = kThreads / 32;
  const int64_t want = (R + kWarps - 1) / kWarps;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 64 ? want : 132 * 64);
  rowmin_hash_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(nbr), static_cast<uint32_t*>(out), R, W,
      static_cast<uint32_t>(a), static_cast<uint32_t>(b));
  return static_cast<int>(cudaGetLastError());
}
