// Ranked top-J merge candidates of every row of a batch of groups.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/bitset_fold/kernel.py::jaccard_topj_kernel` (block function
// `_topj_block`): for every group b and row i of its (G, W) uint32 bitmap,
//   inter[j] = sum_w popcount(bits[b, i, w] & bits[b, j, w]),  deg = diag,
//   key[j]   = quantized Jaccard of (inter[j], deg[i] + deg[j] - inter[j]):
//              shift both down until the union fits 15 bits, then (i << 15)
//              / u, exact integer arithmetic (ref.py `rank_keys`),
//   ck[j]    = (key + 1) * G - 1 - j if alive[b, j] and j != i else -1 - j,
// and out[b, i, 0..J) are the columns of the J largest ck, largest first.
// The combined keys are unique (the column is folded in), so the order is
// key descending, column ascending, dead/self columns last, with no ties.
//
// Two regimes, one stated dispatch on G (no fallback between them):
//
// * G <= 32 (the resident main path: G = 8 and 16, W = 2 words, J = G - 1).
//   What bounds it: bytes. A group is G*W*4 bytes in and G*J*4 out, and a
//   row needs G keys and a full ranking of them; at (32768, 8, 2, 7) the
//   call moves 9.7 MB (2.9 us at 3.35 TB/s). A block per row, as before,
//   left 24 of 32 lanes idle, and J argmax passes with two block barriers
//   each made it 70-90x slower than that.
//   Design: one thread per (row i, column j) pair of the group padded to
//   S x S, S = pow2(G) a template argument, so every index is a shift and
//   every loop over the segment unrolls. A row owns a segment of S lanes,
//   so a warp holds 32/S rows and a block of 256 threads 256/S^2 groups
//   (4 at G = 8, 1 at G = 16); rows and columns past G are padding lanes.
//   Lane j loads its column's row (W words, straight from global memory,
//   no shared memory) and gets row i's words from lane i of its segment
//   by `__shfl_sync`, so intersection, degrees, quantized key and
//   combined key all stay in registers. The rank of column j is the
//   number of keys in its row above its own (the keys are unique): S
//   compares of keys shuffled within the segment, with no barrier at all.
//   The lane whose rank is below J writes its column to out[b, i, rank].
//
// * 32 < G <= 128 (the wide buckets of skewed graphs; the kernels phase's
//   (64, 128, 256, 16)). What bounds it: the G*G*W word pairs of the Gram
//   matrix on the CUDA cores (128 threads each looping 256 words with POPC
//   took 1.15 ms there), then the J selection passes.
//   Design: one block of 8 warps per group. The Gram matrix comes from the
//   tensor cores' binary multiply (`mma.m16n8k256.b1.and.popc`, the
//   instruction and helpers of `popc_gram.cuh`): the group's rows are
//   staged 32 words at a time by double-buffered `cp.async`, warp w holds
//   rows 16w..16w+15 against every column as 16 m16n8 accumulators, and
//   fragments load by `ldmatrix`. The counts go to shared memory (the
//   staging buffers' space, reused). Then one warp per row keeps the keys
//   of columns lane, lane + 32, ... in registers and selects the top J by
//   J warp-wide maxima (`__reduce_max_sync`, one instruction): the lane
//   holding the maximum writes its column and drops the key. No block
//   barrier is taken per pass.
#include <cstdint>
#include <cuda_runtime.h>

#include "popc_gram.cuh"

namespace {

using popc_gram::async_commit;
using popc_gram::async_copy;
using popc_gram::async_wait;
using popc_gram::bmma;
using popc_gram::ldsm_x4;
using popc_gram::vec4_ok;

constexpr int kMaxG = 128;
constexpr int kNarrowG = 32;  // G <= kNarrowG: one lane per (row, column)
constexpr int kKeyBits = 15;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNarrowThreads = 256;

// wide regime: a block of 8 warps, each a 16-row strip of the group
constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kChunk = 32;            // words of each row staged a stage
constexpr int kPitch = kChunk + 4;    // padded staged row, in words
constexpr int kStages = 2;
constexpr int kNt = kMaxG / 8;        // n8 accumulators a warp
constexpr int kGramPitch = kMaxG + 8;  // padded Gram row, in int32
constexpr int kStageWords = kStages * kMaxG * kPitch;
constexpr int kGramWords = kMaxG * kGramPitch;
constexpr int kWideSmemBytes =
    4 * (kStageWords > kGramWords ? kStageWords : kGramWords);

// The quantized Jaccard key and the combined key of column j of row i
// (ref.py `rank_keys`, `combined_key`).
__device__ __forceinline__ int32_t combined_key(int32_t inter, int32_t deg_i,
                                                int32_t deg_j, bool ok,
                                                int32_t j, int32_t G) {
  const int32_t uni = deg_i + deg_j - inter;
  const int32_t bl = 32 - __clz(uni);  // bit length; 0 for uni == 0
  const int32_t sh = bl > kKeyBits ? bl - kKeyBits : 0;
  const int32_t den = (uni >> sh) > 1 ? (uni >> sh) : 1;
  const int32_t key = ((inter >> sh) << kKeyBits) / den;
  return ok ? (key + 1) * G - 1 - j : -1 - j;
}

// One thread per (row, column) pair of a group padded to S x S (S =
// pow2(G) <= 32): thread t is group t / S^2, row (t / S) % S, column
// t % S, all by shifts. A row's S lanes are one shuffle segment, so no
// segment straddles a warp; rows and columns past G are padding lanes.
template <int S>
__global__ void __launch_bounds__(kNarrowThreads)
    jaccard_topj_narrow_kernel(const uint32_t* __restrict__ bits,
                               const int8_t* __restrict__ alive,
                               int32_t* __restrict__ out, int64_t B,
                               int32_t G, int64_t W, int32_t J) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t b = t / (S * S);
  const int32_t i = static_cast<int32_t>(t / S % S);
  const int32_t j = static_cast<int32_t>(t % S);
  const bool col = b < B && i < G && j < G;
  // padding lanes read nothing and rank nothing, but take part in every
  // shuffle (all calls are warp-uniform)
  const uint32_t* rj = bits + (b * G + (col ? j : 0)) * W;
  int32_t inter = 0;
  int32_t deg = 0;
#pragma unroll 4
  for (int64_t w = 0; w < W; ++w) {
    const uint32_t x = col ? __ldg(rj + w) : 0u;
    const uint32_t y = __shfl_sync(kFull, x, i, S);  // row i's word
    inter += __popc(x & y);
    deg += __popc(x);
  }
  const int32_t deg_i = __shfl_sync(kFull, deg, i, S);
  const bool ok = col && j != i && alive[b * G + j] > 0;
  const int32_t ck = col ? combined_key(inter, deg_i, deg, ok, j, G)
                         : INT32_MIN;  // below every key: never counted
  int32_t rank = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    rank += __shfl_sync(kFull, ck, k, S) > ck;
  }
  if (col && rank < J) out[(b * G + i) * J + rank] = j;
}

template <int S>
int launch_narrow(const uint32_t* bits, const int8_t* alive, int32_t* out,
                  int64_t B, int32_t G, int64_t W, int32_t J,
                  cudaStream_t s) {
  const int64_t blocks = (B * S * S + kNarrowThreads - 1) / kNarrowThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  jaccard_topj_narrow_kernel<S>
      <<<static_cast<unsigned>(blocks), kNarrowThreads, 0, s>>>(
          bits, alive, out, B, G, W, J);
  return static_cast<int>(cudaGetLastError());
}

// Words [w, w + kChunk) of the group's rows [0, rows) into dst, zero past
// w_end and in rows >= G. A thread keeps one column segment and steps down
// the rows.
template <int kVec>
__device__ __forceinline__ void stage_rows(uint32_t* dst, const uint32_t* g,
                                           int rows, int G, int64_t W,
                                           int64_t w, int64_t w_end) {
  constexpr int kSegs = kChunk / kVec;
  constexpr int kStep = kWideThreads / kSegs;
  const int c = (threadIdx.x % kSegs) * kVec;
  const bool col_ok = w + c < w_end;
  for (int r = threadIdx.x / kSegs; r < rows; r += kStep) {
    const bool ok = col_ok && r < G;  // rows past G are the next group's
    async_copy<kVec>(dst + r * kPitch + c, ok ? g + r * W + w + c : g, ok);
  }
}

// One block per group, G in (32, 128].
template <int kVec>
__global__ void __launch_bounds__(kWideThreads)
    jaccard_topj_wide_kernel(const uint32_t* __restrict__ bits,
                             const int8_t* __restrict__ alive,
                             int32_t* __restrict__ out, int32_t G, int64_t W,
                             int32_t J) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int64_t b = blockIdx.x;
  const uint32_t* g = bits + b * G * W;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int strip = 16 * warp;
  const int rows = (G + 15) / 16 * 16;  // rows any warp's fragments read
  int acc[kNt][4] = {};
  const int64_t n = (W + kChunk - 1) / kChunk;
  if (n > 0) stage_rows<kVec>(smem, g, rows, G, W, 0, W);
  async_commit();
  for (int64_t c = 0; c < n; ++c) {
    async_wait<0>();  // chunk c has landed
    __syncthreads();  // and every warp is done with chunk c - 1
    if (c + 1 < n) {
      stage_rows<kVec>(smem + ((c + 1) % kStages) * kMaxG * kPitch, g, rows,
                       G, W, (c + 1) * kChunk, W);
    }
    async_commit();
    const uint32_t* s = smem + (c % kStages) * kMaxG * kPitch;
    const int64_t left = W - c * kChunk;
    const int len = static_cast<int>(left < kChunk ? left : kChunk);
    if (strip < G) {
      const int m = lane >> 3;  // the ldmatrix matrix this lane addresses
#pragma unroll
      for (int k = 0; k < kChunk; k += 8) {
        if (k >= len) break;
        uint32_t af[4];  // rows strip..+15, words k..k+7
        ldsm_x4(af, s + (strip + (lane & 15)) * kPitch + k + (lane >> 4) * 4);
#pragma unroll
        for (int nt = 0; nt < kNt; nt += 2) {
          if (8 * nt >= G) break;
          uint32_t bf[4];  // columns 8nt..8nt+15, words k..k+7
          ldsm_x4(bf, s + (8 * nt + 8 * (m >> 1) + (lane & 7)) * kPitch + k +
                          (m & 1) * 4);
          bmma(acc[nt], af, bf[0], bf[1]);
          bmma(acc[nt + 1], af, bf[2], bf[3]);
        }
      }
    }
  }
  __syncthreads();  // the staging space becomes the Gram matrix
  int32_t* gram = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = strip + (lane >> 2) + (e >= 2 ? 8 : 0);
      const int c = 8 * nt + 2 * (lane & 3) + (e & 1);
      if (r < G && c < G) gram[r * kGramPitch + c] = acc[nt][e];
    }
  }
  __syncthreads();
  constexpr int kQ = kMaxG / 32;  // columns a lane: lane, lane + 32, ...
  const int8_t* al = alive + b * G;
  for (int i = warp; i < G; i += kWideWarps) {
    const int32_t deg_i = gram[i * kGramPitch + i];
    int32_t key[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int j = lane + 32 * q;
      key[q] = j < G ? combined_key(gram[i * kGramPitch + j], deg_i,
                                    gram[j * kGramPitch + j],
                                    j != i && al[j] > 0, j, G)
                     : INT32_MIN;
    }
    int32_t* dst = out + (b * G + i) * J;
    for (int p = 0; p < J; ++p) {
      int32_t mine = key[0];
#pragma unroll
      for (int q = 1; q < kQ; ++q) mine = key[q] > mine ? key[q] : mine;
      const int32_t best = __reduce_max_sync(kFull, mine);
      // the keys are unique and J < G, so exactly one live key matches
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (key[q] == best) {
          dst[p] = lane + 32 * q;
          key[q] = INT32_MIN;
        }
      }
    }
  }
}

template <int kVec>
int launch_wide(const uint32_t* bits, const int8_t* alive, int32_t* out,
                int64_t B, int32_t G, int64_t W, int32_t J, cudaStream_t s) {
  // past 48 KB of shared memory only by this opt-in, on the current device
  const cudaError_t err = cudaFuncSetAttribute(
      jaccard_topj_wide_kernel<kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  jaccard_topj_wide_kernel<kVec>
      <<<static_cast<unsigned>(B), kWideThreads, kWideSmemBytes, s>>>(
          bits, alive, out, G, W, J);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int jaccard_topj_launch(const void* bits, const void* alive,
                                   void* out, int64_t B, int64_t G,
                                   int64_t W, int64_t J, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (G < 1 || G > kMaxG || J < 1 || J >= G || W < 0 ||
      B > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(bits);
  const auto* a = static_cast<const int8_t*>(alive);
  auto* o = static_cast<int32_t*>(out);
  const auto g = static_cast<int32_t>(G);
  const auto j = static_cast<int32_t>(J);
  if (G <= 2) return launch_narrow<2>(x, a, o, B, g, W, j, s);
  if (G <= 4) return launch_narrow<4>(x, a, o, B, g, W, j, s);
  if (G <= 8) return launch_narrow<8>(x, a, o, B, g, W, j, s);
  if (G <= 16) return launch_narrow<16>(x, a, o, B, g, W, j, s);
  if (G <= kNarrowG) return launch_narrow<32>(x, a, o, B, g, W, j, s);
  return vec4_ok(bits, W) ? launch_wide<4>(x, a, o, B, g, W, j, s)
                          : launch_wide<1>(x, a, o, B, g, W, j, s);
}
