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
// key descending, column ascending, dead/self columns last, with no ties;
// the argmax still breaks ties toward the lower column, as jnp.argmax does.
//
// What bounds it on an H100: per group, G*G*W word pairs (an AND, a POPC at
// quarter rate, an add) against G*W*4 bytes read and G*J*4 written. At the
// main path's shapes (G <= 128, W a few words to a few hundred) the integer
// instruction rate of the word pairs and the J argmax passes bound it,
// not HBM.
//
// Design: one block per (b, i), one thread per column j (blockDim = G
// rounded up to a warp). Each thread loops over the W words, accumulating
// popc(row_i & row_j) and popc(row_j) (its column's degree) in registers,
// so nothing of size G*G is ever stored: the TPU kernel's (G, G) VMEM
// scratch becomes G registers spread over the block. Row i is read by every
// thread of the block at the same address (a broadcast through L1). Keys go
// to shared memory (G ints), then J block-wide argmax passes pick the
// columns: a warp shuffle reduction, then one thread over the warps' winners.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxG = 128;
constexpr int kKeyBits = 15;
constexpr int32_t kMasked = -2147483647;  // -(2^31) + 1, below every key

__device__ __forceinline__ bool better(int32_t k1, int32_t c1, int32_t k2,
                                       int32_t c2) {
  return k1 > k2 || (k1 == k2 && c1 < c2);
}

__global__ void jaccard_topj_kernel(const uint32_t* __restrict__ bits,
                                    const int8_t* __restrict__ alive,
                                    int32_t* __restrict__ out, int64_t G,
                                    int64_t W, int64_t J) {
  __shared__ int32_t s_deg[kMaxG];
  __shared__ int32_t s_key[kMaxG];
  __shared__ int32_t w_key[kMaxG / 32];
  __shared__ int32_t w_col[kMaxG / 32];
  const int64_t b = blockIdx.x / G;
  const int64_t i = blockIdx.x % G;
  const int j = threadIdx.x;
  const uint32_t* grp = bits + b * G * W;
  int32_t inter = 0;
  int32_t deg = 0;
  if (j < G) {
    const uint32_t* ri = grp + i * W;
    const uint32_t* rj = grp + j * W;
    for (int64_t w = 0; w < W; ++w) {
      const uint32_t x = __ldg(rj + w);
      inter += __popc(__ldg(ri + w) & x);
      deg += __popc(x);
    }
    s_deg[j] = deg;
  }
  __syncthreads();
  if (j < G) {
    const int32_t uni = s_deg[i] + deg - inter;
    const int32_t bl = 32 - __clz(uni);  // bit length; 0 for uni == 0
    const int32_t sh = bl > kKeyBits ? bl - kKeyBits : 0;
    const int32_t den = (uni >> sh) > 1 ? (uni >> sh) : 1;
    const int32_t key = ((inter >> sh) << kKeyBits) / den;
    const bool ok = alive[b * G + j] > 0 && j != i;
    s_key[j] = ok ? (key + 1) * static_cast<int32_t>(G) - 1 - j : -1 - j;
  }
  __syncthreads();
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  int32_t* dst = out + (b * G + i) * J;
  for (int64_t p = 0; p < J; ++p) {
    int32_t k = j < G ? s_key[j] : INT32_MIN;
    int32_t c = j;
    for (int off = 16; off > 0; off >>= 1) {
      const int32_t k2 = __shfl_down_sync(0xffffffffu, k, off);
      const int32_t c2 = __shfl_down_sync(0xffffffffu, c, off);
      if (better(k2, c2, k, c)) {
        k = k2;
        c = c2;
      }
    }
    if (lane == 0) {
      w_key[warp] = k;
      w_col[warp] = c;
    }
    __syncthreads();
    if (j == 0) {
      int32_t bk = w_key[0];
      int32_t bc = w_col[0];
      for (int w = 1; w < n_warps; ++w) {
        if (better(w_key[w], w_col[w], bk, bc)) {
          bk = w_key[w];
          bc = w_col[w];
        }
      }
      dst[p] = bc;
      s_key[bc] = kMasked;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int jaccard_topj_launch(const void* bits, const void* alive,
                                   void* out, int64_t B, int64_t G,
                                   int64_t W, int64_t J, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (G < 1 || G > kMaxG || J < 1 || J >= G || B * G > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned threads = static_cast<unsigned>((G + 31) / 32 * 32);
  jaccard_topj_kernel<<<static_cast<unsigned>(B * G), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const int8_t*>(alive),
      static_cast<int32_t*>(out), G, W, J);
  return static_cast<int>(cudaGetLastError());
}
