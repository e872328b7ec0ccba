// In-place bitset-OR fold of one merge round's accepted pairs.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/bitset_fold/kernel.py::bitset_fold_kernel` (block function
// `_fold_block`): for every group b, the instruction rows
// instr[b, p] = [a, z, wa, ba, wz, bz, valid, _] apply in order p = 0..P-1;
// a row with valid > 0 folds member z into member a of the group's (G, W)
// uint32 bitmap:
//   1. in every row, bit bz of word wz moves to bit ba of word wa (the read
//      of bit bz comes first, then the OR into wa, then the clear of wz);
//   2. row z is ORed into row a, then zeroed;
//   3. a's bit for its own column is cleared and alive[b, z] = 0.
// Pairs run in order, each step seeing the one before: two pairs' columns
// may share a 32-bit word, and nothing here assumes the pairs disjoint.
//
// What bounds it on an H100: bytes. Every call reads the whole (B, P, 8)
// instruction slab (32 bytes a row, one sector), and only the groups that
// hold a valid row need their bitmap words; per valid pair a few hundred
// integer operations at most. On the resident main path (B = 32,768 groups
// of G = 8 or 16 rows of W = 2 words, P = 4 or 8) the slab is 4-8 MB, about
// 1.3-2.5 us at 3.35 TB/s, and only about one group in eight holds a pair.
//
// Two regimes, one stated dispatch on shape (neither is a fallback for the
// other):
//
// * Narrow: G <= 32 and W <= 8 (every call of the resident main path).
//   A group owns a segment of S = pow2(G) lanes of a warp (a template, so
//   indices are shifts), lane r holding row r's W words in registers
//   (W rounded up to the template WM of 2, 4 or 8; a word is picked by
//   unrolled selects, never a dynamic index, so nothing goes to local
//   memory). Lane r of the segment loads instruction row r (two 16-byte
//   loads) and packs it into one word; a ballot tells which groups of the
//   warp hold a valid row, so a group with none reads no bitmap word at
//   all and a warp with none returns. The pairs run in order as a loop
//   that is uniform across the warp (the union of the warp's valid slots):
//   each pair reaches every lane by one `__shfl_sync` from lane p of the
//   segment, its effects are predicated on the group's valid flag, and the
//   shuffle that brings row z's words to lane a is unconditional, so every
//   lane named in a mask reaches it. Step 1 is each lane's own row; step 2
//   is the shuffle, lane a ORing and lane z zeroing; step 3 is lane a's
//   clear and lane z's alive store. No barrier, no shared memory; each
//   touched row is written back once.
//
// * Wide: G > 32 or W > 8 (the wide buckets of skewed graphs, the kernels
//   phase's (64, 128, 256, 64)). One block of 256 threads per group. The
//   pairs are a dependent chain, so their latency bounds it: on the bitmap
//   in global memory each pair waits on two round trips to L2. So where
//   the group's G rows fit in shared memory (up to 192 KB: G = 128 rows of
//   383 words) the block stages them there once (16-byte global reads and
//   writes where the rows are 16-byte aligned; rows W + 1 words apart, so
//   step 1's walk down one column hits 32 banks, not one), when it meets
//   its first valid row, and writes them back once at the end; a wider
//   group works on global memory (the same code on another pointer and
//   pitch, a template).
//   The instruction rows are staged in shared memory once, 128 at a time,
//   and a group with no valid row returns before it touches a bit
//   (`__syncthreads_or`). Per valid pair: step 1 spreads the G rows over
//   the threads (each row's words wa and wz read together, then written,
//   so wa == wz keeps the read-modify-write order), a barrier, then step 2
//   spreads the W words, with step 3's clear folded into the thread that
//   owns word wa and alive stored by thread 0, and one more barrier: two
//   barriers a pair, not three. (One warp walking the pairs with
//   `__syncwarp` instead was slower: each lane's rows and words then run
//   in series.)
//
// The int32 tensors are read and written as uint32, so bit 31 survives.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNarrowThreads = 256;
constexpr int kNarrowMaxG = 32;
constexpr int kNarrowMaxW = 8;
constexpr int kWideThreads = 256;
constexpr int kWideChunk = 128;  // instruction rows staged at a time
constexpr int64_t kWideStagedBytes = 192 * 1024;  // a group's bitmap, staged

// One instruction row as one word: valid (bit 0), a, z, ba, bz (5 bits
// each), wa, wz (3 bits each); 0 for a row with valid <= 0. The narrow
// regime has G <= 32 and W <= 8, so in-contract fields fit; the masks keep
// any other value inside the segment and the registers.
__device__ __forceinline__ uint32_t pack_pair(int4 lo, int4 hi) {
  if (hi.z <= 0) return 0u;
  return 1u | (static_cast<uint32_t>(lo.x) & 31u) << 1 |
         (static_cast<uint32_t>(lo.y) & 31u) << 6 |
         (static_cast<uint32_t>(lo.w) & 31u) << 11 |
         (static_cast<uint32_t>(hi.y) & 31u) << 16 |
         (static_cast<uint32_t>(lo.z) & 7u) << 21 |
         (static_cast<uint32_t>(hi.x) & 7u) << 24;
}

__device__ __forceinline__ void load_row(const int32_t* row, bool vec,
                                         int4& lo, int4& hi) {
  if (vec) {
    lo = __ldg(reinterpret_cast<const int4*>(row));
    hi = __ldg(reinterpret_cast<const int4*>(row) + 1);
  } else {
    lo = make_int4(__ldg(row), __ldg(row + 1), __ldg(row + 2),
                   __ldg(row + 3));
    hi = make_int4(__ldg(row + 4), __ldg(row + 5), __ldg(row + 6), 0);
  }
}

template <int S, int WM>
__global__ void __launch_bounds__(kNarrowThreads)
bitset_fold_narrow_kernel(uint32_t* __restrict__ bits,
                          int8_t* __restrict__ alive,
                          const int32_t* __restrict__ instr, int64_t B,
                          int G, int W, int P, bool vec) {
  constexpr unsigned kSeg = S == 32 ? kFull : (1u << S) - 1u;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kNarrowThreads +
                    threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int r = lane & (S - 1);
  const int seg0 = lane & ~(S - 1);  // the segment's first lane
  const int64_t b = t / S;           // the lane's group
  const bool in_group = b < B;
  const bool has_row = in_group && r < G;
  uint32_t* row = bits + (in_group ? (b * G + r) * W : 0);
  uint32_t w[WM];
#pragma unroll
  for (int k = 0; k < WM; ++k) w[k] = 0u;
  bool loaded = false;
  for (int c = 0; c < P; c += S) {  // uniform: chunks of S instruction rows
    uint32_t mine = 0u;             // this lane's instruction row, packed
    if (in_group && c + r < P) {
      int4 lo, hi;
      load_row(instr + (b * P + c + r) * 8, vec, lo, hi);
      mine = pack_pair(lo, hi);
    }
    const unsigned ballot = __ballot_sync(kFull, mine & 1u);
    if (ballot == 0u) continue;  // no group of the warp has a pair here
    const bool group_valid = ((ballot >> seg0) & kSeg) != 0u;
    if (group_valid && !loaded) {
      if (has_row) {
#pragma unroll
        for (int k = 0; k < WM; ++k) {
          if (k < W) w[k] = row[k];
        }
      }
      loaded = true;
    }
    // the warp's valid slots: the union over its segments, in order
    unsigned slots = ballot;
#pragma unroll
    for (int sh = 16; sh >= S; sh >>= 1) slots |= slots >> sh;
    slots &= kSeg;
    while (slots != 0u) {
      const int q = __ffs(slots) - 1;
      slots &= slots - 1u;
      const uint32_t pk = __shfl_sync(kFull, mine, q, S);
      const bool v = pk & 1u;
      const int a = (pk >> 1) & 31u, z = (pk >> 6) & 31u;
      const uint32_t ba = (pk >> 11) & 31u, bz = (pk >> 16) & 31u;
      const int wa = (pk >> 21) & 7u, wz = (pk >> 24) & 7u;
      // 1. this lane's row: bit bz of word wz moves to bit ba of word wa
      uint32_t colz = 0u;
#pragma unroll
      for (int k = 0; k < WM; ++k) {
        if (k == wz) colz = (w[k] >> bz) & 1u;
      }
      if (v) {
#pragma unroll
        for (int k = 0; k < WM; ++k) {
          if (k == wa) w[k] |= colz << ba;
        }
#pragma unroll
        for (int k = 0; k < WM; ++k) {
          if (k == wz) w[k] &= ~(1u << bz);
        }
      }
      // 2. row z's words reach lane a (every lane shuffles); a ORs, z zeroes
#pragma unroll
      for (int k = 0; k < WM; ++k) {
        if (k < W) {
          const uint32_t zk = __shfl_sync(kFull, w[k], z, S);
          if (v && r == a) w[k] |= zk;
        }
      }
      if (v && r == z) {
#pragma unroll
        for (int k = 0; k < WM; ++k) w[k] = 0u;
      }
      // 3. a has no bit for its own column; z dies
      if (v && r == a) {
#pragma unroll
        for (int k = 0; k < WM; ++k) {
          if (k == wa) w[k] &= ~(1u << ba);
        }
      }
      if (v && r == z && has_row) alive[b * G + z] = 0;
    }
  }
  if (loaded && has_row) {
#pragma unroll
    for (int k = 0; k < WM; ++k) {
      if (k < W) row[k] = w[k];
    }
  }
}

// The group's G rows of W words between global memory (rows W words
// apart) and shared memory (rows W + 1 apart, so the G words of one column
// fall in distinct banks), by the block's threads: 16-byte global accesses
// when vec4 (W % 4 == 0 and the group 16-byte aligned), the 4 words of one
// row in shared memory one by one.
template <bool kIn>
__device__ __forceinline__ void stage_rows(uint32_t* smem, uint32_t* global,
                                           int G, int W, bool vec4) {
  const int pitch = W + 1;
  if (vec4) {
    const int n4 = G * W / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += kWideThreads) {
      const int r = 4 * i / W, k = 4 * i - r * W;
      uint32_t* row = smem + r * pitch + k;
      auto* g4 = reinterpret_cast<uint4*>(global) + i;
      if (kIn) {
        const uint4 v = *g4;
        row[0] = v.x;
        row[1] = v.y;
        row[2] = v.z;
        row[3] = v.w;
      } else {
        *g4 = make_uint4(row[0], row[1], row[2], row[3]);
      }
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < G * W; i += kWideThreads) {
      const int r = i / W, k = i - r * W;
      if (kIn) {
        smem[r * pitch + k] = global[i];
      } else {
        global[i] = smem[r * pitch + k];
      }
    }
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kWideThreads)
bitset_fold_wide_kernel(uint32_t* __restrict__ bits,
                        int8_t* __restrict__ alive,
                        const int32_t* __restrict__ instr, int64_t G,
                        int64_t W, int64_t P, bool vec, bool vec_bits) {
  extern __shared__ uint32_t staged[];  // kStaged: G rows of W + 1 words
  __shared__ int4 lo_s[kWideChunk];
  __shared__ int4 hi_s[kWideChunk];
  const int64_t b = blockIdx.x;
  uint32_t* const home = bits + b * G * W;
  uint32_t* const grp = kStaged ? staged : home;
  const int64_t pitch = kStaged ? W + 1 : W;  // words from one row to the next
  bool loaded = false;  // uniform across the block
  for (int64_t c = 0; c < P; c += kWideChunk) {
    const int n = static_cast<int>(P - c < kWideChunk ? P - c : kWideChunk);
    __syncthreads();  // the previous chunk's rows are no longer read
    int any = 0;
    for (int i = threadIdx.x; i < n; i += kWideThreads) {
      int4 lo, hi;
      load_row(instr + (b * P + c + i) * 8, vec, lo, hi);
      lo_s[i] = lo;
      hi_s[i] = hi;
      any |= hi.z > 0;
    }
    if (!__syncthreads_or(any)) continue;  // no valid row: touch no bit
    if (kStaged && !loaded) {
      stage_rows<true>(staged, home, static_cast<int>(G),
                       static_cast<int>(W), vec_bits);
      __syncthreads();
      loaded = true;
    }
    for (int i = 0; i < n; ++i) {
      const int4 lo = lo_s[i], hi = hi_s[i];
      if (hi.z <= 0) continue;  // uniform across the block
      const int64_t a = lo.x, z = lo.y, wa = lo.z, wz = hi.x;
      const uint32_t ba = static_cast<uint32_t>(lo.w) & 31u;
      const uint32_t bz = static_cast<uint32_t>(hi.y) & 31u;
      // 1. every row: bit bz of word wz moves to bit ba of word wa
      for (int64_t r = threadIdx.x; r < G; r += kWideThreads) {
        uint32_t* rw = grp + r * pitch;
        const uint32_t xz = rw[wz], xa = rw[wa];
        const uint32_t colz = (xz >> bz) & 1u;
        if (wa == wz) {
          rw[wz] = (xz | colz << ba) & ~(1u << bz);
        } else {
          rw[wa] = xa | colz << ba;
          rw[wz] = xz & ~(1u << bz);
        }
      }
      __syncthreads();
      // 2. row z ORed into row a and zeroed; 3. a's own column bit cleared
      uint32_t* ra = grp + a * pitch;
      uint32_t* rz = grp + z * pitch;
      for (int64_t k = threadIdx.x; k < W; k += kWideThreads) {
        uint32_t x = ra[k] | rz[k];
        if (k == wa) x &= ~(1u << ba);
        ra[k] = x;
        rz[k] = 0u;  // after a's store: a == z leaves the row zero
      }
      if (threadIdx.x == 0) alive[b * G + z] = 0;
      __syncthreads();
    }
  }
  if (kStaged && loaded) {
    __syncthreads();
    stage_rows<false>(staged, home, static_cast<int>(G),
                      static_cast<int>(W), vec_bits);
  }
}

template <int S, int WM>
int launch_narrow(uint32_t* bits, int8_t* alive, const int32_t* instr,
                  int64_t B, int G, int W, int P, bool vec,
                  cudaStream_t stream) {
  const int64_t threads = B * S;
  const auto blocks = static_cast<unsigned>(
      (threads + kNarrowThreads - 1) / kNarrowThreads);
  bitset_fold_narrow_kernel<S, WM><<<blocks, kNarrowThreads, 0, stream>>>(
      bits, alive, instr, B, G, W, P, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int WM>
int narrow_by_g(uint32_t* bits, int8_t* alive, const int32_t* instr,
                int64_t B, int G, int W, int P, bool vec, cudaStream_t s) {
  if (G <= 2) return launch_narrow<2, WM>(bits, alive, instr, B, G, W, P, vec, s);
  if (G <= 4) return launch_narrow<4, WM>(bits, alive, instr, B, G, W, P, vec, s);
  if (G <= 8) return launch_narrow<8, WM>(bits, alive, instr, B, G, W, P, vec, s);
  if (G <= 16) return launch_narrow<16, WM>(bits, alive, instr, B, G, W, P, vec, s);
  return launch_narrow<32, WM>(bits, alive, instr, B, G, W, P, vec, s);
}

// The staged wide kernel's opt-in to kWideStagedBytes of dynamic shared
// memory, once per device.
constexpr int kMaxDevices = 64;
bool g_staged_opt_in[kMaxDevices];

cudaError_t opt_in_staged() {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxDevices && g_staged_opt_in[dev]) {
    return cudaSuccess;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      bitset_fold_wide_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWideStagedBytes));
  if (e == cudaSuccess && dev >= 0 && dev < kMaxDevices) {
    g_staged_opt_in[dev] = true;
  }
  return e;
}

}  // namespace

extern "C" int bitset_fold_launch(void* bits, void* alive, const void* instr,
                                  int64_t B, int64_t G, int64_t W, int64_t P,
                                  void* stream) {
  // nothing to fold: no group, no instruction row, or no bitmap word (no
  // valid row can name a word then)
  if (B <= 0 || P <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (G < 1 || B > 2147483647LL || P > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<uint32_t*>(bits);
  auto* al = static_cast<int8_t*>(alive);
  const auto* ins = static_cast<const int32_t*>(instr);
  const bool vec = reinterpret_cast<uintptr_t>(instr) % 16 == 0;
  if (G <= kNarrowMaxG && W <= kNarrowMaxW) {
    const auto g = static_cast<int>(G), w = static_cast<int>(W),
               p = static_cast<int>(P);
    if (W <= 2) return narrow_by_g<2>(x, al, ins, B, g, w, p, vec, s);
    if (W <= 4) return narrow_by_g<4>(x, al, ins, B, g, w, p, vec, s);
    return narrow_by_g<8>(x, al, ins, B, g, w, p, vec, s);
  }
  const auto blocks = static_cast<unsigned>(B);
  const int64_t bytes = G * (W + 1) * static_cast<int64_t>(sizeof(uint32_t));
  // every group's rows start on 16-byte boundaries
  const bool vec_bits = W % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(bits) % 16 == 0;
  if (bytes <= kWideStagedBytes) {
    // opt in past the default 48 KB (static shared memory included), once
    // per device, whatever this call's size
    const cudaError_t e = opt_in_staged();
    if (e != cudaSuccess) return static_cast<int>(e);
    bitset_fold_wide_kernel<true><<<blocks, kWideThreads,
                                    static_cast<size_t>(bytes), s>>>(
        x, al, ins, G, W, P, vec, vec_bits);
  } else {
    bitset_fold_wide_kernel<false><<<blocks, kWideThreads, 0, s>>>(
        x, al, ins, G, W, P, vec, vec_bits);
  }
  return static_cast<int>(cudaGetLastError());
}
