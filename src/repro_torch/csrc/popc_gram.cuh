// One tile of the symmetric AND-popcount Gram matrix of packed bitmaps,
//     acc[r][c] = sum_{w0 <= w < w1} popcount(a[r, w] & b[c, w]),
// the tile routine of both intersection kernels (`bitset_intersections.cu`,
// `pairwise_intersections.cu`). a and b are two runs of up to kTile rows
// of uint32 words (row pitch W words); rows past a run's count and words
// past w1 load as 0 and add nothing. A diagonal tile (a == b) stages its
// rows once and computes only its upper triangle.
//
// What bounds it on an H100: the tensor cores' binary multiply,
// `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`, computes
// exactly this function on packed words: one instruction is 16 x 8 row
// pairs over 8 words. On the H100 it is a native BMMA that issues at the
// rate of the int8 IMMA m16n8k32, so it does 1,024 word pairs where a POPC
// does one; what is left to bound a tile is moving the rows from L2 into
// shared memory and on into the fragments.
//
// Design:
// * a block of kWarps = 2 warps owns a 32 x 32 tile; warp w holds rows
//   16w..16w+15 as kNt = 4 m16n8 accumulators in registers;
// * the rows arrive in shared memory by `cp.async` (16-byte copies when W
//   and the base are 16-byte aligned, else 4-byte ones) in chunks of
//   kChunk words, kStages deep: the next chunk's copies are in flight
//   while this one is counted; the copy zero-fills what is past the run;
// * fragments load straight from the staged rows by `ldmatrix`: an
//   8 x 4-word matrix is exactly a b1 fragment (one word a lane), A from
//   the tile's rows and B from its columns' rows, with no unpacking;
// * rows are padded by 4 words: 16-byte aligned, and the 8 rows of an
//   `ldmatrix` matrix fall on 8 distinct bank quads;
// * in a diagonal tile, the m16n8 blocks wholly below the diagonal (warp
//   1's first two) are skipped: their counts are the mirror of blocks above
//   it. The caller computes only upper-triangle tiles and writes each count
//   to (i, j) and (j, i).
//
// The tile, chunk and stage counts were measured on the H100 against
// 64 x 64 tiles of 4 warps, 64-word chunks and three stages: none of
// those was faster at the batched shapes (`PERF.md` §6).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace popc_gram {

constexpr int kWarps = 2;  // a warp per 16 rows of the tile
constexpr int kNt = 4;     // n8 accumulators a warp, across the tile
constexpr int kTile = 16 * kWarps;  // rows and columns of a tile
static_assert(kTile == 8 * kNt, "tiles are square");
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;          // words of each row staged per stage
constexpr int kPitch = kChunk + 4;  // padded row, in words
constexpr int kStages = 2;

struct __align__(16) Stage {  // 16-byte copies and ldmatrix rows
  uint32_t a[kTile][kPitch];
  uint32_t b[kTile][kPitch];
};

// up to kTile rows from `base` (row pitch W words); rows >= `rows` are 0
struct Rows {
  const uint32_t* base;
  int rows;
};

// a warp's accumulators, in the m16n8 C-fragment layout
struct Counts {
  int n[kNt][4];
};

// Upper-triangle tile p of a T x T tile grid, row-major: (0,0) (0,1) ...
// (0,T-1) (1,1) ...
__device__ __forceinline__ void tile_pair(int64_t p, int64_t T, int64_t& ti,
                                          int64_t& tj) {
  ti = 0;
  while (p >= T - ti) {
    p -= T - ti;
    ++ti;
  }
  tj = ti + p;
}

// kVec words global -> shared; zero-filled when !ok (src is then not read,
// but must be a valid address)
template <int kVec>
__device__ __forceinline__ void async_copy(uint32_t* dst, const uint32_t* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Words [w, w + kChunk) of a run's rows into dst, zero past `w_end`. A
// thread keeps one column segment and steps down the rows.
template <int kVec>
__device__ __forceinline__ void load_rows(uint32_t (*dst)[kPitch], Rows src,
                                          int64_t W, int64_t w,
                                          int64_t w_end) {
  constexpr int kSegs = kChunk / kVec;
  constexpr int kStep = kThreads / kSegs;  // rows apart, one thread's copies
  static_assert(kThreads % kSegs == 0 && kTile % kStep == 0, "copy grid");
  const int c = (threadIdx.x % kSegs) * kVec;
  const int r0 = threadIdx.x / kSegs;
  const bool col_ok = w + c < w_end;
  const uint32_t* p = src.base + r0 * W + w + c;
#pragma unroll
  for (int i = 0; i < kTile / kStep; ++i, p += kStep * W) {
    const bool ok = col_ok && r0 + i * kStep < src.rows;
    async_copy<kVec>(&dst[r0 + i * kStep][c], ok ? p : src.base, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint32_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += popcount(A & B) over 256 bits: A 16 rows, B 8 columns
__device__ __forceinline__ void bmma(int (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tile's first row of this warp's blocks.
__device__ __forceinline__ int warp_row() {
  return 16 * (static_cast<int>(threadIdx.x) / 32);
}

// A diagonal tile's block wholly below the diagonal is not computed.
__device__ __forceinline__ bool needed(bool diag, int nt) {
  return !diag || warp_row() <= 8 * nt + 7;
}

// The counts of one staged chunk: `len` (<= kChunk) words are live; the
// rest of the chunk is zero, so k-steps past it are skipped.
__device__ __forceinline__ void count_chunk(const uint32_t (*a)[kPitch],
                                            const uint32_t (*b)[kPitch],
                                            bool diag, int len, Counts& acc) {
  const int lane = threadIdx.x % 32;
  const int m = lane >> 3;  // the ldmatrix matrix this lane addresses
#pragma unroll
  for (int k = 0; k < kChunk; k += 8) {
    if (k >= len) break;
    uint32_t af[4];  // rows 0-7 / 8-15, words 0-3 / 4-7
    ldsm_x4(af, &a[warp_row() + (lane & 15)][k + (lane >> 4) * 4]);
#pragma unroll
    for (int nt = 0; nt < kNt; nt += 2) {
      if (!needed(diag, nt + 1)) continue;  // then neither nt is needed
      uint32_t bf[4];  // columns of blocks nt, nt + 1; words 0-3 / 4-7
      ldsm_x4(bf, &b[8 * nt + 8 * (m >> 1) + (lane & 7)][k + (m & 1) * 4]);
      if (needed(diag, nt)) bmma(acc.n[nt], af, bf[0], bf[1]);
      bmma(acc.n[nt + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (zeroed by the caller) += the tile's counts over words [w0, w1).
// Every thread of the block must call it (it synchronizes the block).
template <int kVec>
__device__ void gram_tile(Stage* st, Rows a, Rows b, bool diag, int64_t W,
                          int64_t w0, int64_t w1, Counts& acc) {
  const int64_t n = (w1 - w0 + kChunk - 1) / kChunk;
  auto issue = [&](int64_t c) {
    Stage& s = st[c % kStages];
    load_rows<kVec>(s.a, a, W, w0 + c * kChunk, w1);
    if (!diag) load_rows<kVec>(s.b, b, W, w0 + c * kChunk, w1);
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n) issue(c);
    async_commit();
  }
  for (int64_t c = 0; c < n; ++c) {
    async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();            // and every thread is done with chunk c - 1
    if (c + kStages - 1 < n) issue(c + kStages - 1);  // into c - 1's stage
    async_commit();
    const Stage& s = st[c % kStages];
    const int64_t left = w1 - w0 - c * kChunk;
    count_chunk(s.a, diag ? s.a : s.b, diag,
                static_cast<int>(left < kChunk ? left : kChunk), acc);
  }
}

// Calls f(row, column, count) for each count this thread holds; in a
// diagonal tile, only for row <= column (the rest are not computed).
template <typename F>
__device__ __forceinline__ void for_each_count(const Counts& acc, bool diag,
                                               F&& f) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp_row() + (lane >> 2) + (e >= 2 ? 8 : 0);
      const int c = 8 * nt + 2 * (lane & 3) + (e & 1);
      if (!diag || r <= c) f(r, c, acc.n[nt][e]);
    }
}

// 16-byte copies need W a multiple of 4 words and a 16-byte aligned base.
inline bool vec4_ok(const void* bits, int64_t W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(bits) % 16 == 0;
}

}  // namespace popc_gram
