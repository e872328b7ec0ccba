// Signed interval-membership counts of the batched summary queries:
//   out[b, p] = sum_e sign[b, e] * [lo[b, e] <= pos[b, p] < hi[b, e]],
// summed in int32 with wrap-around, exact for any int32 inputs.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/interval_expand/kernel.py::interval_count_kernel` (block
// function `_interval_count_block`), which runs a (query, probe-block,
// interval-block) grid and accumulates the compare-and-sum of a (BE, 1)
// interval column against a (1, BP) probe row: E*P pairs a row, padding
// included.
//
// What bounds it on an H100: the function needs each input slot read once
// ((3E + P)*4 bytes a row) and each count written once; at serving's
// widest tile, (256, 4096, 8192), that is 29.4 MB, 8.8 us at 3.35 TB/s.
// The brute force of the Pallas kernel costs E*P compares a row, 8.6e9 at
// that tile (1.5 ms at the card's integer rate), almost all of them on the
// padding of rows that one hub made 4,096 slots wide.
//
// Design, P > 1: sort and search. For an interval with lo < hi,
//   [lo <= x < hi] = [lo <= x] - [hi <= x],
// so a row's count at x is the sign sum of its lo's <= x minus that of its
// hi's <= x. One block per (row b, run of probes):
// * compact: the row's real intervals (sign != 0 and lo < hi; one with
//   lo >= hi contains no position and would count -sign between hi and lo
//   by the identity) go to shared memory as (key << 32 | sign) pairs, one
//   array keyed by lo and one by hi, by a warp ballot and one shared
//   atomic a warp; their order does not matter, so no block barrier;
// * a block whose n real intervals times its probes is at most
//   kDirectWork (the clustered graphs' rows, serving's short rows: n <= 64
//   at a full run of probes) answers each probe by direct compares
//   against them: a stated branch on n, the same for every probe;
// * otherwise both arrays are padded to N = pow2(n), at least 512, with
//   (INT32_MAX, sign 0), which adds nothing wherever it sorts, and sorted
//   by key by a bitonic network held in registers: thread t holds elements
//   16t..16t+15 of each array, so the stages with j < 16 are register
//   compare-exchanges, those with j < 512 warp shuffles with lane t ^
//   (j / 16), and only those with j >= 512 (6 of 78 at 4,096) go through
//   shared memory. (Held in shared memory throughout, the network moves
//   ~10 MB at 4,096 intervals, and serving's hub tile took twice as long:
//   PERF.md section 6.) Shared memory holds one pad word after every 16
//   elements, so a thread's 16 consecutive elements load and store
//   without bank conflicts. The signs are then replaced by
//   their inclusive prefix sums in uint32 (each warp scans a contiguous
//   run by shuffles, one barrier to add the runs' offsets);
// * each probe takes two upper-bound binary searches, log2(N) + 1 steps:
//   count = prefix_lo(#lo <= x) - prefix_hi(#hi <= x).
// Padded probes (-1, or serving's 0s) are searched like any other. The
// work is O(E + (n + P) log n) a row, against E*P.
// * Any E: slots are taken kMaxChunk at a time; each chunk is compacted,
//   sorted and searched, and the counts are summed over chunks in the
//   output (only this block's threads touch its probes).
// * The hub row: a row of 4,096 real intervals and 8,192 probes must not
//   leave its probes to one SM, so a row's probes are split into runs of
//   `probes_per_block` over blocks of their own, each sorting the row
//   itself; a row's runs are adjacent in the grid, so they start together
//   wherever the hub row lies. The split is measured
//   (`rank_count_bench.py --split`). A thread block cluster a row, each
//   block sorting a slice and searching every slice through distributed
//   shared memory, lost: its remote binary searches cost more than the
//   sorts they saved (PERF.md section 6).
//
// Design, P == 1 (`edge_exists`): a block of one probe would run one busy
// thread per query. Instead one warp takes one query: its lanes stride
// over the E intervals with coalesced reads and a shuffle reduction sums
// the 32 partial counts. It reads each slot once already.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // the sort-and-search kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kProbeThreads = 256;  // the one-probe kernel's block
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kV = 16;                     // elements a thread holds
constexpr int kWarpSpan = 32 * kV;         // 512: a warp's elements
constexpr int kMaxChunk = kThreads * kV;   // 4,096 intervals a chunk
constexpr int64_t kProbesPerBlock = 2048;
// direct compares when n * (the block's probes) <= kDirectWork: 64
// intervals at a full run of probes, more at a short one
constexpr int64_t kDirectWork = 64 * kProbesPerBlock;
// (INT32_MAX, sign 0): a pad adds 0 to every prefix, wherever it sorts
constexpr int64_t kPad = static_cast<int64_t>(INT32_MAX) << 32;

// shared-memory slot of element e: one pad word after every 16, so the
// 16 consecutive elements of each lane of a warp fall on distinct banks
__device__ __forceinline__ int slot(int e) { return e + (e >> 4); }
__host__ __device__ constexpr int slots(int n) { return n + n / 16; }

__device__ __forceinline__ int64_t pack(int32_t key, int32_t sign) {
  return static_cast<int64_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(key)) << 32) |
      static_cast<uint32_t>(sign));
}
__device__ __forceinline__ int32_t key_of(int64_t e) {
  return static_cast<int32_t>(e >> 32);
}
__device__ __forceinline__ uint32_t val_of(int64_t e) {
  return static_cast<uint32_t>(e);
}
__device__ __forceinline__ int64_t with_val(int64_t e, uint32_t v) {
  return static_cast<int64_t>(
      (static_cast<uint64_t>(e) & 0xFFFFFFFF00000000ull) | v);
}

// Entries compare by key alone: the order of equal keys moves no prefix
// sum at an upper bound.
__device__ __forceinline__ void exchange(int64_t& x, int64_t& y, bool up) {
  if ((key_of(x) > key_of(y)) == up) {
    const int64_t t = x;
    x = y;
    y = t;
  }
}

// Stage (k, J), J < kV, on the thread's own elements base..base+kV-1.
template <int J>
__device__ __forceinline__ void register_stage(int64_t (&a)[kV],
                                               int64_t (&b)[kV], int base,
                                               int k) {
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (v & J) continue;
    const bool up = ((base + v) & k) == 0;
    exchange(a[v], a[v | J], up);
    exchange(b[v], b[v | J], up);
  }
}

// Stage (k, j), kV <= j < kWarpSpan: element v of this lane pairs with
// element v of lane ^ (j / kV). Both lanes take the same decision, the
// pair's exchange oriented from its lower element (so equal keys never
// leave one entry in both lanes); k > j, so bit k is the lanes' own.
__device__ __forceinline__ void shuffle_stage(int64_t (&a)[kV],
                                              int64_t (&b)[kV], int base,
                                              int k, int j) {
  const int m = j / kV;
  const bool lower = (threadIdx.x & m) == 0;
  const bool up = (base & k) == 0;
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int64_t oa = __shfl_xor_sync(kFull, static_cast<long long>(a[v]),
                                       m);
    const int64_t ob = __shfl_xor_sync(kFull, static_cast<long long>(b[v]),
                                       m);
    const int32_t ka = lower ? key_of(a[v]) : key_of(oa);  // the lower's
    const int32_t kb = lower ? key_of(b[v]) : key_of(ob);
    const int32_t la = lower ? key_of(oa) : key_of(a[v]);  // the upper's
    const int32_t lb = lower ? key_of(ob) : key_of(b[v]);
    if ((ka > la) == up) a[v] = oa;
    if ((kb > lb) == up) b[v] = ob;
  }
}

// Ascending bitonic sort of a[0, N) and b[0, N) (in `slot` layout)
// together, N a power of two in [kWarpSpan, kMaxChunk]: the threads
// t < N / kV hold the elements in registers (whole warps), a stage with
// j >= kWarpSpan runs on shared memory with every thread, pair q
// compare-exchanging i = ((q & ~(j - 1)) << 1) | (q & (j - 1)) and i + j,
// ascending where i & k == 0.
__device__ __forceinline__ void bitonic_sort2(int64_t* a, int64_t* b,
                                              int N) {
  const int t = threadIdx.x;
  const int base = t * kV;
  const bool mine = base < N;  // whole warps, as N / kV >= 32
  int64_t ra[kV], rb[kV];
  __syncthreads();  // compaction and padding are in place
  if (mine) {
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      ra[v] = a[slot(base + v)];
      rb[v] = b[slot(base + v)];
    }
  }
  bool in_registers = true;
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= kWarpSpan) {
        if (in_registers && mine) {
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            a[slot(base + v)] = ra[v];
            b[slot(base + v)] = rb[v];
          }
        }
        in_registers = false;
        __syncthreads();
        for (int q = t; q < N / 2; q += kThreads) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const bool up = (i & k) == 0;
          int64_t ai = a[slot(i)], aj = a[slot(i + j)];
          int64_t bi = b[slot(i)], bj = b[slot(i + j)];
          exchange(ai, aj, up);
          exchange(bi, bj, up);
          a[slot(i)] = ai;
          a[slot(i + j)] = aj;
          b[slot(i)] = bi;
          b[slot(i + j)] = bj;
        }
        continue;
      }
      if (!in_registers) {
        __syncthreads();
        if (mine) {
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            ra[v] = a[slot(base + v)];
            rb[v] = b[slot(base + v)];
          }
        }
        in_registers = true;
      }
      if (!mine) continue;
      if (j >= kV) {
        shuffle_stage(ra, rb, base, k, j);
      } else if (j == 8) {
        register_stage<8>(ra, rb, base, k);
      } else if (j == 4) {
        register_stage<4>(ra, rb, base, k);
      } else if (j == 2) {
        register_stage<2>(ra, rb, base, k);
      } else {
        register_stage<1>(ra, rb, base, k);
      }
    }
  }
  if (mine) {  // the last stage (j = 1) ran in registers
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      a[slot(base + v)] = ra[v];
      b[slot(base + v)] = rb[v];
    }
  }
  __syncthreads();
}

// Inclusive prefix sums (uint32, wrapping) of the signs of a[0, N) and
// b[0, N) (in `slot` layout), N a power of two >= kWarpSpan, in place.
// Warp w scans the contiguous run [w*run, (w+1)*run) by shuffles; one
// barrier, then the runs' offsets.
__device__ __forceinline__ void prefix_signs2(int64_t* a, int64_t* b, int N,
                                              uint32_t (*totals)[kWarps]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int run = N / kWarps;
  const int start = warp * run;
  uint32_t ra = 0, rb = 0;  // running sums of this warp's run
  for (int k = start + lane; k < start + run; k += 32) {
    uint32_t va = val_of(a[slot(k)]), vb = val_of(b[slot(k)]);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t ua = __shfl_up_sync(kFull, va, off);
      const uint32_t ub = __shfl_up_sync(kFull, vb, off);
      if (lane >= off) {
        va += ua;
        vb += ub;
      }
    }
    a[slot(k)] = with_val(a[slot(k)], va + ra);
    b[slot(k)] = with_val(b[slot(k)], vb + rb);
    ra += __shfl_sync(kFull, va, 31);
    rb += __shfl_sync(kFull, vb, 31);
  }
  if (lane == 0) {
    totals[0][warp] = ra;
    totals[1][warp] = rb;
  }
  __syncthreads();
  if (warp > 0) {
    uint32_t oa = 0, ob = 0;
    for (int w = 0; w < warp; ++w) {
      oa += totals[0][w];
      ob += totals[1][w];
    }
    for (int k = start + lane; k < start + run; k += 32) {
      a[slot(k)] = with_val(a[slot(k)], val_of(a[slot(k)]) + oa);
      b[slot(k)] = with_val(b[slot(k)], val_of(b[slot(k)]) + ob);
    }
  }
  __syncthreads();
}

// The prefix sum of the signs of the keys <= x in sorted a[0, N): an
// upper-bound binary search, then the inclusive prefix before it.
__device__ __forceinline__ uint32_t sum_at_or_below(const int64_t* a, int N,
                                                    int32_t x) {
  int at = 0;  // keys <= x found so far
  for (int s = N; s > 0; s >>= 1) {
    if (at + s <= N && key_of(a[slot(at + s - 1)]) <= x) at += s;
  }
  return at > 0 ? val_of(a[slot(at - 1)]) : 0u;
}

__global__ void __launch_bounds__(kThreads)
    interval_count_kernel(const int32_t* __restrict__ lo,
                          const int32_t* __restrict__ hi,
                          const int32_t* __restrict__ sign,
                          const int32_t* __restrict__ pos,
                          int32_t* __restrict__ out, int64_t E, int64_t P,
                          int chunk, int64_t probes_per_block) {
  extern __shared__ int64_t smem[];
  int64_t* s_lo = smem;                  // chunk entries keyed by lo
  int64_t* s_hi = smem + slots(chunk);   // chunk entries keyed by hi
  __shared__ int s_fill;
  __shared__ uint32_t s_totals[2][kWarps];
  const int t = threadIdx.x;
  const int lane = t % 32;
  // a row's runs are adjacent blocks, so a hub row's runs start together
  const int64_t runs = (P + probes_per_block - 1) / probes_per_block;
  const int64_t b = blockIdx.x / runs;
  const int32_t* lo_b = lo + b * E;
  const int32_t* hi_b = hi + b * E;
  const int32_t* sg_b = sign + b * E;
  const int32_t* pos_b = pos + b * P;
  int32_t* out_b = out + b * P;
  const int64_t p0 = blockIdx.x % runs * probes_per_block;
  const int64_t p1 = p0 + probes_per_block < P ? p0 + probes_per_block : P;
  // E == 0 runs one empty chunk, which writes the zeros
  for (int64_t c0 = 0; c0 < (E > 0 ? E : 1); c0 += chunk) {
    const int64_t c1 = c0 + chunk < E ? c0 + chunk : E;
    if (t == 0) s_fill = 0;
    __syncthreads();
#pragma unroll 4
    for (int64_t e0 = c0; e0 < c1; e0 += kThreads) {  // block-uniform
      const int64_t e = e0 + t;
      int32_t l = 0, h = 0, s = 0;
      if (e < c1) {
        l = __ldg(lo_b + e);
        h = __ldg(hi_b + e);
        s = __ldg(sg_b + e);
      }
      const bool real = e < c1 && s != 0 && l < h;
      const unsigned vote = __ballot_sync(kFull, real);
      int base = 0;
      if (lane == 0 && vote) base = atomicAdd(&s_fill, __popc(vote));
      base = __shfl_sync(kFull, base, 0);
      if (real) {
        const int k = base + __popc(vote & ((1u << lane) - 1u));
        s_lo[slot(k)] = pack(l, s);
        s_hi[slot(k)] = pack(h, s);
      }
    }
    __syncthreads();
    const int n = s_fill;
    const bool first = c0 == 0;
    if (n * (p1 - p0) <= kDirectWork) {
      for (int64_t p = p0 + t; p < p1; p += kThreads) {
        const int32_t x = __ldg(pos_b + p);
        uint32_t acc = 0;
        for (int k = 0; k < n; ++k) {
          const int64_t el = s_lo[slot(k)];
          acc += (key_of(el) <= x && x < key_of(s_hi[slot(k)])) ? val_of(el)
                                                                : 0u;
        }
        out_b[p] = static_cast<int32_t>(
            first ? acc : static_cast<uint32_t>(out_b[p]) + acc);
      }
    } else {
      int N = kWarpSpan;
      while (N < n) N <<= 1;
      for (int k = n + t; k < N; k += kThreads) {
        s_lo[slot(k)] = kPad;
        s_hi[slot(k)] = kPad;
      }
      bitonic_sort2(s_lo, s_hi, N);
      prefix_signs2(s_lo, s_hi, N, s_totals);
      for (int64_t p = p0 + t; p < p1; p += kThreads) {
        const int32_t x = __ldg(pos_b + p);
        const uint32_t acc =
            sum_at_or_below(s_lo, N, x) - sum_at_or_below(s_hi, N, x);
        out_b[p] = static_cast<int32_t>(
            first ? acc : static_cast<uint32_t>(out_b[p]) + acc);
      }
    }
    __syncthreads();  // the next chunk overwrites the arrays
  }
}

__global__ void interval_probe_kernel(const int32_t* __restrict__ lo,
                                      const int32_t* __restrict__ hi,
                                      const int32_t* __restrict__ sign,
                                      const int32_t* __restrict__ pos,
                                      int32_t* __restrict__ out, int64_t B,
                                      int64_t E) {
  const int64_t b =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // a whole warp shares b, so it leaves together
  const int32_t x = __ldg(pos + b);
  int32_t acc = 0;
  for (int64_t e = lane; e < E; e += 32) {
    const int64_t k = b * E + e;
    acc += (__ldg(lo + k) <= x && x < __ldg(hi + k)) ? __ldg(sign + k) : 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(kFull, acc, off);
  }
  if (lane == 0) out[b] = acc;
}

}  // namespace

// The launch with the P > 1 kernel's probe split given: a row's probes go
// in runs of `probes_per_block` to blocks of their own
// (`rank_count_bench.py --split` sweeps it).
extern "C" int interval_count_split_launch(const void* lo, const void* hi,
                                           const void* sign, const void* pos,
                                           void* out, int64_t B, int64_t E,
                                           int64_t P, int64_t probes_per_block,
                                           void* stream) {
  if (B <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  if (B > 2147483647LL || E < 0 || probes_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* l = static_cast<const int32_t*>(lo);
  const int32_t* h = static_cast<const int32_t*>(hi);
  const int32_t* g = static_cast<const int32_t*>(sign);
  const int32_t* p = static_cast<const int32_t*>(pos);
  int32_t* o = static_cast<int32_t*>(out);
  if (P == 1) {
    const int64_t blocks = (B * 32 + kProbeThreads - 1) / kProbeThreads;
    interval_probe_kernel<<<static_cast<unsigned>(blocks), kProbeThreads, 0,
                            s>>>(l, h, g, p, o, B, E);
    return static_cast<int>(cudaGetLastError());
  }
  int chunk = kWarpSpan;  // pow2(E), within [kWarpSpan, kMaxChunk]
  while (chunk < E && chunk < kMaxChunk) chunk <<= 1;
  const int smem = 2 * slots(chunk) * static_cast<int>(sizeof(int64_t));
  if (smem > 48 * 1024) {  // past 48 KB only by this opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        interval_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t runs = (P + probes_per_block - 1) / probes_per_block;
  if (B * runs > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  interval_count_kernel<<<static_cast<unsigned>(B * runs), kThreads, smem,
                          s>>>(l, h, g, p, o, E, P, chunk, probes_per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int interval_count_launch(const void* lo, const void* hi,
                                     const void* sign, const void* pos,
                                     void* out, int64_t B, int64_t E,
                                     int64_t P, void* stream) {
  return interval_count_split_launch(lo, hi, sign, pos, out, B, E, P,
                                     kProbesPerBlock, stream);
}
