// Histogram of state ids: out[s] = #{e : ids[e] == s} for 0 <= s < S.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/seghist/kernel.py::segment_histogram_kernel` (block
// function `_seghist_block`), which builds the histogram as a tiled one-hot
// compare-and-sum; ids of -1 (padding) and any id outside [0, S) count
// nowhere.
//
// What bounds it on an H100: the emission DP calls it once per tree level
// with E and S padded to powers of two (up to 2^21 ids into 2^17 bins, and
// 2^18 into 2^18, on the main path). It reads 4*E bytes and writes 4*S,
// about one integer operation per id, so HBM bandwidth bounds it (2.6 us at
// the largest call); in practice the L2's atomic throughput does (about
// 75 G atomics/s for ids with no runs), and one atomic per id also put
// every run of equal ids on one L2 address: the DP hands the ids in edge
// order, so the edges of one supernode pair (one state) come in runs.
//
// Design: a warp takes 128 consecutive ids a step, 4 a lane by one 16-byte
// load (scalar loads, -1 filled, at the ragged end; the ids before the
// first 16-byte boundary are counted one by one). Runs of equal ids are
// folded in registers before anything reaches memory: an id is a run head
// when it differs from the id before it (the lane before, by one shuffle,
// for a lane's first; the warp's first id always is), a suffix minimum
// over the lanes (five shuffles) gives every lane the first head past it,
// and each head adds its run's length with ONE atomic. A warp step thus
// costs one atomic per run, not per id; ids without runs cost what they
// did. Integer atomics are exact in any order, so the result is
// deterministic. The caller hands in a zeroed output.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpan = 128;  // ids a warp takes a step

// The warp's 4 ids of this lane at span position pos (ids past n read -1).
__device__ __forceinline__ void load4(const int32_t* body, int64_t pos,
                                      int64_t n, int32_t x[4]) {
  if (pos + 4 <= n) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(body + pos));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = pos + j < n ? __ldg(body + pos + j) : -1;
  }
}

// Fold the runs of equal ids in one warp's 128 and add each run's length to
// its bin with one atomic.
__device__ __forceinline__ void add_runs(const int32_t x[4], int lane,
                                         int32_t* bins, int S) {
  const int32_t before = __shfl_up_sync(kFull, x[3], 1);
  bool head[4];
  head[0] = lane == 0 || x[0] != before;
  head[1] = x[1] != x[0];
  head[2] = x[2] != x[1];
  head[3] = x[3] != x[2];
  const int base = lane * 4;
  int next = head[0] ? base : head[1] ? base + 1 : head[2] ? base + 2
           : head[3] ? base + 3 : kSpan;
  // min over the lanes at or past this one ...
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(kFull, next, off);
    if (lane + off < 32) next = min(next, o);
  }
  // ... then over the lanes past it: the first head after this lane's ids
  next = __shfl_down_sync(kFull, next, 1);
  if (lane == 31) next = kSpan;
  int end = next;
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    if (head[j]) {
      const int32_t id = x[j];
      if (id >= 0 && id < S) atomicAdd(bins + id, end - (base + j));
      end = base + j;
    }
  }
}

// The ids before the first 16-byte boundary, one atomic each.
__device__ __forceinline__ void add_head(const int32_t* ids, int64_t head,
                                         int32_t* out, int S) {
  if (blockIdx.x == 0 && threadIdx.x < head) {
    const int32_t id = __ldg(ids + threadIdx.x);
    if (id >= 0 && id < S) atomicAdd(out + id, 1);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_histogram_kernel(const int32_t* __restrict__ ids,
                         int32_t* __restrict__ out, int64_t E, int64_t head,
                         int S) {
  add_head(ids, head, out, S);
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x) >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps * kSpan;
  const int32_t* body = ids + head;
  const int64_t n = E - head;
  for (int64_t c = warp * kSpan; c < n; c += stride) {  // uniform per warp
    int32_t x[4];
    load4(body, c + lane * 4, n, x);
    add_runs(x, lane, out, S);
  }
}

}  // namespace

// `sms`: the device's SM count (the caller reads it once, so a launch makes
// no query).
extern "C" int segment_histogram_launch(const void* ids, void* out, int64_t E,
                                        int64_t S, int64_t sms, void* stream) {
  if (E <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (S > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int32_t*>(ids);
  auto* o = static_cast<int32_t*>(out);
  const int bins = static_cast<int>(S);
  // ids before the first 16-byte boundary (the rest load 4 at a time)
  const int64_t mis = (reinterpret_cast<uintptr_t>(ids) % 16) / 4;
  int64_t head = mis ? 4 - mis : 0;
  if (head > E) head = E;
  const int64_t spans = (E - head + kSpan - 1) / kSpan;
  int64_t blocks = (spans + kWarps - 1) / kWarps;
  if (blocks > sms * 8) blocks = sms * 8;
  if (blocks < 1) blocks = 1;
  segment_histogram_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      x, o, E, head, bins);
  return static_cast<int>(cudaGetLastError());
}
