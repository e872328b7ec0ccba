// Signed interval-membership counts of the batched summary queries:
//   out[b, p] = sum_e sign[b, e] * [lo[b, e] <= pos[b, p] < hi[b, e]].
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/interval_expand/kernel.py::interval_count_kernel` (block
// function `_interval_count_block`), which runs a (query, probe-block,
// interval-block) grid and accumulates the compare-and-sum of a (BE, 1)
// interval column against a (1, BP) probe row over the sequential interval
// axis. Padding needs no branch: an interval lo == hi == 0 contains no
// position, and a probe of -1 lies in no interval (every lo >= 0).
//
// What bounds it on an H100: E*P compare pairs per query (two compares and
// a predicated add each, on the 32-bit integer lanes) against (3*E + P)*4
// bytes read and P*4 written. On the serving path `neighbors` probes every
// interval boundary (P = 2*E), so the work grows as E^2 while the bytes grow
// as E: the integer rate bounds the wide rows (hubs, E in the hundreds or
// thousands), and the launch itself the narrow ones (E of a few to a few
// dozen, as on clustered graphs).
//
// Design, P > 1: one block per (query b, tile of probes), one thread per
// probe holding its position and its count in registers. The block streams
// the query's (lo, hi, sign) through shared memory in chunks of blockDim
// intervals (each thread stages one), and every thread then reads the chunk
// at the same address, a broadcast with no bank conflict. The TPU kernel's
// sequential interval axis becomes this loop, so no partial sum leaves a
// register and no atomics are needed. The block is P rounded up to a warp,
// at most 256 threads, so a short probe row does not launch idle warps.
//
// Design, P == 1 (`edge_exists`): a block of one probe would run one busy
// thread per query. Instead one warp takes one query: its lanes stride
// over the E intervals with coalesced reads and a shuffle reduction sums
// the 32 partial counts.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void interval_count_kernel(const int32_t* __restrict__ lo,
                                      const int32_t* __restrict__ hi,
                                      const int32_t* __restrict__ sign,
                                      const int32_t* __restrict__ pos,
                                      int32_t* __restrict__ out, int64_t E,
                                      int64_t P) {
  __shared__ int32_t s_lo[kMaxThreads];
  __shared__ int32_t s_hi[kMaxThreads];
  __shared__ int32_t s_sg[kMaxThreads];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int32_t* lo_b = lo + b * E;
  const int32_t* hi_b = hi + b * E;
  const int32_t* sg_b = sign + b * E;
  const int64_t tiles = (P + nt - 1) / nt;
  for (int64_t tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int64_t p = tile * nt + t;
    const int32_t x = p < P ? __ldg(pos + b * P + p) : -1;
    int32_t acc = 0;
    for (int64_t e0 = 0; e0 < E; e0 += nt) {
      const int n = static_cast<int>(E - e0 < nt ? E - e0 : nt);
      __syncthreads();  // the previous chunk has been read by every thread
      if (t < n) {
        s_lo[t] = __ldg(lo_b + e0 + t);
        s_hi[t] = __ldg(hi_b + e0 + t);
        s_sg[t] = __ldg(sg_b + e0 + t);
      }
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        acc += (s_lo[k] <= x && x < s_hi[k]) ? s_sg[k] : 0;
      }
    }
    if (p < P) out[b * P + p] = acc;
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

extern "C" int interval_count_launch(const void* lo, const void* hi,
                                     const void* sign, const void* pos,
                                     void* out, int64_t B, int64_t E,
                                     int64_t P, void* stream) {
  if (B <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* l = static_cast<const int32_t*>(lo);
  const int32_t* h = static_cast<const int32_t*>(hi);
  const int32_t* g = static_cast<const int32_t*>(sign);
  const int32_t* p = static_cast<const int32_t*>(pos);
  int32_t* o = static_cast<int32_t*>(out);
  if (P == 1) {
    const int64_t blocks = (B * 32 + kMaxThreads - 1) / kMaxThreads;
    interval_probe_kernel<<<static_cast<unsigned>(blocks), kMaxThreads, 0, s>>>(
        l, h, g, p, o, B, E);
  } else {
    const int64_t warps = (P + 31) / 32;
    const int threads = static_cast<int>(
        warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads);
    const int64_t tiles = (P + threads - 1) / threads;
    dim3 grid(static_cast<unsigned>(B),
              static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
    interval_count_kernel<<<grid, threads, 0, s>>>(l, h, g, p, o, E, P);
  }
  return static_cast<int>(cudaGetLastError());
}
