// Histogram of state ids: out[s] = #{e : ids[e] == s} for 0 <= s < S.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/seghist/kernel.py::segment_histogram_kernel` (block
// function `_seghist_block`), which builds the histogram as a tiled one-hot
// compare-and-sum; ids of -1 (padding) and any id outside [0, S) count
// nowhere.
//
// What bounds it on an H100: the emission DP calls it once per tree level
// with E and S padded to powers of two (up to ~2^18 ids into ~2^18 bins on
// the main path). It reads 4*E bytes and writes 4*S, about one integer op
// per id, so HBM bandwidth and the latency of one small launch bound it;
// the atomics contend only where many ids share a bin.
//
// Design: the caller hands in a zeroed output; a grid-stride loop gives each
// thread a strided run of ids and performs `atomicAdd(&out[id], 1)` into
// global memory, which the L2 resolves. The TPU kernel's one-hot matrix
// (E*S compares) becomes E atomics. Integer atomics are exact in any order,
// so the result is deterministic. Privatizing bins in shared memory is the
// next step for speed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void segment_histogram_kernel(const int32_t* __restrict__ ids,
                                         int32_t* __restrict__ out, int64_t E,
                                         int64_t S) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < E; e += stride) {
    const int32_t id = __ldg(ids + e);
    if (id >= 0 && id < S) atomicAdd(out + id, 1);
  }
}

}  // namespace

extern "C" int segment_histogram_launch(const void* ids, void* out, int64_t E,
                                        int64_t S, void* stream) {
  if (E <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  // enough blocks to fill 132 SMs several times over; the loop covers the rest
  const int64_t want = (E + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  segment_histogram_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<int32_t*>(out), E, S);
  return static_cast<int>(cudaGetLastError());
}
