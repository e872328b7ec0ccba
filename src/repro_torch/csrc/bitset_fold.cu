// In-place bitset-OR fold of one merge round's accepted pairs.
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/bitset_fold/kernel.py::bitset_fold_kernel` (block function
// `_fold_block`): for every group b, the instruction rows
// instr[b, p] = [a, z, wa, ba, wz, bz, valid, _] apply in order p = 0..P-1;
// a row with valid > 0 folds member z into member a of the group's (G, W)
// uint32 bitmap:
//   1. in every row, bit bz of word wz moves to bit ba of word wa;
//   2. row z is ORed into row a and zeroed;
//   3. a's bit for its own column is cleared and alive[b, z] = 0.
// Pairs of one round are disjoint in rows and member columns, but two
// pairs' columns may share a 32-bit word, so the pairs run in order, each
// step a read-modify-write that sees the previous one.
//
// What bounds it on an H100: per valid pair, two column words of G rows and
// two rows of W words are read and written — a few KB against a few hundred
// integer operations, so bytes (and, at these sizes, the launch and the
// barriers between the steps) bound it, not arithmetic.
//
// Design: one block per group. The TPU kernel's fori_loop over the pairs
// becomes a loop inside the block with __syncthreads() between the three
// steps; step 1 spreads the G rows over the threads, step 2 the W words, and
// one thread does step 3. Each thread of step 1 handles one row, so when wa
// and wz are the same word its read-modify-write sequence stays in order.
// The int32 tensors are read and written as uint32, so bit 31 survives.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void bitset_fold_kernel(uint32_t* __restrict__ bits,
                                   int8_t* __restrict__ alive,
                                   const int32_t* __restrict__ instr,
                                   int64_t G, int64_t W, int64_t P) {
  const int64_t b = blockIdx.x;
  uint32_t* grp = bits + b * G * W;
  const int32_t* ins = instr + b * P * 8;
  for (int64_t p = 0; p < P; ++p) {
    const int32_t* row = ins + p * 8;
    if (row[6] <= 0) continue;  // uniform across the block: no barrier skew
    const int64_t a = row[0], z = row[1];
    const int64_t wa = row[2], wz = row[4];
    const uint32_t ba = static_cast<uint32_t>(row[3]);
    const uint32_t bz = static_cast<uint32_t>(row[5]);
    for (int64_t r = threadIdx.x; r < G; r += blockDim.x) {
      uint32_t* rw = grp + r * W;
      const uint32_t colz = (rw[wz] >> bz) & 1u;
      rw[wa] |= colz << ba;
      rw[wz] &= ~(1u << bz);
    }
    __syncthreads();
    uint32_t* ra = grp + a * W;
    uint32_t* rz = grp + z * W;
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x) {
      ra[w] |= rz[w];
      rz[w] = 0u;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      ra[wa] &= ~(1u << ba);
      alive[b * G + z] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int bitset_fold_launch(void* bits, void* alive, const void* instr,
                                  int64_t B, int64_t G, int64_t W, int64_t P,
                                  void* stream) {
  if (B <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  if (G < 1 || W < 1 || B > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bitset_fold_kernel<<<static_cast<unsigned>(B), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(bits), static_cast<int8_t*>(alive),
      static_cast<const int32_t*>(instr), G, W, P);
  return static_cast<int>(cudaGetLastError());
}
