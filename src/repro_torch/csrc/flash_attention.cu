// Flash-attention forward with GQA and an online softmax:
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / g, j] * scale) v[b, h / g, j]
// over the keys j that the mask lets row i see: j <= i when causal, and
// also j > i - window when a window is set (non-causal ignores window).
// Query positions start at 0 whatever Sk is. Scores, softmax and the sum
// run in f32; the output is written in the input's type (bf16 or f32).
//
// Replaces the JAX package's Pallas kernel
// `repro/kernels/flash_attn/kernel.py::flash_attention_bhsd` (block
// function `_flash_kernel`), whose grid (batch, head, q block, kv block)
// runs the kv axis in order on one TPU core and carries (acc, m, l) in
// VMEM scratch from one kv block to the next, skipping the blocks the
// causal / window mask hides (`visible`, `last_j`).
//
// What bounds it on an H100: operations. Each visible (query, key) pair
// costs 2*D multiply-adds (q.k and p*v), so at the serving path's prefill
// call (B, H, Hkv, S, D) = (8, 16, 2, 1024, 128), causal, the 524,800
// visible pairs of each (b, h) are 34.4 GFLOP, about 35 us at the
// tensor cores' 989 TFLOP/s, against about 22 us to move q, k, v and o
// once at 3.35 TB/s.
//
// Design (simple and right first; no tensor cores yet): one block of 256
// threads per (b, h, 64-row q tile); the TPU's sequential kv grid axis
// becomes a loop inside the block over the 64-row K/V tiles the mask can
// see, so the (m, l) state and the f32 accumulator never leave registers
// and no block waits on another. The block stages its Q tile once and
// each K/V tile in shared memory as f32 (Q and K transposed, rows padded
// to 65 words so neither the transposing stores nor the reads conflict on
// a bank). Thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i and
// score columns tx + 16 c (i, c < 4) of the 64 x 64 score tile, and output
// columns tx + 16 jj of its rows; each row's max and sum are reduced over
// its 16 threads with shuffles, and the probabilities go through shared
// memory to the P.V product. Ragged Sq and Sk are masked in the kernel.
// expf (not __expf) keeps the f32 path within the reference's 2e-5.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // q rows per block, k/v rows per step
constexpr int kPad = kTile + 1;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Eight consecutive elements of a row as f32 (16-byte aligned reads: the
// wrapper checks the base pointers, and D is a multiple of 8).
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
}

// Rows [r0, r0 + 64) of a (rows, D) matrix into shared memory as f32,
// transposed to [D][kPad] or row-major [64][D]; rows past `rows` are 0.
template <typename T, bool kTransposed>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           int64_t r0, int64_t rows, int D) {
  const int chunks = D / 8;
  for (int idx = threadIdx.x; idx < kTile * chunks; idx += kThreads) {
    const int r = idx % kTile;
    const int c8 = idx / kTile;
    float x[8];
    if (r0 + r < rows) {
      load8(src + (r0 + r) * D + c8 * 8, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (kTransposed) {
        dst[(c8 * 8 + e) * kPad + r] = x[e];
      } else {
        dst[r * D + c8 * 8 + e] = x[e];
      }
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, off));
  }
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xFFFFFFFFu, x, off);
  }
  return x;
}

// NJ: output columns per thread, ceil(D / 16) rounded up to 2, 4, 8, 16.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int64_t H,
                       int64_t Hkv, int64_t Sq, int64_t Sk, int D, int causal,
                       int64_t window, float scale) {
  extern __shared__ float smem[];
  float* q_t = smem;                    // [D][kPad]
  float* k_t = q_t + D * kPad;          // [D][kPad]
  float* v_s = k_t + D * kPad;          // [kTile][D]
  float* p_s = v_s + kTile * D;         // [kTile][kPad]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / (H / Hkv);
  const T* qb = q + (b * H + h) * Sq * D;
  const T* kb = k + (b * Hkv + hk) * Sk * D;
  const T* vb = v + (b * Hkv + hk) * Sk * D;
  T* ob = o + (b * H + h) * Sq * D;

  // the kv tiles this q tile can see (`visible` / `last_j` of the TPU kernel)
  const int64_t n_kt = (Sk + kTile - 1) / kTile;
  int64_t j_lo = 0, j_hi = n_kt - 1;
  if (causal) {
    const int64_t q_last = (q0 + kTile - 1 < Sq - 1) ? q0 + kTile - 1 : Sq - 1;
    if (q_last / kTile < j_hi) j_hi = q_last / kTile;
    if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / kTile;
  }

  stage_tile<T, true>(q_t, qb, q0, Sq, D);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int64_t j = j_lo; j <= j_hi; ++j) {
    const int64_t k0 = j * kTile;
    __syncthreads();  // every thread is done with the previous K, V and P
    stage_tile<T, true>(k_t, kb, k0, Sk, D);
    stage_tile<T, false>(v_s, vb, k0, Sk, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_t[d * kPad + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = k_t[d * kPad + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty + 16 * i;
      bool seen[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t kpos = k0 + tx + 16 * c;
        bool ok = kpos < Sk;
        if (causal) {
          ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
        }
        seen[c] = ok;
        s[i][c] = ok ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = seen[c] ? expf(s[i][c] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kPad + tx + 16 * c] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();  // P complete

    const int kn = static_cast<int>(Sk - k0 < kTile ? Sk - k0 : kTile);
    for (int c = 0; c < kn; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int dd = tx + 16 * jj;
        if (dd < D) {
          const float x = v_s[c * D + dd];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], x, acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int dd = tx + 16 * jj;
      if (dd < D) store(ob + qpos * D + dd, acc[i][jj] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t B, int64_t H, int64_t Hkv, int64_t Sq, int64_t Sk,
                   int D, int causal, int64_t window, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(D) * kPad +
                       static_cast<size_t>(kTile) * D + kTile * kPad);
  auto kernel = flash_attention_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sq + kTile - 1) / kTile),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, D, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int64_t B, int64_t H, int64_t Hkv, int64_t Sq,
                     int64_t Sk, int D, int causal, int64_t window,
                     float scale, cudaStream_t s) {
  if (D <= 32) return launch<T, 2>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window, scale, s);
  if (D <= 64) return launch<T, 4>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window, scale, s);
  if (D <= 128) return launch<T, 8>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window, scale, s);
  return launch<T, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The wrapper has checked the shapes
// (D a multiple of 8 in [8, 256], H % Hkv == 0), the 16-byte alignment
// and contiguity; sizes the grid cannot take are refused here.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t B,
                                      int64_t H, int64_t Hkv, int64_t Sq,
                                      int64_t Sk, int64_t D, int64_t causal,
                                      int64_t window, float scale,
                                      int64_t dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (D < 8 || D > 256 || D % 8 || Hkv <= 0 || H % Hkv ||
      (Sq + kTile - 1) / kTile > 0x7FFFFFFF || H > 65535 || B > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal ? 1 : 0;
  const cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, o, B, H, Hkv, Sq, Sk, static_cast<int>(D), c, window, scale, s)
          : dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, static_cast<int>(D), c, window, scale, s);
  return static_cast<int>(err);
}
