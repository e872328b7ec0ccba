// Flash-attention forward with GQA and an online softmax:
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / g, j] * scale) v[b, h / g, j]
// over the keys j that the mask lets row i see: j <= i when causal, and
// also j > i - window when a window is set (non-causal ignores window).
// Query positions start at 0 whatever Sk is. Scores, softmax and the sum
// run in f32; the output is written in the input's type (bf16 or f32).
// q and k have head dim D, v and o their own width Dv <= D (MLA: D = 192,
// Dv = 128; GQA: Dv = D); the scale the caller passes is 1/sqrt(D).
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
// Two kernels, chosen by the inputs' type (a stated dispatch, not a
// fallback):
//
// * bf16: `flash_attention_tc_kernel`, on the tensor cores in the shape of
//   FlashAttention-2. One block of 4 warps per (b, h, 64-row q tile); each
//   warp owns 16 query rows. The TPU's sequential kv grid axis becomes a
//   loop inside the block over the K/V tiles the mask can see, so (m, l)
//   and the f32 accumulator never leave registers. S = Q.K^T and O += P.V
//   are `mma.sync.m16n8k16` with bf16 operands and f32 accumulators; Q's
//   fragments are loaded once with `ldmatrix` and kept in registers (at
//   D <= 128), K's come from row-major K with `ldmatrix`, V's with
//   `ldmatrix.trans`. The softmax runs on the accumulator fragments (each
//   lane holds rows lane/4 and lane/4 + 8; a row's max is reduced over its
//   quad), in exp2 with scale*log2(e) folded into one multiply, and the
//   probabilities become the A operand of P.V in registers (two adjacent
//   n8 score tiles are one k16 step), rounded to bf16 only there: the f32
//   accumulator and the row sum take the unrounded f32 p. K and V tiles
//   arrive as bf16 in a two-stage `cp.async.cg` ring, the next tile's copy
//   in flight while this one's math runs; rows are padded by 16 bytes so
//   `ldmatrix` is free of bank conflicts; key rows past Sk and head-dim
//   columns past D are zero-filled by the copy (src-size 0), never stale.
//   Only tiles that cross the diagonal, the window's edge or Sk compute a
//   mask. q tiles launch heaviest first when causal. The block takes
//   64 + 4 x 32 rows of D + 8 bf16 (52,224 B at D = 128); at D <= 128 its
//   threads are held to 168 registers so three blocks share an SM (32-row
//   kv tiles and three blocks ran faster on the H100 than 64-row tiles and
//   two); past D = 128 Q is re-read from shared memory, two blocks an SM.
// * f32: `flash_attention_kernel`, on the CUDA cores: the reference's f32
//   tolerance (atol 2e-5) is beyond TF32's three digits. One block of 256
//   threads per (b, h, 64-row q tile), Q and K staged transposed as f32
//   (rows padded to 65 words), thread (ty, tx) of a 16 x 16 grid owning
//   rows ty + 16 i and columns tx + 16 c of the 64 x 64 score tile; P goes
//   through shared memory to P.V. expf (not __expf) keeps it within 2e-5.
//
// Both take element strides for the batch, head and row of q, k, v and o
// (the last dim contiguous, rows 16-byte aligned: the wrapper checks), so
// the model's (b, s, h, d) activations are read in place.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// element strides of (batch, head, row) for q, k, v, o
struct Strides {
  int64_t q[3], k[3], v[3], o[3];
};

struct Problem {
  int64_t B, H, Hkv, Sq, Sk;
  int D, Dv, causal;  // Dv <= D, both multiples of 8
  int64_t window;
};

// The kv tiles [j_lo, j_hi] of `tile` rows that a q tile starting at q0
// of `rows` rows can see (`visible` / `last_j` of the TPU kernel); empty
// when j_lo > j_hi.
__device__ __forceinline__ void kv_range(const Problem& p, int64_t q0,
                                         int rows, int tile, int64_t* j_lo,
                                         int64_t* j_hi) {
  *j_lo = 0;
  *j_hi = (p.Sk + tile - 1) / tile - 1;
  if (p.causal) {
    const int64_t q_last = (q0 + rows - 1 < p.Sq - 1) ? q0 + rows - 1
                                                      : p.Sq - 1;
    if (q_last / tile < *j_hi) *j_hi = q_last / tile;
    if (p.window > 0 && q0 - p.window + 1 > 0) {
      *j_lo = (q0 - p.window + 1) / tile;
    }
  }
}

// ================================================== bf16 on the tensor cores
namespace tc {

using bf16 = __nv_bfloat16;

template <int DP>  // the head dim padded to a multiple of 16
struct Cfg {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BM = 16 * kWarps;  // q rows per block, 16 a warp
  static constexpr int BN = 32;           // kv rows per tile
  static constexpr int kStages = 2;       // K/V tiles in flight
  // blocks per SM the registers must allow (<= 168 a thread at 3)
  static constexpr int kMinBlocks = DP <= 128 ? 3 : 2;
  static constexpr bool kQInRegs = DP <= 128;
  static constexpr int LD = DP + 8;  // shared row stride (+16 B: no conflicts)
  static constexpr int KS = DP / 16;  // k16 steps of Q.K^T
  static constexpr int NT = BN / 8;   // n8 tiles of S
  static constexpr int DT = DP / 8;   // n8 tiles of O
  static constexpr int kSmem = (BM + 2 * kStages * BN) * LD * 2;  // Q, K, V
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src is
// then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 2^x on the special-function unit (what exp2f is under fast math)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Rows [r0, r0 + R) of a (rows, D) matrix with row stride `rs` into shared
// memory [R][LD] as bf16; rows past `rows` and columns past D are zeros.
// When the block's threads cover whole rows (every width but 80, 96 and
// 192), each thread keeps one column chunk and steps its row pointer.
template <int R, int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t r0, int64_t rows,
                                          int64_t rs, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks of a row
  constexpr int LD = Cfg<DP>::LD;
  constexpr int kThreads = Cfg<DP>::kThreads;
  if constexpr (kThreads % kChunks == 0 && R % (kThreads / kChunks) == 0) {
    constexpr int kRows = kThreads / kChunks;  // rows per pass
    const int r = threadIdx.x / kChunks;
    const int c = threadIdx.x % kChunks;
    const bool col_ok = c * 8 < D;
    const bf16* g = src + (r0 + r) * rs + c * 8;
    const uint32_t d = smem_u32(dst + r * LD + c * 8);
    const int64_t left = rows - r0 - r;  // rows of this thread still valid
#pragma unroll
    for (int i = 0; i < R / kRows; ++i) {
      const bool ok = col_ok && i * kRows < left;
      cp_async16(d + i * kRows * LD * 2, ok ? g + i * kRows * rs : src, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < (R * kChunks + kThreads - 1) / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < R * kChunks) {
        const int r = idx / kChunks;
        const int c = idx % kChunks;
        const bool ok = r0 + r < rows && c * 8 < D;
        const bf16* g = ok ? src + (r0 + r) * rs + c * 8 : src;
        cp_async16(smem_u32(dst + r * LD + c * 8), g, ok);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads, Cfg<DP>::kMinBlocks)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          Problem p, Strides st, float c, int64_t n_qt) {
  using C = Cfg<DP>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, KS = C::KS, NT = C::NT,
                DT = C::DT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* kv_s = q_s + BM * LD;  // stage s: K at 2s BN rows, V at (2s+1) BN
  constexpr int S = C::kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // q tile slowest, so the heaviest (last, when causal) tiles go first
  const int64_t BH = p.B * p.H;
  const int64_t bh = static_cast<int64_t>(blockIdx.x) % BH;
  const int64_t qt_i = static_cast<int64_t>(blockIdx.x) / BH;
  const int64_t qt = p.causal ? n_qt - 1 - qt_i : qt_i;
  const int64_t b = bh / p.H;
  const int64_t h = bh % p.H;
  const int64_t hk = h / (p.H / p.Hkv);
  const int64_t q0 = qt * BM;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + hk * st.k[1];
  const bf16* vb = v + b * st.v[0] + hk * st.v[1];

  int64_t j_lo, j_hi;
  kv_range(p, q0, BM, BN, &j_lo, &j_hi);

  // one cp.async group for Q, then one per kv tile (empty past j_hi)
  auto load_kv = [&](int64_t j, int stage) {
    if (j <= j_hi) {
      bf16* dst = kv_s + stage * 2 * BN * LD;
      load_tile<BN, DP>(dst, kb, j * BN, p.Sk, st.k[2], p.D);
      load_tile<BN, DP>(dst + BN * LD, vb, j * BN, p.Sk, st.v[2], p.Dv);
    }
    cp_async_commit();
  };
  load_tile<BM, DP>(q_s, qb, q0, p.Sq, st.q[2], p.D);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < S - 1; ++i) load_kv(j_lo + i, i);

  // The warp's 16 rows: each lane holds rows lane / 4 and lane / 4 + 8, and
  // the column pair 2 (lane % 4) of each n8 tile.
  const int col2 = 2 * (lane & 3);
  const int64_t qpos[2] = {q0 + 16 * warp + (lane >> 2),
                           q0 + 16 * warp + (lane >> 2) + 8};

  uint32_t qf[C::kQInRegs ? KS : 1][4];
  float acc[DT][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < DT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  }
  // ldmatrix row addresses: A (Q) and trans-B (V) take rows lane & 15 at
  // column block lane >> 4; B (K) takes rows (lane & 7) + 8 (lane >> 4) at
  // column block (lane >> 3) & 1.
  const uint32_t q_addr =
      smem_u32(q_s + (16 * warp + (lane & 15)) * LD + (lane >> 4) * 8);
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                    ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * LD + (lane >> 4) * 8;
  if constexpr (C::kQInRegs) {  // Q's fragments, once
    cp_async_wait<S - 1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], q_addr + kk * 32);
  }

  for (int64_t j = j_lo; j <= j_hi; ++j) {
    const int stage = static_cast<int>((j - j_lo) % S);
    // the copy S - 1 tiles ahead overlaps this tile's math; its stage was
    // last read in the previous iteration, which ended in a barrier
    load_kv(j + S - 1, (stage + S - 1) % S);
    cp_async_wait<S - 1>();  // this tile (and Q) landed
    __syncthreads();
    const bf16* k_s = kv_s + stage * 2 * BN * LD;
    const uint32_t k_addr = smem_u32(k_s + k_off);
    const uint32_t v_addr = smem_u32(k_s + BN * LD + v_off);

    // S = Q . K^T: 16 rows x BN keys per warp
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (C::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(a, q_addr + kk * 32);
      }
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, k_addr + (t * 8 * LD + kk * 16) * 2);
        mma(s[t], a, bk[0], bk[1]);
        mma(s[t + 1], a, bk[2], bk[3]);
      }
    }

    // mask only the tiles that cross Sk, the diagonal or the window's edge
    const int64_t k0 = j * BN;
    const bool need_mask =
        k0 + BN > p.Sk ||
        (p.causal && (k0 + BN - 1 > q0 ||
                      (p.window > 0 && k0 + p.window <= q0 + BM - 1)));
    uint32_t seen = 0xFFFFFFFFu;  // bit 4 t + e: element e of n8 tile t
    if (need_mask) {
      seen = 0;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t kpos = k0 + t * 8 + col2 + (e & 1);
          const int64_t qp = qpos[e >> 1];
          bool ok = kpos < p.Sk;
          if (p.causal) {
            ok = ok && kpos <= qp;
            if (p.window > 0) ok = ok && kpos > qp - p.window;
          }
          if (ok) {
            seen |= 1u << (4 * t + e);
          } else {
            s[t][e] = kNegInf;
          }
        }
      }
    }

    // online softmax in the log2 domain: x = s * scale * log2(e)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = s[0][2 * r];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
      const float m_new = fmaxf(m[r], mx * c);
      const float corr = ex2(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          float x = ex2(fmaf(s[t][e], c, -m_new));
          if (need_mask && !((seen >> (4 * t + e)) & 1u)) x = 0.f;
          s[t][e] = x;
          sum += x;
        }
      }
      l[r] = l[r] * corr + sum;  // this lane's part; the quad's sum at the end
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        acc[t][2 * r] *= corr;
        acc[t][2 * r + 1] *= corr;
      }
    }

    // O += P . V, P from the score fragments (bf16 only as an operand).
    // The accumulator is DP wide; the n16 column pairs at or past Dv hold
    // V's zero fill and are skipped (a uniform branch).
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      const uint32_t a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                             pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                             pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int t = 0; t < DT; t += 2) {
        if (t * 8 >= p.Dv) continue;
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_addr + (ks * 16 * LD + t * 8) * 2);
        mma(acc[t], a, bv[0], bv[1]);
        mma(acc[t + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before its reload
  }
  cp_async_wait<0>();

  bf16* ob = o + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    if (qpos[r] >= p.Sq) continue;
    bf16* orow = ob + qpos[r] * st.o[2];
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int col = t * 8 + col2;
      if (col < p.Dv) {  // Dv is a multiple of 8: col + 1 < Dv too
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[t][2 * r] / denom,
                                  acc[t][2 * r + 1] / denom);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Problem& p, const Strides& st, float scale,
                   cudaStream_t stream) {
  using C = Cfg<DP>;
  auto kernel = flash_attention_tc_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t n_qt = (p.Sq + C::BM - 1) / C::BM;
  const int64_t blocks = n_qt * p.B * p.H;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const float c = scale * 1.4426950408889634f;  // scale * log2(e)
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), p, st, c, n_qt);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, DP>) with the head dim D padded up
// to an instantiated width (the model head dims 64, 80 and 128 exactly);
// the padding columns are zero-filled.
template <typename F>
auto with_width(int D, F f) {
  if (D <= 32) return f(std::integral_constant<int, 32>());
  if (D <= 64) return f(std::integral_constant<int, 64>());
  if (D <= 80) return f(std::integral_constant<int, 80>());
  if (D <= 96) return f(std::integral_constant<int, 96>());
  if (D <= 128) return f(std::integral_constant<int, 128>());
  if (D <= 192) return f(std::integral_constant<int, 192>());
  return f(std::integral_constant<int, 256>());
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const Problem& p, const Strides& st, float scale,
                     cudaStream_t s) {
  return with_width(p.D, [&](auto dp) {
    return launch<decltype(dp)::value>(q, k, v, o, p, st, scale, s);
  });
}

int smem_bytes(int D) {
  return with_width(D, [](auto dp) { return Cfg<decltype(dp)::value>::kSmem; });
}

}  // namespace tc

// ==================================================== f32 on the CUDA cores
namespace f32 {

constexpr int kTile = 64;     // q rows per block, k/v rows per step
constexpr int kPad = kTile + 1;
constexpr int kThreads = 256;

// Rows [r0, r0 + 64) of a (rows, D) matrix with row stride `rs` into
// shared memory, transposed to [D][kPad] or row-major [64][D]; rows past
// `rows` are 0. Reads are 16-byte float4 pairs (D is a multiple of 8).
template <bool kTransposed>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int64_t r0, int64_t rows,
                                           int64_t rs, int D) {
  const int chunks = D / 8;
  for (int idx = threadIdx.x; idx < kTile * chunks; idx += kThreads) {
    const int r = idx % kTile;
    const int c8 = idx / kTile;
    float x[8];
    if (r0 + r < rows) {
      const float* g = src + (r0 + r) * rs + c8 * 8;
      const float4 a = *reinterpret_cast<const float4*>(g);
      const float4 b = *reinterpret_cast<const float4*>(g + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
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
template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       Problem p, Strides st, float scale) {
  extern __shared__ float smem[];
  const int D = p.D;
  float* q_t = smem;                    // [D][kPad]
  float* k_t = q_t + D * kPad;          // [D][kPad]
  const int Dv = p.Dv;
  float* v_s = k_t + D * kPad;          // [kTile][Dv]
  float* p_s = v_s + kTile * D;         // [kTile][kPad]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / (p.H / p.Hkv);
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + hk * st.k[1];
  const float* vb = v + b * st.v[0] + hk * st.v[1];
  float* ob = o + b * st.o[0] + h * st.o[1];

  int64_t j_lo, j_hi;
  kv_range(p, q0, kTile, kTile, &j_lo, &j_hi);

  stage_tile<true>(q_t, qb, q0, p.Sq, st.q[2], D);

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
    stage_tile<true>(k_t, kb, k0, p.Sk, st.k[2], D);
    stage_tile<false>(v_s, vb, k0, p.Sk, st.v[2], Dv);
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
        bool ok = kpos < p.Sk;
        if (p.causal) {
          ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
        }
        seen[c] = ok;
        s[i][c] = ok ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr = seen[c] ? expf(s[i][c] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kPad + tx + 16 * c] = pr;
        sum += pr;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();  // P complete

    const int kn = static_cast<int>(p.Sk - k0 < kTile ? p.Sk - k0 : kTile);
    for (int c = 0; c < kn; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int dd = tx + 16 * jj;
        if (dd < Dv) {
          const float x = v_s[c * Dv + dd];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], x, acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int dd = tx + 16 * jj;
      if (dd < Dv) ob[qpos * st.o[2] + dd] = acc[i][jj] / denom;
    }
  }
}

int smem_bytes(int D) {  // Q^T, K^T, V (sized for Dv = D), P
  return static_cast<int>(sizeof(float) *
                          (2 * D * kPad + kTile * D + kTile * kPad));
}

template <int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Problem& p, const Strides& st, float scale,
                   cudaStream_t stream) {
  const int smem = smem_bytes(p.D);
  auto kernel = flash_attention_kernel<NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if ((p.Sq + kTile - 1) / kTile > 0x7FFFFFFF || p.H > 65535 ||
      p.B > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>((p.Sq + kTile - 1) / kTile),
                  static_cast<unsigned>(p.H), static_cast<unsigned>(p.B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), p, st, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const Problem& p, const Strides& st, float scale,
                     cudaStream_t s) {
  if (p.D <= 32) return launch<2>(q, k, v, o, p, st, scale, s);
  if (p.D <= 64) return launch<4>(q, k, v, o, p, st, scale, s);
  if (p.D <= 128) return launch<8>(q, k, v, o, p, st, scale, s);
  return launch<16>(q, k, v, o, p, st, scale, s);
}

}  // namespace f32

}  // namespace

// The dynamic shared memory, in bytes, of the kernel that serves head dim
// D in `dtype` (the codes below), for the build report; -1 if none does.
extern "C" int flash_attention_smem_bytes(int64_t D, int64_t dtype) {
  if (D < 8 || D > 256 || D % 8 || (dtype != 0 && dtype != 1)) return -1;
  return dtype == 0 ? f32::smem_bytes(static_cast<int>(D))
                    : tc::smem_bytes(static_cast<int>(D));
}

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core
// kernel). `strides` points to 12 element strides on the host: (batch,
// head, row) of q, k, v and o, in that order. The wrapper has checked the
// shapes (D a multiple of 8 in [8, 256], Dv a multiple of 8 in [8, D],
// H % Hkv == 0), the contiguous last dim and the 16-byte alignment of
// every row; sizes the grid cannot take are refused here.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t B,
                                      int64_t H, int64_t Hkv, int64_t Sq,
                                      int64_t Sk, int64_t D, int64_t Dv,
                                      int64_t causal, int64_t window,
                                      float scale, int64_t dtype,
                                      const int64_t* strides, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (D < 8 || D > 256 || D % 8 || Dv < 8 || Dv > D || Dv % 8 || Hkv <= 0 ||
      H % Hkv || Sk < 0 || (dtype != 0 && dtype != 1) || strides == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem p{B, H, Hkv, Sq, Sk, static_cast<int>(D),
                  static_cast<int>(Dv), causal ? 1 : 0, window};
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? f32::dispatch(q, k, v, o, p, st, scale, s)
                                     : tc::dispatch(q, k, v, o, p, st, scale, s);
  return static_cast<int>(err);
}
