#!/usr/bin/env python3
"""Time one checkout's two intersection kernels (`bitset_intersections`,
`pairwise_intersections`) on one CUDA card at `chip_smoke.py`'s fixed
shapes, so that two checkouts can be compared in one call, on one card, in
turns:

    python3 popc_bench.py --src /path/to/parent/src --label parent
    python3 popc_bench.py --label change      # this checkout's src/
    python3 popc_bench.py --probe             # and the design it beat

Each run builds that checkout's kernels (its own `build/`) and prints the
card's name and power limit, then one JSON line per shape: the mean
milliseconds of the public wrapper over ``--reps`` calls by CUDA events
after a warm-up call (the wrapper's host cost included, as the merge
engine pays it), the kernel's own device time a call by `torch.profiler`,
and the one-call fp16 yardstick's milliseconds beside them (`torch.bmm`
or `torch.matmul` on the bits unpacked to 0/1). Shapes: `INTER_SHAPES` and
`PAIRWISE_SHAPES` of `chip_smoke.py`, and the record line's pairwise call
(512, 512). Inputs are drawn as in `chip_smoke.py`
(`numpy.random.default_rng(0)`). Only the public wrappers are called, so
any checkout of the port since its pairwise kernel landed can be timed.

``--probe`` settles the design question of the shipped kernels, which run
on the tensor cores' binary multiply (`csrc/popc_gram.cuh`): it builds the
CUDA-core tile that lost to it (`PROBE_SOURCE`: the same 32 x 32 tiles,
cp.async staging and W split, with 4 x 4 counts a thread by AND + POPC),
checks both exact against the plain version, and times both through their
raw launchers (one preallocated output, no wrapper) at `PROBE_SHAPES`: the
wall by CUDA events, and each kernel's device time by `torch.profiler`.
Then the opcodes of both in the SASS (`cuobjdump -sass`: BMMA in the
shipped kernels, POPC in the probe), and the peak issue rates, per SM and
clock, of the binary MMA (m16n8k256), the int8 MMA (m16n8k32) and POPC
from register-only loops. Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PROBE_SHAPES = [(1, 512, 512), (1, 512, 6875), (1, 512, 6876),
                (64, 128, 256), (64, 16, 8)]  # (B, G, W)
# (name, ops an instruction does: 2 per bit or element pair, or 1 POPC)
PEAKS = [("bmma_m16n8k256_b1", 16 * 8 * 256 * 2),
         ("imma_m16n8k32_s8", 16 * 8 * 32 * 2), ("popc", 1)]

PROBE_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "popc_gram.cuh"

namespace {

using popc_gram::async_commit;
using popc_gram::async_copy;
using popc_gram::async_wait;
using popc_gram::tile_pair;
using popc_gram::vec4_ok;

constexpr int kTile = 32, kThreads = 64, kBlk = 4, kChunk = 32;
constexpr int kPitch = kChunk + 4, kStages = 2;

struct __align__(16) Stage {
  uint32_t a[kTile][kPitch];
  uint32_t b[kTile][kPitch];
};

template <int kVec>
__device__ __forceinline__ void load_rows(uint32_t (*dst)[kPitch],
                                          const uint32_t* base, int rows,
                                          int64_t W, int64_t w,
                                          int64_t w_end) {
  constexpr int kSegs = kChunk / kVec, kStep = kThreads / kSegs;
  const int c = (threadIdx.x % kSegs) * kVec;
  const int r0 = threadIdx.x / kSegs;
  const bool col_ok = w + c < w_end;
  const uint32_t* p = base + r0 * W + w + c;
#pragma unroll
  for (int i = 0; i < kTile / kStep; ++i, p += kStep * W) {
    const bool ok = col_ok && r0 + i * kStep < rows;
    async_copy<kVec>(&dst[r0 + i * kStep][c], ok ? p : base, ok);
  }
}

// thread (ty, tx) of an 8 x 8 grid: the 4 x 4 counts of rows ty + 8i and
// columns tx + 8j; a 16-byte shared load (4 words of a row) feeds 16 word
// pairs, each an AND, a POPC and an add on the CUDA cores
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    cuda_core_probe_kernel(const uint32_t* __restrict__ bits,
                           int32_t* __restrict__ out, int64_t G, int64_t W,
                           int64_t T, int64_t pairs, int64_t split,
                           int64_t run_words) {
  __shared__ Stage st[kStages];
  const int64_t b = blockIdx.x / (pairs * split);
  const int64_t rest = blockIdx.x % (pairs * split);
  int64_t ti, tj;
  tile_pair(rest / split, T, ti, tj);
  const int64_t w0 = (rest % split) * run_words;
  const int64_t w1 = w0 + run_words < W ? w0 + run_words : W;
  const int64_t i0 = ti * kTile, j0 = tj * kTile;
  const uint32_t* g = bits + b * G * W;
  const int ra = static_cast<int>(G - i0 < kTile ? G - i0 : kTile);
  const int rb = static_cast<int>(G - j0 < kTile ? G - j0 : kTile);
  const bool diag = ti == tj;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  int acc[kBlk][kBlk] = {};
  const int64_t n = (w1 - w0 + kChunk - 1) / kChunk;
  auto issue = [&](int64_t c) {
    Stage& s = st[c % kStages];
    load_rows<kVec>(s.a, g + i0 * W, ra, W, w0 + c * kChunk, w1);
    if (!diag) load_rows<kVec>(s.b, g + j0 * W, rb, W, w0 + c * kChunk, w1);
  };
  if (n > 0) issue(0);
  async_commit();
  for (int64_t c = 0; c < n; ++c) {
    async_wait<0>();
    __syncthreads();
    if (c + 1 < n) issue(c + 1);
    async_commit();
    const Stage& s = st[c % kStages];
    const uint32_t (*sb)[kPitch] = diag ? s.a : s.b;
#pragma unroll
    for (int k = 0; k < kChunk; k += 4) {
      uint4 x[kBlk], y[kBlk];
#pragma unroll
      for (int i = 0; i < kBlk; ++i)
        x[i] = *reinterpret_cast<const uint4*>(&s.a[ty + 8 * i][k]);
#pragma unroll
      for (int j = 0; j < kBlk; ++j)
        y[j] = *reinterpret_cast<const uint4*>(&sb[tx + 8 * j][k]);
#pragma unroll
      for (int i = 0; i < kBlk; ++i)
#pragma unroll
        for (int j = 0; j < kBlk; ++j)
          acc[i][j] += __popc(x[i].x & y[j].x) + __popc(x[i].y & y[j].y) +
                       __popc(x[i].z & y[j].z) + __popc(x[i].w & y[j].w);
    }
  }
  int32_t* o = out + b * G * G;
#pragma unroll
  for (int i = 0; i < kBlk; ++i)
#pragma unroll
    for (int j = 0; j < kBlk; ++j) {
      const int64_t r = i0 + ty + 8 * i, c = j0 + tx + 8 * j;
      if (r >= G || c >= G) continue;
      if (split == 1) {
        o[r * G + c] = acc[i][j];
        if (!diag) o[c * G + r] = acc[i][j];
      } else {
        atomicAdd(o + r * G + c, acc[i][j]);
        if (!diag) atomicAdd(o + c * G + r, acc[i][j]);
      }
    }
}

}  // namespace

// (B, G, W) -> (B, G, G); W split over the SMs only when B == 1, as the
// pairwise kernel splits it
extern "C" int cuda_core_probe_launch(const void* bits, void* out, int64_t B,
                                      int64_t G, int64_t W, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t T = (G + kTile - 1) / kTile;
  const int64_t pairs = T * (T + 1) / 2;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t chunks = (W + kChunk - 1) / kChunk;
  int64_t split = B == 1 ? (8 * sms + pairs - 1) / pairs : 1;
  split = split < chunks ? split : (chunks > 1 ? chunks : 1);
  const int64_t run_chunks = chunks > 0 ? (chunks + split - 1) / split : 1;
  split = chunks > 0 ? (chunks + run_chunks - 1) / run_chunks : 1;
  if (split > 1) cudaMemsetAsync(out, 0, B * G * G * sizeof(int32_t), s);
  auto* kernel = vec4_ok(bits, W) ? &cuda_core_probe_kernel<4>
                                  : &cuda_core_probe_kernel<1>;
  kernel<<<static_cast<unsigned>(B * pairs * split), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(bits), static_cast<int32_t*>(out), G, W,
      T, pairs, split, run_chunks * kChunk);
  return static_cast<int>(cudaGetLastError());
}

// Instruction-rate probes: each warp issues `iters` x 8 independent
// instructions on register operands (no memory), for the peak rate of the
// binary MMA, the int8 MMA and POPC on this card.
__global__ void bmma_peak_kernel(int* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u,
                         threadIdx.x * 7u};
  const uint32_t b0 = ~threadIdx.x, b1 = threadIdx.x * 11u;
  int d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(d[k][0]), "+r"(d[k][1]), "+r"(d[k][2]), "+r"(d[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  int s = 0;
  for (int k = 0; k < 8; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  if (s == 0x7fffffff) out[0] = s;
}
__global__ void imma_peak_kernel(int* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u,
                         threadIdx.x * 7u};
  const uint32_t b0 = ~threadIdx.x, b1 = threadIdx.x * 11u;
  int d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(d[k][0]), "+r"(d[k][1]), "+r"(d[k][2]), "+r"(d[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  int s = 0;
  for (int k = 0; k < 8; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  if (s == 0x7fffffff) out[0] = s;
}
__global__ void popc_peak_kernel(int* out, int iters) {
  uint32_t x[8];
  for (int k = 0; k < 8; ++k) x[k] = threadIdx.x * (2654435761u + k);
  int d[8] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] += __popc(x[k] & static_cast<uint32_t>(it));
  int s = 0;
  for (int k = 0; k < 8; ++k) s += d[k];
  if (s == 0x7fffffff) out[0] = s;
}

extern "C" int peak_launch(int which, void* out, int blocks, int threads,
                           int iters, void* stream) {
  auto* kernel = which == 0 ? &bmma_peak_kernel
                 : which == 1 ? &imma_peak_kernel : &popc_peak_kernel;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_probe(src: Path, out_dir: Path) -> ctypes.CDLL:
    """nvcc the probe against ``src``'s `csrc/popc_gram.cuh`."""
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "popc_probe.cu"
    cu.write_text(PROBE_SOURCE)
    lib = out_dir / "libpopc_probe.so"
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
         "-I", str(src / "repro_torch" / "csrc"), str(cu), "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{res.stdout}{res.stderr}")
    probe = ctypes.CDLL(str(lib))
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    probe.cuda_core_probe_launch.argtypes = [P, P, I64, I64, I64, P]
    probe.peak_launch.argtypes = [I, P, I, I, I, P]
    return probe


def device_us(fn, name, reps=20):
    """Mean device microseconds a call of the kernels whose name holds
    ``name``, over ``reps`` calls under the profiler (after a warm-up)."""
    import chip_smoke as CS

    def many():
        for _ in range(reps):
            fn()

    _, by_name = CS.traced(many, warmup=True)
    us = [v["device_us"] for k, v in by_name.items() if name in k]
    return sum(us) / reps if us else None


def probe_calls(probe, lib, x, out, sms, stream):
    """The shipped kernel's and the probe's raw launches on ``x`` into
    ``out`` (the pairwise kernel for a batch of one)."""
    B, G, W = x.shape
    if B == 1:
        shipped = functools.partial(
            lib.pairwise_intersections_launch, x.data_ptr(), out.data_ptr(),
            G, W, sms, stream)
    else:
        shipped = functools.partial(
            lib.bitset_intersections_launch, x.data_ptr(), out.data_ptr(),
            B, G, W, B, stream)
    cuda_core = functools.partial(probe.cuda_core_probe_launch, x.data_ptr(),
                                  out.data_ptr(), B, G, W, stream)
    return shipped, cuda_core


def probe_run(src: Path, label: str, reps: int) -> None:
    import torch

    import chip_smoke as CS
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitset_jaccard import ref as R1

    probe = build_probe(src, ROOT / "build" / "popc_probe")
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(1)
    rows = []
    for B, G, W in PROBE_SHAPES:
        x = CS.inter_input(B, G, W, rng)
        want = R1.bitset_intersections(x, B)
        out = torch.empty((B, G, G), dtype=torch.int32, device="cuda")
        shipped, cuda_core = probe_calls(probe, lib, x, out, sms, stream)
        row = {"label": label, "probe": "cuda_core", "shape": [B, G, W]}
        for name, fn in (("b1", shipped), ("cuda_core", cuda_core)):
            out.fill_(-1)
            _build.check_status(name, fn())
            torch.cuda.synchronize()
            row[name] = {
                "max_abs_err": int((out.to(torch.int64)
                                    - want.to(torch.int64)).abs().max()),
                "ms": CS.cuda_ms(fn, reps)}
        row["library_ms"] = CS.cuda_ms(
            CS.pairwise_library(x[0]) if B == 1 else CS.inter_library(x),
            reps)
        rows.append((row, shipped, cuda_core))
    # device times last: a profiler session slows the launches after it
    for row, shipped, cuda_core in rows:
        row["b1"]["device_us"] = device_us(shipped, "intersections_kernel")
        row["cuda_core"]["device_us"] = device_us(cuda_core,
                                                  "cuda_core_probe")
        print(json.dumps(row), flush=True)
    sass = {}
    for path, name in ((ROOT / "build" / "popc_probe" / "libpopc_probe.so",
                        "cuda_core_probe"),
                       (_build.BUILD_INFO["path"], "intersections_kernel")):
        for fn, ops in CS.sass_counts(str(path), name).items():
            sass[fn] = dict(ops)
    print(json.dumps({"label": label, "sass": sass}), flush=True)
    mhz = CS.card_rates()["sm_clock_max_mhz"]
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    blocks, warps, iters = 4 * sms, 8, 2048
    for which, (name, ops) in enumerate(PEAKS):
        ms = CS.cuda_ms(lambda: probe.peak_launch(
            which, flag.data_ptr(), blocks, 32 * warps, iters, stream), 5)
        n = blocks * warps * iters * 8 * (32 if name == "popc" else 1)
        print(json.dumps({
            "label": label, "peak": name, "ms": ms,
            "per_sm_per_clock": n / (ms * 1e-3) / sms / (mhz * 1e6),
            "ops_per_s": n * ops / (ms * 1e-3)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the `src` directory of the checkout to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"popc_bench.py: no repro_torch under {src}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("popc_bench.py: no CUDA card visible to torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    import chip_smoke as CS
    from repro_torch.kernels.bitset_jaccard import kernel as K1

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    rng = np.random.default_rng(0)
    rows = []  # (record, the wrapper call, the kernel's name)
    for B, G, W, valid in CS.INTER_SHAPES:
        x = CS.inter_input(B, G, W, rng)
        call = functools.partial(K1.bitset_intersections, x, valid)
        rows.append(({
            "label": args.label, "kernel": "bitset_intersections",
            "shape": [B, G, W], "valid": valid,
            "kernel_ms": CS.cuda_ms(call, args.reps),
            "library_ms": CS.cuda_ms(CS.inter_library(x), args.reps)},
            call, "bitset_intersections_kernel"))
    for G, W in [*CS.PAIRWISE_SHAPES, (512, 512)]:
        bits = CS.inter_input(1, G, W, rng)[0]
        call = functools.partial(K1.pairwise_intersections, bits)
        rows.append(({
            "label": args.label, "kernel": "pairwise_intersections",
            "shape": [G, W], "kernel_ms": CS.cuda_ms(call, args.reps),
            "library_ms": CS.cuda_ms(CS.pairwise_library(bits), args.reps)},
            call, "pairwise_intersections_kernel"))
    # device times last: a profiler session slows the launches after it
    for row, call, name in rows:
        print(json.dumps({**row, "device_us": device_us(call, name)}),
              flush=True)
    if args.probe:
        probe_run(src, args.label, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
