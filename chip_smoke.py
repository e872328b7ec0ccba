#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SLUGGER (`src/repro_torch`) once on one
CUDA card, and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each printing one JSON line with its seconds:

  device   the card's name and count, and its power limit from nvidia-smi
  build    the CUDA kernels built from `src/repro_torch/csrc` (nvcc, sm_90a);
           the flash, the two intersection, the top-J, the interval-count,
           the fold and the histogram kernels' ptxas resources (registers,
           spills, shared memory) and `cuobjdump -sass` of the library:
           raises unless every bf16 flash kernel holds tensor-core
           instructions (HMMA or HGMMA) and the f32 one none, unless every
           intersection kernel holds the binary MMA (BMMA), and unless the
           fold and histogram kernels have no stack frame and no spills;
           reports the intersection kernels' POPC, BMMA and IMMA counts
  kernels  each kernel against its plain PyTorch version on the card, at
           fixed shapes (the widest, and the resident path's largest top-J
           and fold calls, included; the interval count also at serving's hub tile
           and on inputs past serving's: lo >= hi, negative positions,
           signs of ±3): exact equality, CUDA-event times of the kernel,
           the plain version and, where one exists, a one-call PyTorch
           yardstick
  main     `summarize(caveman(20000, 11, 0.03), backend="batched")` — the
           1.1M-edge graph at T=20 — lossless, with the launch counts of
           all four kernels read from a run that started them at 0, and
           what each histogram call was handed (E, S, padding share,
           distinct ids, runs of equal ids and the longest)
  parity   the host oracle `backend="numpy"` on the same graph, and both
           backends on `rmat(14, 8)`: parent and edges equal bit for bit
  resident the same graph through `backend="resident"`, counts at 0 before
           it: lossless and equal bit for bit to the batched summary, top-J
           and fold launched, stage walls, the per-phase transfer ledger of
           every iteration (steady-state `upload` 0 B after iteration 1),
           peak device memory, top-J and fold calls by shape (the fold's
           with their valid pairs, the groups holding a pair and the
           groups holding each number of pairs); then `rmat(14, 8)`
           resident equal to its batched run (the wide group buckets)
  partitioned  slices E1 and E2 on the same graph: (1) streamed ingestion,
           `PartitionedGraph.from_edge_stream` in 2^18-edge chunks into 2
           partitions with on-disk spill runs under `build/` — equal to the
           graph, no run file left; seconds, the numpy/Python allocation
           peak (tracemalloc) and the process RSS peak; (2) the resident
           engine at `partitions=2, workers=2` on that streamed graph,
           counts at 0 before it: lossless, equal bit for bit to the
           batched summary, top-J and fold launched, steady-state upload
           0 B, stage walls beside the resident `partitions=1` run's; (3)
           `backend="batched", partitions=4, workers=4` with a plan-log
           checkpoint, killed by `faults.inject("engine.merge_round",
           iteration=11)` (the site fires after that iteration's
           merge_round, before its commit), then resumed under
           `backend="resident", partitions=1`: resumed from iteration 10, equal to the batched summary, intersections
           launched in the first run, top-J and fold in the second; the
           commit seconds as a share of each run's merge wall; (4) the
           completed log replayed under `backend="batched", partitions=4`
           (resumed from 20: no merge round left), so the emission runs
           per owner bucket: equal to the batched summary, the histogram
           kernel launched
  faults   slices E3 and E4, each engine run with counts at 0 and exactly
           one degradation, equal bit for bit to its clean run: (1)
           resident under `faults.inject("kernel.bitset_fold.round",
           hit=2)` — the arena retries on the plain versions, top-J and
           fold still launched (counts beside the clean 67 / 39); (2)
           resident under `"resident.bank.advance"` — the run context
           dropped at iteration 1's exchange, top-J and fold launched after
           it on host-uploaded arenas, `upload` bytes by iteration; then
           rmat(12, 8) batched, clean, its launches and rank dispatches
           (`bitset_jaccard.ops.DISPATCHES`) counted, and against it (3)
           rmat(12, 8) resident under `"resident.bank.extract"` — kernels
           launched after it; (4) rmat(12, 8) batched under
           `"kernel.bitset_jaccard.intersections"` at half the clean run's
           rank dispatches — fewer intersection launches than the clean
           run, none zero; (5) `launch.chaos`: five stage kills and
           bit-identical resumes, and its kernel fault on the card; (6)
           `datasets.load_remote("email-Enron", opener=...)` over the main
           graph written as gzipped SNAP text under `build/`, after an
           injected `datasets.fetch` fault that must leave no file: equal
           to the graph; load seconds and file bytes
  serve    each summary (caveman 1.1M batched, then rmat(14, 8)) packed,
           its `.npz` saved under `build/` and loaded back, and 16,384
           `make_queries` queries drained through `SummaryQueryServer` on
           the card with the kernel backend (interval-count launches
           counted from 0), then torch and numpy: all three equal to each
           other and to the input graph's CSR; q/s, call shapes, peak memory
  shingles `node_shingles` (row-min hash kernel) for three sub-seeds equal
           to the host `node_shingles_u32`; `group_jaccard` (pairwise
           kernel) on rmat's 512 highest-degree neighbor sets equal to its
           plain version and to the host sets' Jaccard on sampled pairs
  tooling  slice G, in three parts: (a) after `shingles`, SLUGGER through
           `summarize(T=20, backend="resident")` on caveman(2000, 11, 0.03)
           (109,997 edges; top-J and fold launched, counts from 0) beside
           the flat baselines on the host (`core.baselines`: SWEG at T=20,
           RANDOMIZED, SAGS-like, seed 0; in a worker process while the LM
           phases run, gathered after (b)): every summary lossless,
           relative sizes and seconds; (b) after `lm_serve`, on its weights: one
           prefill of 8 × 1,024 through the dry run's step on a one-rank
           world, counted by `launch.step_analysis` on the card, equal in
           FLOPs, bytes and flash work and launches to the dry run of the
           same step on meta, then timed beside its roofline terms (H100
           data-sheet bounds); (c) inside `lm_train`, on its live state:
           `analytic_hbm`'s params and opt_moments equal to the state's
           tensors' bytes, its gradients and total, and the dry run's
           traced peak, printed beside `max_memory_allocated`
  lm_serve qwen2.5-3b at full width and all 36 layers in bf16, random
           weights from `torch.Generator(seed=0)`: 16 prompts of 1,024
           tokens through `BatchServer(batch_slots=8)`, 32 greedy tokens
           each, flash launches counted from 0 (36 × 2 prefills, all on
           the bf16 tensor-core kernel by its own counter); prefill
           tokens/s, time to first token, decode ms/step, generated
           tokens/s, peak memory; checks (a) flash vs the chunked twin at
           full depth (bf16, relative L2), (b) the same at 2 layers in f32
           (the reference's tolerance), (c) decode steps vs a
           teacher-forced forward
  trace    the batched and the resident paths, the kernel-backend serve
           drains, the shingle calls and the LM drain (8 generated tokens a
           prompt) once more each under `torch.profiler`: device busy time
           by kernel, copy and torch op against each run's wall time
  lm_mla_moe  slices F2 + F3, after the traces, qwen2.5-3b's weights gone
           from the card: deepseek-v2-lite-16b (MLA + 64 routed and 2
           shared experts, top-6) at full width and all 27 layers in bf16,
           16,210,324,992 random parameters from `torch.Generator(seed=0)`:
           16 prompts of 1,024 tokens through `BatchServer(batch_slots=8)`,
           32 greedy tokens each, capacity factor 1.25; flash launches
           counted from 0 (27 × 2 prefills, all on the bf16 tensor-core
           kernel, every call at q/k width 192 and v width 128), dropped
           pairs per prefill, the serving metrics of `lm_serve`; checks
           (a) flash vs the chunked twin, the flash run's MoE routing
           pinned to the twin's (the free run's flipped choices
           reported), in bf16 at full depth (clear greedy tokens) and in
           f32 on the first 4 layers, (c) 8 decode steps of one prompt vs
           a teacher-forced forward at capacity factor n_experts in f32
           on those 4 layers, (d) `mla_decode_absorbed` vs `mla_decode`
           on one layer in f32, both timed, and the served model's decode
           ms/step under each; one batch (prefill and 8 decode steps)
           traced; then qwen3-moe-235b-a22b at full width cut to 2 of its
           94 layers: 8 prompts × 1,024, 8 greedy tokens, 2 flash
           launches, check (a) in f32 at those 2 layers
  lm_ssm_encdec  slices F4 + F5: mamba2-130m, zamba2-7b and whisper-small
           whole (`phase_lm_ssm_encdec`)
  lm_vlm   slice F6: internvl2-26b at full width and all 48 layers in
           bf16 (19,860,664,320 parameters by `param_count`), random
           weights from `torch.Generator(seed=0)`: 16 requests of
           `make_batch`'s 1,024 patch embeddings and 1,024 text tokens
           through `api.prefill` and `api.decode_step` (a cache of patches
           + text + 32 generated slots), batches of 8, 32 greedy tokens;
           flash launches counted from 0 (exactly 96, all `tc_bf16` at
           (8, 48, 8, 2048, 2048), D 128); init seconds, prefill tokens/s
           (patches and text), TTFT, decode ms/step, peak memory; checks
           (ii) flash vs the chunked twin in bf16 at full depth (clear
           greedy tokens) and in f32 on the first 4 layers, (iii) patch
           embeddings that are the table's rows of a token prefix equal
           that prefix as tokens, in f32 on those layers, (iv) 8 decode
           steps vs a teacher-forced forward with the same embeddings, in
           f32 on those layers
  multi_device  slice E5 (the data axis) on a one-rank NCCL group
           (`phase_multi_device`): (a) the main graph through
           `SummarizerEngine(mesh=make_data_mesh())`, batched and
           resident, counts at 0 before each: lossless, equal bit for bit
           to the main batched summary, intersections and histogram
           launched by the batched run, top-J and fold by the resident
           one; walls and launches beside the no-mesh runs'; (b) the
           sharded functions' per-rank bodies for ranks 0-3 of world 4,
           one after the other on the card — the node shingles of the
           main graph's edge blocks, the intersection kernel on a real
           tile batch of (a) with each shard's valid count, and one
           arena round (the top-J proposal and the fold) on a real arena
           of (a) — each concatenation equal to the unsharded call; (c)
           qwen2.5-3b at full width and depth through the data-parallel
           step with ZeRO-1, 4 steps of 4 × 1,024: the losses equal bit
           for bit `lm_train`'s plain step's first 4 (same seed, batch and
           schedule; both rerun under deterministic algorithms if not);
           seconds a step and peak memory beside `lm_train`'s; (e) that
           state (f32 moments) moved by `elastic.remesh_state` with no
           device named onto `make_mesh_for([0], 1)` under
           `state_specs`: every leaf gathered whole bit-equal to the state
           before the move (one leaf at a time, against checksums of its
           bit patterns), every block on `cuda:0`, one more step through
           `build_train_step` on the new mesh with a finite loss, and the
           state after it moved back onto (c)'s mesh the same way and
           checked the same way; seconds, bytes moved and peak memory a
           move; (d) `compressed_psum` on 2^24 values equal to quantize →
           dequantize of g + err, and its time
  lm_train slice F7: (a) qwen2.5-3b at full width and all 36 layers
           trained 6 steps (bf16 parameters, f32 AdamW moments, remat
           full, 4 × 1,024 tokens a step) through `ResilientLoop`: every
           loss finite, 0 flash launches; seconds a step, tokens/s, peak
           memory, the model-FLOPs share; (b) the same width at 2 layers
           in f32, batch 1 × 128: loss, grad norm and every gradient on the
           card equal the CPU's (atol 2e-4, rtol 1e-3), and
           `torch.autograd.gradcheck` in f64 on the card of `rms_norm` and
           `lowp_matmul_f32`; (c) mamba2-130m whole through
           `launch.train.main(["--device", "cuda", ...])`, 8 steps with
           checkpoints every 4, a failure at step 6 on every attempt:
           restored from step 4, its final state equal bit for bit to an
           uninterrupted run's (under deterministic algorithms if two
           uninterrupted runs differ; their gap is printed)
  model_axis  slice E6a (`phase_model_axis`), after `multi_device`:
           per-rank bodies of a model axis of m run for ranks 0..m-1 one
           after the other on the card (`local_ranks.run_ranks`), at full
           width in f32, each held to the unsharded block on the same
           input within max|Δ| ≤ 1e-4·max|ref| + 1e-5 — qwen2.5-3b's
           attention block and MLP at m 2 and 4 (a 4 × 1,024 prefill, 8
           decode steps; at m 4 k and v gathered and the cache's time
           over the model axis) and its vocab-parallel embedding (exact)
           and logits at m 4; deepseek-v2-lite-16b's MLA under
           `mla_decode` and `mla_decode_absorbed` and its MoE (16
           experts a rank, routing integers equal); zamba2-7b's Mamba2
           block and shared attention block (D 112); whisper-small's
           encoder layer over 1,500 frames and cross call; each block's
           flash launches counted from 0 (none fails the phase) and
           the kernel's ms at the rank's head counts beside the
           unsharded call's, on the phase's own lines
  model_axis_train  slice E6b (`phase_model_axis_train`), after
           `model_axis`: the same per-rank bodies forward and backward at
           full width in f32, 4 × 1,024 tokens, each leaf's gradient
           SUMmed by the train step's reduction (`train_step.
           reduce_grads`) and assembled from the ranks' blocks, and each
           input's gradient summed over the ranks, held to the unsharded
           ones within max|Δ| ≤ 1e-4·max|ref| + 1e-5 — qwen2.5-3b cut to
           one layer with its vocabulary-parallel embedding, lm_head and
           loss at m 2 and 4, deepseek-v2-lite-16b's MLA block and MoE
           FFN (routing integers equal) at m 4, zamba2-7b cut to one
           Mamba2 layer and its shared block, whisper-small cut to one
           encoder and one decoder layer (m 4) — then two AdamW steps of
           qwen2.5-3b cut to 2 layers at m 2 (the clipping norm across
           the ranks) against one device's `build_train_step`; no flash
           launch (training attends through the chunked twin)
  examples slice H (`phase_examples`), last: the five user scripts
           `examples/torch_*.py` run in this process on the card at their
           default arguments, one line a script with its seconds, the
           last lines it printed and its launches of each hand-written
           kernel, every count from 0 — each graph script's summary
           and printed results equal to its run with `--device cpu` (the
           MoE script's summary to the CPU's summary of the card's
           graph), the quickstart's and the query script's through the
           batched summarizer's intersection and histogram kernels,
           `torch_serve_lm` through flash, held to the plain version at
           every call shape its wrapper received, `torch_train_lm` with
           no flash launch and a falling loss

The kernels phase also holds the flash-attention kernel to its plain
version (f32, TF32 off) within the reference's tolerances at ten fixed
shapes, two of them with v narrower than q and k (MLA's prefill call,
D 192 and Dv 128, in bf16, and MLA's widths on ragged f32 tiles), three
of slice F4 + F5 (zamba2's shared-block call at head dim 112, whisper's
encoder call and its decode cross call, one query row over 1,500 keys),
beside SDPA's time where SDPA takes the call, each row naming the variant its
counters saw launch (bf16 on the tensor cores, f32 on the CUDA cores);
and once more at the two serving calls through `ops.flash_attention` on
the model's tensors, which the kernel reads by strides (MLA's v a view
of its expansion).

The line before the last is the per-kernel record; each kernel's launches
come from its own path's counted run (batched for the intersections and
the histogram, resident for top-J and the fold, both serve drains for the
interval count, the shingles phase for the row-min hash and the pairwise
intersections, the LM drains of qwen2.5-3b, deepseek, zamba2, whisper and
internvl2 for flash attention; the `model_axis` phase prints its own
flash launches and times), its
times are sums over
every call that run made (each call, or each distinct call shape, checked
against the plain version, timed, and weighted by its call count).
Every engine run outside the injected ones must report
``stats["degradations"] == 0``: a kernel that failed and fell back to its
plain version fails the script. The last line is
``{"ok": true, "device": {...}}``. Any failure raises: the script then
exits non-zero without that line. Without a card, or outside a checkout,
it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Results per SM per clock on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput): 32-bit integer add, compare
# and bitwise AND issue on 64 lanes, 32-bit population count on 16. The
# rates below multiply these by the card's SM count and its maximum SM
# clock, both read from the card (`card_rates`).
INT32_LANES_PER_SM = 64
POPC_LANES_PER_SM = 16

INTER_SHAPES = [(64, g, w, 64) for g in (8, 16, 32, 64, 128)
                for w in (8, 64, 256)] + [(64, 16, 8, 37)]
# (E, S): wide random ids, many ids a bin, and the batched main path's
# largest call
HIST_SHAPES = [((1 << 17), (1 << 18)), ((1 << 20), (1 << 15)),
               ((1 << 21), (1 << 17))]
# (B, G, Wp, J): small, main-path-like, the resident main path's two
# largest calls (G = 8 and 16 at 2 words, J = G - 1) and the widest
TOPJ_SHAPES = [(3, 2, 2, 1), (4096, 16, 2, 15), (32768, 8, 2, 7),
               (32768, 16, 2, 15), (64, 128, 256, 16)]
# (B, G, Wp, P) of the fold: the narrow regime (G <= 32, W <= 8) at the
# resident path's largest calls, and the wide one with its bitmap staged in
# shared memory (G*(W+1) words <= 192 KB) and past that, in global memory
FOLD_SHAPES = [(7, 32, 2, 16), (4096, 16, 2, 8), (32768, 8, 2, 4),
               (32768, 16, 2, 8), (64, 128, 256, 64), (16, 128, 384, 32)]
# (layout, B, E, P): random tiles (`interval_input`: caveman-like, wide,
# the widest and the one-probe `edge_exists` tile); serving's hub tile
# (`interval_serving_input`: one row of E real intervals, the rest of at
# most 16, probing every sorted boundary as `query_batch._ranges_kernel`
# does); and any-int32 input (`interval_edge_input`: lo >= hi, negative
# positions, signs of ±3)
INTERVAL_SHAPES = [("random", 256, 128, 256), ("random", 256, 512, 1024),
                   ("random", 64, 4096, 8192), ("random", 256, 512, 1),
                   ("serving", 256, 4096, 8192), ("edge", 64, 1000, 3000)]
ROWMIN_SHAPES = [(220000, 128), (1 << 20, 128), (4099, 1000)]  # (R, W)
PAIRWISE_SHAPES = [(37, 5), (128, 128), (512, 6875)]  # (G, W)
INGEST_CHUNK = 1 << 18  # edges a chunk of the streamed ingestion
CRASH_AT = 11  # iteration the partitioned phase's checkpointed run dies in
SERVE_QUERIES = 16384
SERVE_SLOTS = 256
SHINGLE_SEEDS = (0, 1, 2)
JACCARD_ROWS = 512
# The HBM rate and the bf16 and f32 dense peaks are the port's roofline's
# (`src/repro_torch/launch/roofline.py`, `roofline()`). The int8 dense peak
# on the tensor cores is the H100 SXM data sheet's. The data sheet gives no
# binary (b1) rate: on the card the b1 MMA m16n8k256 issues at the int8 MMA
# m16n8k32's rate (`popc_bench.py --probe`: both ≈ 0.6 a clock an SM) with
# 8 times the element pairs, so it is taken as 8 times the int8 peak (2
# operations a bit pair, as int8 counts 2 an element pair).
INT8_OPS_PER_S = 1.979e15
B1_OPS_PER_S = 8 * INT8_OPS_PER_S
# (B, H, Hkv, Sq, Sk, D, Dv, dtype, causal, window): the serving prefill's
# call (qwen2.5-3b, 8 prompts of 1,024), one long prompt, danube's heads past
# its window, non-causal Sq != Sk, ragged f32 tiles; MLA's prefill call
# (deepseek-v2-lite-16b, 8 prompts of 1,024: q/k 192 wide, v 128), MLA's
# widths on ragged f32 tiles; zamba2-7b's shared block (head dim 112, 8
# prompts of 1,024), whisper-small's encoder (1,500 frames, non-causal)
# and its decode cross call (one query row over 1,500 frames)
FLASH_SHAPES = [(8, 16, 2, 1024, 1024, 128, 128, "bfloat16", True, 0),
                (1, 16, 2, 4096, 4096, 128, 128, "bfloat16", True, 0),
                (1, 32, 8, 6144, 6144, 80, 80, "bfloat16", True, 4096),
                (2, 12, 12, 256, 1536, 64, 64, "bfloat16", False, 0),
                (2, 4, 2, 300, 300, 32, 32, "float32", True, 64),
                (8, 16, 16, 1024, 1024, 192, 128, "bfloat16", True, 0),
                (2, 16, 16, 300, 300, 192, 128, "float32", True, 0),
                (8, 32, 32, 1024, 1024, 112, 112, "bfloat16", True, 0),
                (8, 12, 12, 1500, 1500, 64, 64, "bfloat16", False, 0),
                (8, 12, 12, 1, 1500, 64, 64, "bfloat16", False, 0)]
MLA_SHAPE = FLASH_SHAPES[5]
# the reference's tolerances (tests/test_flash_attn_kernel.py:21)
FLASH_ATOL = {"bfloat16": 2e-2, "float32": 2e-5}
FLASH_RTOL = 1e-2
LM_ARCH = "qwen2.5-3b"
LM_PROMPTS, LM_PROMPT_LEN, LM_GEN, LM_SLOTS = 16, 1024, 32, 8
LM_F32_ATOL, LM_F32_RTOL = 2e-4, 1e-3  # tests/test_flash_attn_kernel.py:68
LM_DECODE_CHECK = 8   # decode steps held to the teacher-forced forward
# decode steps the lm-serve trace records: its flash calls are all in the
# prefills, and the profiler's own cost grows with decode's ≈ 3,200
# launches a step (45 s for the whole drain of 32 tokens)
LM_TRACE_GEN = 8
MLA_MOE_ARCH = "deepseek-v2-lite-16b"
MLA_MOE_F32_LAYERS = 4    # depth of the f32 checks (the f32 copy's cut)
# prompts of check (c): at capacity factor n_experts every expert's buffer
# holds all of a row's pairs (cap 6,144 at 1,024 tokens), 3.2 GB a row of
# f32 buffer per layer
MLA_MOE_C_ROWS = 1
MLA_MOE_TRACE_GEN = 9     # traced batch: prefill + 8 decode steps
GQA_MOE_ARCH, GQA_MOE_LAYERS = "qwen3-moe-235b-a22b", 2  # 12.4 GB of 470
GQA_MOE_GEN = 8
SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH = "mamba2-130m", "zamba2-7b", "whisper-small"
SSM_DECODE_ATOL = 5e-2    # tests/test_serving.py:62-69: these families'
HYBRID_TRACE_GEN = 9      # traced batch: prefill + 8 decode steps
ENC_LEN = 1500            # frame embeddings of Whisper's 30-second window
ENC_PROMPT_LEN = 64       # whisper's decoder prompt
VLM_ARCH = "internvl2-26b"  # 1,024 patch embeddings before each prompt
VLM_F32_LAYERS = 4        # depth of the f32 checks (an f32 copy's cut)
HYBRID_F32_LAYERS = 12    # zamba2's f32 flash check: 2 groups, 2 shared
VLM_PREFIX_ROWS = 2       # rows of the prefix-identity check
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6  # qwen2.5-3b trained whole
TRAIN_PARITY_LAYERS, TRAIN_PARITY_SEQ = 2, 128    # card == CPU, f32
RESUME_STEPS, RESUME_CKPT_EVERY, RESUME_FAIL_AT = 8, 4, 6  # mamba2-130m
# the user scripts of `examples/`, in the reference's order
EXAMPLE_SCRIPTS = ("quickstart", "summarize_and_query", "moe_routing_graph",
                   "serve_lm", "train_lm")


def emit(phase: str, t0: float, **fields):
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0,
                      **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, after a
    warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- inputs/bounds
def roofline():
    """The port's H100 roofline (`repro_torch.launch.roofline`): the
    data-sheet rates (``HBM_BYTES_PER_S``, ``PEAK_FLOPS``), the flash
    kernel's work and a step's model FLOPs. Imported when first used, once
    `main` has put ``src/`` on the path."""
    from repro_torch.launch import roofline as RL

    return RL


def inter_input(B, G, W, rng):
    import numpy as np
    import torch

    words = rng.integers(0, 1 << 32, size=(B, G, W), dtype=np.uint64)
    words[0, 0, :] = 0xFFFFFFFF  # all-ones words
    return torch.from_numpy(words.astype(np.uint32).view(np.int32)).cuda()


def card_rates():
    """Peak 32-bit integer and popcount rates of card 0: lanes per SM times
    its SM count times its maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    return {"sms": sms, "sm_clock_max_mhz": mhz,
            "int32_ops_per_s": INT32_LANES_PER_SM * sms * mhz * 1e6,
            "popc_per_s": POPC_LANES_PER_SM * sms * mhz * 1e6,
            "hbm_bytes_per_s": roofline().HBM_BYTES_PER_S}


def gram_ops_bound_s(pairs, rates):
    """The least time of ``pairs`` word pairs' AND-popcounts over the units
    the card has: on the CUDA cores each takes an AND and an ADD on the
    integer lanes and a POPC on its own unit, which issue side by side (the
    slower bounds); on the tensor cores it is 32 bit pairs of 2 operations
    each, in int8 on the bits unpacked to 0/1 or in b1 on the packed words.
    Returns (seconds, the unit that gives them)."""
    return min((max(2 * pairs / rates["int32_ops_per_s"],
                    pairs / rates["popc_per_s"]), "popc_lanes"),
               (2 * pairs * 32 / INT8_OPS_PER_S, "int8_tensor_cores"),
               (2 * pairs * 32 / B1_OPS_PER_S, "b1_tensor_cores"))


def inter_bound_s(B, G, W, valid, rates):
    """Rows ``b >= valid`` are neither read nor needed; the whole (B, G, G)
    output is written. The matrix is symmetric, so each valid row needs
    G·(G + 1)/2 row pairs of W word pairs (`gram_ops_bound_s`). Returns
    the bytes' and the operations' times and the operations' unit."""
    by_bytes = (valid * G * W * 4 + B * G * G * 4) / rates["hbm_bytes_per_s"]
    return (by_bytes, *gram_ops_bound_s(valid * G * (G + 1) // 2 * W, rates))


def topj_input(B, G, W, rng):
    import numpy as np
    import torch

    alive = (rng.random((B, G)) < 0.85).astype(np.int8)
    return inter_input(B, G, W, rng), torch.from_numpy(alive).cuda()


def select_compares(c, J):
    """A lower bound on the compares that pick the min(J, c) largest of c
    distinct keys in order: every key but the largest loses at least once
    (c − 1), and the answer is one of c!/(c − k)! ordered choices."""
    k = min(J, c)
    return max(c - 1, math.ceil(sum(math.log2(c - t) for t in range(k))), 0)


@functools.lru_cache(maxsize=None)
def select_table(G, J, device):
    """`select_compares` for c = 0..G on ``device``, built once per shape
    (an upload per call would sync the host with the card)."""
    import torch

    return torch.tensor([select_compares(c, J) for c in range(G + 1)],
                        dtype=torch.int64, device=device)


def topj_work(alive, J):
    """What top-J needs of one call's data, as a device tensor ``[pairs,
    keys, live groups, compares]`` (no host sync). Only alive columns get
    a key and a key is symmetric in its row pair, so a group with a alive
    rows needs the C(G, 2) − C(G − a, 2) row pairs with an alive member,
    a·(G − 1) combined keys, and — if a > 0 — its bits and G degrees;
    dead and self columns are ranked last in a fixed order, so each row
    selects among its alive other columns only (`select_compares`)."""
    import torch

    G = alive.shape[1]
    table = select_table(G, J, alive.device)
    a = (alive > 0).sum(dim=1, dtype=torch.int64)
    d = G - a
    return torch.stack([
        (G * (G - 1) // 2 - d * (d - 1) // 2).sum(), (a * (G - 1)).sum(),
        (a > 0).sum(),
        (a * table[(a - 1).clamp(min=0)] + d * table[a]).sum()])


def topj_bound_s(B, G, W, J, calls, pairs, keys, live, compares, rates):
    """``calls`` calls of one shape, the rest summed over them
    (`topj_work`). Bytes: the live groups' bits, alive and the output
    once each. Operations: each needed row pair and each live row's
    degree is W word pairs, at the least time over the POPC lanes, int8
    and b1 (`gram_ops_bound_s`); each needed pair's key takes at least 8
    integer operations (union, bit length, shifts, the divide counted as
    one), each combined key 3 more, plus the selections' compares, on the
    integer lanes, which run beside the word pairs' unit (the slower of
    the two bounds). Returns the bytes' and the operations' times and the
    word pairs' unit."""
    by_bytes = (live * G * W * 4 + calls * (B * G + B * G * J * 4)) / rates[
        "hbm_bytes_per_s"]
    by_pairs, unit = gram_ops_bound_s((pairs + live * G) * W, rates)
    ints = 8 * pairs + 3 * keys + compares
    return by_bytes, max(by_pairs, ints / rates["int32_ops_per_s"]), unit


def fold_input(B, G, W, P, n_valid, rng):
    """bits, alive and an instruction slab of ``n_valid`` pairs, dealt
    round-robin over the groups (pair k: group k % B, slot k // B); each
    group's pairs take disjoint rows, and columns that share 32-bit words
    and include bit 31."""
    import numpy as np
    import torch

    instr = np.zeros((B, P, 8), dtype=np.int32)
    rows = np.argsort(rng.random((B, G)), axis=1)
    cols = np.argsort(rng.random((B, W * 32)), axis=1)[:, : 2 * P]
    cols[:, :4] = [31, 30, 63 if W > 1 else 29, 0]
    k = np.arange(n_valid)
    b, p = k % B, k // B
    ca, cz = cols[b, 2 * p], cols[b, 2 * p + 1]
    instr[b, p] = np.stack([rows[b, 2 * p], rows[b, 2 * p + 1], ca >> 5,
                            ca & 31, cz >> 5, cz & 31, np.ones_like(ca),
                            np.zeros_like(ca)], axis=1)
    alive = torch.ones((B, G), dtype=torch.int8, device="cuda")
    return inter_input(B, G, W, rng), alive, torch.from_numpy(instr).cuda()


def fold_work(instr, G, W):
    """What the fold needs of one call's data, as a device tensor
    ``[valid pairs, touched words]`` (no host sync). A group's pairs touch
    the words of their member columns in every row (d distinct words) and
    the whole of their two rows each (r = 2·pairs rows), each word once
    however many pairs share it: G·d + r·W − r·d ≤ G·W words per group."""
    import torch

    ok = instr[..., 6] > 0
    seen = torch.zeros((instr.shape[0], W + 1), dtype=torch.bool,
                       device=instr.device)
    for col in (2, 4):  # wa, wz; padding rows land in the spare column W
        seen.scatter_(1, torch.where(ok, instr[..., col].to(torch.int64), W),
                      True)
    d = seen[:, :W].sum(dim=1, dtype=torch.int64)
    r = 2 * ok.sum(dim=1, dtype=torch.int64)
    return torch.stack([r.sum() // 2, (G * d + r * W - r * d).sum()])


def fold_bound_s(B, G, W, P, calls, n_valid, touched, rates):
    """``calls`` calls of one shape, ``n_valid`` and ``touched`` summed
    over them (`fold_work`). Each call's (B, P, 8) slab is read once; each
    touched word is read and written once, and alive once per pair. Each
    pair moves one bit in every row (about 6 integer operations) and ORs
    two rows (2 per word)."""
    by_bytes = (calls * B * P * 32 + 8 * touched + n_valid) / rates[
        "hbm_bytes_per_s"]
    return by_bytes, n_valid * (6 * G + 2 * W + 4) / rates["int32_ops_per_s"]


def hist_input(E, S, rng):
    import numpy as np
    import torch

    ids = rng.integers(0, S, size=E).astype(np.int32)
    ids[rng.random(E) < 0.25] = -1  # padding
    return torch.from_numpy(ids).cuda()


def hist_bound_s(ids, S, rates):
    """Every id is read and range-checked (two compares), each valid one
    adds one; the (S,) output is written once."""
    E = int(ids.numel())
    n_valid = int((ids >= 0).sum())
    return ((E * 4 + S * 4) / rates["hbm_bytes_per_s"],
            (2 * E + n_valid) / rates["int32_ops_per_s"])


def hist_call_stats(ids, S):
    """What one histogram call was handed: E, S, the padding share (ids
    outside [0, S)), distinct ids, runs of equal consecutive ids among the
    counted ones (one atomic each in the kernel's run folding, but for
    runs cut at a warp's 128-id span), the longest run, and the distinct
    ids of each 128-id span summed (the atomics a group-by over a warp's
    span would leave)."""
    import torch

    E = int(ids.numel())
    counted = (ids >= 0) & (ids < S)
    vals, lens = torch.unique_consecutive(ids, return_counts=True)
    keep = (vals >= 0) & (vals < S)
    n = int(counted.sum())
    span = torch.arange(E, device=ids.device)[counted] // 128
    return {"E": E, "S": S, "padding_share": 1 - n / E if E else 0.0,
            "distinct": int(torch.unique(ids[counted]).numel()),
            "runs": int(keep.sum()),
            "longest_run": int(lens[keep].max()) if n else 0,
            "span_distinct": int(torch.unique(
                span * S + ids[counted].to(torch.int64)).numel())}


def inter_library(bits):
    """One bmm over the bits unpacked to 0/1 in fp16 (exact products and
    fp32 accumulation; the unpacking is set-up, not timed)."""
    import torch

    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    B, G, W = bits.shape
    shifts = torch.arange(32, device=bits.device, dtype=torch.int32)
    unpacked = ((bits[..., None] >> shifts) & 1).reshape(B, G, W * 32)
    a = unpacked.to(torch.float16)
    at = a.transpose(1, 2).contiguous()
    return lambda: torch.bmm(a, at)


def exact_error(name, got, want, what):
    """max |kernel − plain| of one call; raises unless 0."""
    import torch

    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if err or got.shape != want.shape:
        raise AssertionError(f"{name} {what}: max |kernel − plain| = {err}, "
                             f"shapes {tuple(got.shape)} {tuple(want.shape)}")
    return err


def interval_input(B, E, P, rng, span=1 << 15):
    """Intervals of 1..4095 positions over a DFS range of ``span`` and
    probes over it, a quarter of each padded (lo == hi == 0, sign 0; -1)."""
    import numpy as np
    import torch

    lo = rng.integers(0, span, size=(B, E)).astype(np.int32)
    hi = lo + rng.integers(1, 4096, size=(B, E)).astype(np.int32)
    sg = rng.choice([-1, 1], size=(B, E)).astype(np.int32)
    pad = rng.random((B, E)) < 0.25
    lo[pad] = hi[pad] = sg[pad] = 0
    pos = rng.integers(0, span, size=(B, P)).astype(np.int32)
    pos[rng.random((B, P)) < 0.25] = -1
    return tuple(torch.from_numpy(a).cuda() for a in (lo, hi, sg, pos))


def interval_serving_input(B, E, rng, span=1 << 14):
    """Serving's layout of one wide tile (`query_batch._padded_batch` and
    `_ranges_kernel`): row 0, the hub, holds E real intervals, every other
    row 1..16; slots past a row's count are (0, 0, 0); the probes are every
    row's 2E boundaries, sorted, padding's 0s included."""
    import numpy as np
    import torch

    n = rng.integers(1, 17, size=B)
    n[0] = E
    real = np.arange(E)[None, :] < n[:, None]
    lo = np.where(real, rng.integers(0, span, size=(B, E)), 0)
    hi = np.where(real, lo + rng.integers(1, 512, size=(B, E)), 0)
    sg = np.where(real, rng.choice([-1, 1], size=(B, E)), 0)
    pos = np.sort(np.concatenate([lo, hi], axis=1), axis=1)
    return tuple(torch.from_numpy(a.astype(np.int32)).cuda()
                 for a in (lo, hi, sg, pos))


def interval_edge_input(B, E, P, rng, span=1 << 12):
    """Inputs past serving's: a third of the intervals with lo >= hi,
    positions and bounds negative and positive, signs of ±1, ±3 and 0."""
    import numpy as np
    import torch

    lo = rng.integers(-span, span, size=(B, E))
    hi = lo + rng.integers(-span // 2, span, size=(B, E))
    sg = rng.choice([-3, -1, 0, 1, 3], size=(B, E))
    pos = rng.integers(-2 * span, 2 * span, size=(B, P))
    return tuple(torch.from_numpy(a.astype(np.int32)).cuda()
                 for a in (lo, hi, sg, pos))


INTERVAL_INPUTS = {"random": interval_input, "edge": interval_edge_input,
                   "serving": lambda B, E, P, rng: interval_serving_input(
                       B, E, rng)}


def interval_work(lo, hi, sign, pos):
    """What one call's data needs: its real intervals (sign != 0 and
    lo < hi) and the probes of the rows that hold one (a row without one
    answers 0 to every probe unread). Ints, one host sync."""
    import torch

    real = ((sign != 0) & (lo < hi)).sum(dim=1, dtype=torch.int64)
    return torch.stack([real.sum(), ((real > 0) * pos.shape[1]).sum()]
                       ).tolist()


def interval_bound_s(B, E, P, intervals, probes, rates):
    """Every input slot is read once (the kernel has no count of the real
    ones) and the (B, P) output written once. Operations: each real
    interval and each probe of a row that has one handled once, one
    integer operation each. The brute (real interval, probe) pairs are no
    lower bound: sorting a row's intervals once and searching each probe
    computes the same function in O((n + P) log n), and any algorithm must
    still look at every interval and every probe."""
    by_bytes = ((3 * B * E + B * P) * 4 + B * P * 4) / rates["hbm_bytes_per_s"]
    return by_bytes, (intervals + probes) / rates["int32_ops_per_s"]


def rowmin_input(R, W, seed):
    """Packed-adjacency-like rows made on the card: row r holds 1..W
    random u32 words, then sentinels (int32 -1)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    words = torch.randint(-(1 << 31), (1 << 31) - 1, (R, W), generator=gen,
                          dtype=torch.int32, device="cuda")
    fill = torch.randint(1, W + 1, (R, 1), generator=gen, device="cuda")
    cols = torch.arange(W, device="cuda")[None, :]
    return torch.where(cols < fill, words, -1).contiguous()


def rowmin_bound_s(nbr, rates):
    """Every word read once, the (R,) output written once; each word takes
    a sentinel compare and each real word eight more integer operations
    (two multiplies, an add, two shifts, two xors, the min)."""
    R, W = nbr.shape
    n_valid = int((nbr != -1).sum())
    return ((R * W * 4 + R * 4) / rates["hbm_bytes_per_s"],
            (R * W + 8 * n_valid) / rates["int32_ops_per_s"])


def pairwise_bound_s(G, W, rates):
    """The (G, W) bits read once and the (G, G) output written once; the
    matrix is symmetric, so G·(G + 1)/2 row pairs of W word pairs are
    needed (`gram_ops_bound_s`)."""
    return ((G * W * 4 + G * G * 4) / rates["hbm_bytes_per_s"],
            *gram_ops_bound_s(G * (G + 1) // 2 * W, rates))


def pairwise_library(bits):
    """One fp16 matmul of the bits unpacked to 0/1 (exact products, fp32
    accumulation; the unpacking is set-up, not timed)."""
    import torch

    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    G, W = bits.shape
    shifts = torch.arange(32, device=bits.device, dtype=torch.int32)
    a = ((bits[..., None] >> shifts) & 1).reshape(G, W * 32).to(torch.float16)
    at = a.t().contiguous()
    return lambda: torch.matmul(a, at)


def bound_fields(bb, bo, unit=None):
    """``unit``: the unit whose rate gives the operations' time, where the
    bound takes the least over several (`gram_ops_bound_s`)."""
    return {"bound_us": max(bb, bo) * 1e6,
            "bound_by": "bytes" if bb >= bo else "operations",
            **({"bound_unit": unit} if unit else {})}


def new_kernel_rows(rng, rates):
    """The interval-count, row-min hash and pairwise-intersection kernels
    at their fixed shapes: exact against the plain versions, timed."""
    import torch

    from repro_torch.kernels.bitset_jaccard import kernel as K1, ref as R1
    from repro_torch.kernels.interval_expand import kernel as KI, ref as RI
    from repro_torch.kernels.minhash import kernel as KM, ref as RM

    rows = []
    for kind, B, E, P in INTERVAL_SHAPES:
        x = INTERVAL_INPUTS[kind](B, E, P, rng)
        err = exact_error("interval_count", KI.interval_counts(*x),
                          RI.interval_counts(*x), (kind, B, E, P))
        rows.append({
            "kernel": "interval_count", "layout": kind, "shape": [B, E, P],
            "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: KI.interval_counts(*x), 20),
            "plain_ms": cuda_ms(lambda: RI.interval_counts(*x), 2),
            "library_ms": None,
            **bound_fields(*interval_bound_s(B, E, P, *interval_work(*x),
                                             rates))})
    for R, W in ROWMIN_SHAPES:
        nbr = rowmin_input(R, W, seed=R + W)
        a, b = 2654435761, 0x9E3779B9
        err = exact_error("rowmin_hash", KM.rowmin_hash(nbr, a, b),
                          RM.rowmin_hash(nbr, a, b), (R, W))
        rows.append({
            "kernel": "rowmin_hash", "shape": [R, W], "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: KM.rowmin_hash(nbr, a, b), 20),
            "plain_ms": cuda_ms(lambda: RM.rowmin_hash(nbr, a, b), 2),
            "library_ms": None, **bound_fields(*rowmin_bound_s(nbr, rates))})
    for G, W in PAIRWISE_SHAPES:
        bits = inter_input(1, G, W, rng)[0]
        err = exact_error("pairwise_intersections",
                          K1.pairwise_intersections(bits),
                          R1.pairwise_intersection(bits), (G, W))
        rows.append({
            "kernel": "pairwise_intersections", "shape": [G, W],
            "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: K1.pairwise_intersections(bits), 20),
            "plain_ms": cuda_ms(lambda: R1.pairwise_intersection(bits), 2),
            "library_ms": cuda_ms(pairwise_library(bits), 10),
            **bound_fields(*pairwise_bound_s(G, W, rates))})
    return rows


# ------------------------------------------------------------ flash attention
def flash_bound_s(B, H, Hkv, Sq, Sk, D, Dv, dtype, causal, window):
    """`roofline.flash_work` of the call: its bytes (q, k, v and o read or
    written once) over the HBM rate, its operations (2·(D + Dv) per visible
    (query, key) pair) at the card's dense peak for the inputs' type."""
    RL = roofline()
    flops, nbytes = RL.flash_work(B, H, Hkv, Sq, Sk, D, Dv,
                                  2 if dtype == "bfloat16" else 4, causal,
                                  window)
    return nbytes / RL.HBM_BYTES_PER_S, flops / RL.PEAK_FLOPS[dtype]


def flash_input(B, H, Hkv, Sq, Sk, D, Dv, dtype, rng):
    import numpy as np
    import torch

    dt = getattr(torch, dtype)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dt).cuda() for s in ((B, H, Sq, D), (B, Hkv, Sk, D),
                                     (B, Hkv, Sk, Dv))]


def flash_library(q, k, v, causal, window):
    """One `scaled_dot_product_attention` call of the same function (GQA
    by ``enable_gqa``; a window as a boolean mask), or None with the
    reason when SDPA refuses the call (v narrower than q and k). Timed,
    never used by the port."""
    import torch
    import torch.nn.functional as F

    mask = None
    if causal and window:
        qpos = torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
    is_causal = causal and not window

    def call():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=is_causal, enable_gqa=True)

    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, f"SDPA refuses E {q.shape[-1]}, Ev {v.shape[-1]}: " \
            f"{str(e).splitlines()[0][:160]}"
    return call, None


def library_fields(q, k, v, causal, window, reps=10):
    """``library_ms`` of `flash_library`, and its note when it has none."""
    call, why = flash_library(q, k, v, causal, window)
    if call is None:
        return {"library_ms": None, "library_note": why}
    return {"library_ms": cuda_ms(call, reps)}


def flash_error(q, k, v, causal, window):
    """max |kernel − plain| of `flash_attention_bhsd`; raises beyond the
    reference's tolerance. The plain version runs in full f32 (TF32 off)."""
    import torch

    from repro_torch.kernels.flash_attn import kernel as KF, ref as RF

    torch.backends.cuda.matmul.allow_tf32 = False
    got = KF.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    want = RF.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    dtype = str(q.dtype).split(".")[-1]
    diff = (got.float() - want.float()).abs()
    limit = FLASH_ATOL[dtype] + FLASH_RTOL * want.float().abs()
    if not bool((diff <= limit).all()):
        raise AssertionError(
            f"flash_attention {tuple(q.shape)} {tuple(k.shape)} causal="
            f"{causal} window={window}: max |kernel − plain| = "
            f"{diff.max().item()} beyond atol {FLASH_ATOL[dtype]}, rtol "
            f"{FLASH_RTOL}")
    return diff.max().item()


def flash_variant_ran(fn):
    """Runs ``fn`` and names the flash kernel variant it launched, from
    the per-variant counters (exactly one launch)."""
    from repro_torch.kernels.flash_attn import kernel as KF

    before = dict(KF.LAUNCHES_BY)
    out = fn()
    ran = [k for k, n in KF.LAUNCHES_BY.items() if n != before[k]]
    if len(ran) != 1 or KF.LAUNCHES_BY[ran[0]] != before[ran[0]] + 1:
        raise AssertionError(f"expected one flash launch, counters went "
                             f"from {before} to {KF.LAUNCHES_BY}")
    return out, ran[0]


def flash_rows(rng):
    """The flash kernel at its fixed shapes: the variant that ran, within
    tolerance of the plain version, timed beside it and beside SDPA; then
    the serving call through `ops.flash_attention` on the model's layout."""
    from repro_torch.kernels.flash_attn import kernel as KF, ref as RF

    rows = []
    for B, H, Hkv, Sq, Sk, D, Dv, dtype, causal, window in FLASH_SHAPES:
        q, k, v = flash_input(B, H, Hkv, Sq, Sk, D, Dv, dtype, rng)
        err, ran = flash_variant_ran(
            lambda: flash_error(q, k, v, causal, window))
        if ran != KF.variant(q.dtype):
            raise AssertionError(f"{dtype} flash ran {ran}, not "
                                 f"{KF.variant(q.dtype)}")
        rows.append({
            "kernel": "flash_attention", "shape": [B, H, Hkv, Sq, Sk, D, Dv],
            "dtype": dtype, "causal": causal, "window": window,
            "variant": ran, "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: KF.flash_attention_bhsd(
                q, k, v, causal=causal, window=window), 5),
            "plain_ms": cuda_ms(lambda: RF.attention_ref(
                q, k, v, causal=causal, window=window), 2),
            **library_fields(q, k, v, causal, window),
            **bound_fields(*flash_bound_s(B, H, Hkv, Sq, Sk, D, Dv, dtype,
                                          causal, window))})
    rows.append(flash_ops_row(rng, *FLASH_SHAPES[0]))
    rows.append(flash_ops_row(rng, *MLA_SHAPE))
    return rows


def flash_ops_row(rng, B, H, Hkv, Sq, Sk, D, Dv, dtype, causal, window):
    """One call through `ops.flash_attention` on the model's layout, as
    `gqa_full` and `mla_full` make it: q (b, s, hkv, g, hd) and k (b, s,
    hkv, hd) dense; v (b, s, hkv, vd) dense when vd = hd, else MLA's view
    ``kv[..., 128:]`` of a (b, s, hkv, 128 + vd) expansion. The kernel
    reads them by strides and writes its output in place, so the result
    is dense in the model's layout (no copy); it is held to the plain
    version on the same data made (B, H, S, ·)."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attn import ops as OF, ref as RF

    g = H // Hkv
    dt = getattr(torch, dtype)
    lead = 0 if Dv == D else 128
    q, k, kv = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .to(dt).cuda() for s in ((B, Sq, Hkv, g, D), (B, Sk, Hkv, D),
                                         (B, Sk, Hkv, lead + Dv)))
    v = kv[..., lead:]
    got, ran = flash_variant_ran(
        lambda: OF.flash_attention(q, k, v, causal=causal, window=window))
    if not got.is_contiguous() or got.shape != (B, Sq, Hkv, g, Dv):
        raise AssertionError(f"ops.flash_attention gave {tuple(got.shape)}, "
                             f"strides {got.stride()}: not dense in the "
                             f"model's layout")
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, H, Sq, D).contiguous()
    kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
    want = RF.attention_ref(qh, kh, vh, causal=causal, window=window)
    got = got.permute(0, 2, 3, 1, 4).reshape(B, H, Sq, Dv)
    diff = (got.float() - want.float()).abs()
    if not bool((diff <= FLASH_ATOL[dtype] + FLASH_RTOL
                 * want.float().abs()).all()):
        raise AssertionError(f"ops.flash_attention {tuple(q.shape)}: max "
                             f"|kernel − plain| = {diff.max().item()}")
    return {
        "kernel": "flash_attention", "path": "ops.flash_attention",
        "layout": "model (b, s, hkv, g, hd)" + (
            "" if Dv == D else ", v a view of (b, s, hkv, 128 + vd)"),
        "shape": [B, H, Hkv, Sq, Sk, D, Dv],
        "dtype": dtype, "causal": causal, "window": window, "variant": ran,
        "max_abs_err": diff.max().item(),
        "kernel_ms": cuda_ms(lambda: OF.flash_attention(
            q, k, v, causal=causal, window=window), 10),
        "plain_ms": cuda_ms(lambda: RF.attention_ref(
            qh, kh, vh, causal=causal, window=window), 2),
        **library_fields(qh, kh, vh, causal, window),
        **bound_fields(*flash_bound_s(B, H, Hkv, Sq, Sk, D, Dv, dtype, causal,
                                      window))}


# ---------------------------------------------------------------------- phases
def phase_device():
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible to torch")
    smi = card_line()
    print(smi, flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    rates = card_rates()
    emit("device", t0, **dev, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, rates=rates)
    return dev, smi, rates


def card_line() -> str:
    """Card 0's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def flash_ptxas(ptxas):
    """The flash kernels' ptxas resources, by kernel and instantiated
    width (the bf16 kernel's padded head dim; the f32 kernel's output
    columns a thread, NJ): registers, spill bytes, stack; beside each, the
    dynamic shared memory its launcher asks for at that width (f32: at the
    widest head dim it serves, 16 NJ)."""
    import re

    from repro_torch.kernels import _build

    lib = _build.load_library()
    out, cur = {}, None
    for ln in ptxas:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"flash_attention_(tc_)?kernelILi(\d+)E", m.group(1))
            cur = None
            if k:
                tc = bool(k.group(1))
                width = int(k.group(2))  # the padded head dim, or f32's NJ
                cur = f"{'tc_bf16' if tc else 'cuda_core_f32'}<{width}>"
                out[cur] = {"smem_dynamic_bytes": lib.flash_attention_smem_bytes(
                    width if tc else 16 * width, 1 if tc else 0)}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[cur].update(stack_bytes=int(m.group(1)),
                            spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
            out[cur]["ptxas"] = ln
    return out


SASS_OPS = ("HMMA", "HGMMA", "IMMA", "BMMA", "POPC")


def sass_counts(path, name):
    """Counts of the `SASS_OPS` opcodes (by mnemonic, before any modifier)
    in the SASS of each function of the library at ``path`` whose
    mangled name holds ``name``, by `cuobjdump -sass`."""
    import re

    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            fn = fn if name in fn else None
            if fn:
                counts[fn] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      ln)
        if fn and m and m.group(1) in SASS_OPS:
            counts[fn][m.group(1)] += 1
    return counts


def flash_sass_hmma(path):
    """Tensor-core instructions (HMMA/HGMMA) in the SASS of each flash
    kernel of the built library, by `cuobjdump -sass`. Raises unless every
    bf16 (`tc`) instantiation holds some, and if the f32 kernel does."""
    counts = {f: c["HMMA"] + c["HGMMA"]
              for f, c in sass_counts(path, "flash_attention").items()}
    tc = {f: n for f, n in counts.items() if "flash_attention_tc_kernel" in f}
    f32 = {f: n for f, n in counts.items() if f not in tc}
    if not tc or not all(tc.values()) or any(f32.values()):
        raise AssertionError(f"flash kernels' tensor-core instructions in "
                             f"SASS: {counts}")
    return {"tc_bf16": sorted(tc.values()), "cuda_core_f32": sorted(
        f32.values())}


INTER_KERNELS = ("bitset_intersections_kernel",
                 "pairwise_intersections_kernel")
# the instruction of the shipped intersection design: the tensor cores'
# binary multiply (it beat the CUDA-core POPC tile on the card:
# `popc_bench.py --probe`, PERF.md §6)
INTER_OP = "BMMA"


def ptxas_resources(ptxas, names, arg="vec"):
    """ptxas resources (registers, spill bytes, stack, static shared
    memory) of each entry function whose mangled name holds one of
    ``names``, keyed by that name and, for a template, its arguments
    (``<{arg}N>``, ``<{arg}N,M>``; the intersection kernels' ``vecN`` is
    the copy width in words)."""
    import re

    out, cur = {}, None
    for ln in ptxas:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"(%s)((?:I(?:L[bi]\d+E)+E)?)" % "|".join(names),
                          m.group(1))
            cur = None
            if k:
                targs = re.findall(r"L[bi](\d+)E", k.group(2))
                cur = k.group(1) + (f"<{arg}{','.join(targs)}>" if targs
                                    else "")
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[cur].update(stack_bytes=int(m.group(1)),
                            spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[cur]["smem_static_bytes"] = int(sm.group(1)) if sm else 0
    return out


def inter_build_report(ptxas, path):
    """The two intersection kernels' instantiations (by their copy width,
    ``vec1``/``vec4`` words): ptxas resources (`ptxas_resources`) and SASS
    counts of POPC and the tensor-core opcodes. Raises unless every
    instantiation holds the shipped design's instruction, `INTER_OP`."""
    import re

    out = ptxas_resources(ptxas, INTER_KERNELS)
    for name in INTER_KERNELS:
        for fn, ops in sass_counts(path, name).items():
            k = re.search(r"ILi(\d+)E", fn)
            key = f"{name}<vec{k.group(1) if k else '?'}>"
            out.setdefault(key, {})["sass"] = {
                op: ops[op] for op in ("POPC", "BMMA", "IMMA")}
    missing = [k for k, v in out.items()
               if not v.get("sass", {}).get(INTER_OP)]
    if len(out) != 2 * len(INTER_KERNELS) or missing:
        raise AssertionError(f"intersection kernels without {INTER_OP} in "
                             f"their SASS: {missing or out}")
    return out


# the top-J kernels (G <= 32 by its segment width S = pow2(G), and the
# wide b1 one by its copy width in words) and the interval-count kernels
# (sort-and-search, and the one-probe warp kernel)
RANK_COUNT_KERNELS = ("jaccard_topj_narrow_kernel", "jaccard_topj_wide_kernel",
                      "interval_count_kernel", "interval_probe_kernel")
# the fold kernels (narrow: G <= 32 and W <= 8, by segment width and register
# words; wide, by whether the bitmap is staged in shared memory) and the
# histogram kernel
FOLD_KERNELS = ("bitset_fold_narrow_kernel", "bitset_fold_wide_kernel")
HIST_KERNELS = ("segment_histogram_kernel",)
FOLD_HIST_KERNELS = FOLD_KERNELS + HIST_KERNELS


def fold_hist_report(ptxas):
    """The fold's (narrow by segment width S and register words WM, and
    wide) and the histogram's ptxas resources. Raises unless every one was
    compiled and none has a stack frame or spills (the narrow fold's row
    words must stay in registers)."""
    out = ptxas_resources(ptxas, FOLD_HIST_KERNELS, arg="")
    bad = {k: v for k, v in out.items()
           if v.get("stack_bytes", 1) or v.get("spill_store_bytes", 1)
           or v.get("spill_load_bytes", 1)}
    if bad or not all(any(k.startswith(n) for k in out)
                      for n in FOLD_HIST_KERNELS):
        raise AssertionError(f"fold/histogram kernels with a stack frame, "
                             f"spills or missing: {bad or out}")
    return out


def phase_build():
    """Builds every kernel from the sources; reports the flash, the
    intersection, the top-J, the interval-count, the fold and the
    histogram kernels' ptxas resources and proves from the SASS that the
    bf16 flash kernel runs on the tensor cores and the intersection
    kernels on the shipped design's instruction."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library(rebuild=True)
    info = dict(_build.BUILD_INFO)
    emit("build", t0, **info, flash_ptxas=flash_ptxas(info["ptxas"]),
         flash_sass_hmma=flash_sass_hmma(info["path"]),
         intersections=inter_build_report(info["ptxas"], info["path"]),
         rank_count_ptxas=ptxas_resources(info["ptxas"], RANK_COUNT_KERNELS,
                                          arg=""),
         fold_hist_ptxas=fold_hist_report(info["ptxas"]))


def phase_kernels(rng, rates):
    import torch

    from repro_torch.kernels.bitset_fold import kernel as K3, ref as R3
    from repro_torch.kernels.bitset_jaccard import kernel as K1, ref as R1
    from repro_torch.kernels.seghist import kernel as K2, ref as R2

    t0 = time.perf_counter()
    rows = []
    for B, G, W, valid in INTER_SHAPES:
        x = inter_input(B, G, W, rng)
        got = K1.bitset_intersections(x, valid)
        want = R1.bitset_intersections(x, valid)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            raise AssertionError(f"bitset_intersections {B, G, W, valid}: "
                                 f"max |kernel − plain| = {err}")
        lib = inter_library(x)
        rows.append({
            "kernel": "bitset_intersections", "shape": [B, G, W],
            "valid": valid, "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: K1.bitset_intersections(x, valid), 50),
            "plain_ms": cuda_ms(lambda: R1.bitset_intersections(x, valid), 3),
            "library_ms": cuda_ms(lib, 20),
            **bound_fields(*inter_bound_s(B, G, W, valid, rates))})
    for E, S in HIST_SHAPES:
        ids = hist_input(E, S, rng)
        got = K2.segment_histogram(ids, S)
        want = R2.segment_histogram(ids, S)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            raise AssertionError(f"segment_histogram {E, S}: max |kernel − "
                                 f"plain| = {err}")
        valid_ids = ids[ids >= 0].to(torch.int64)
        bb, bo = hist_bound_s(ids, S, rates)
        rows.append({
            "kernel": "segment_histogram", "shape": [E, S],
            "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: K2.segment_histogram(ids, S), 50),
            "plain_ms": cuda_ms(lambda: R2.segment_histogram(ids, S), 10),
            "library_ms": cuda_ms(
                lambda: torch.bincount(valid_ids, minlength=S), 10),
            "bound_us": max(bb, bo) * 1e6,
            "bound_by": "bytes" if bb >= bo else "operations"})
    for B, G, W, J in TOPJ_SHAPES:
        x, alive = topj_input(B, G, W, rng)
        err = topj_error(x, alive, J)
        rows.append({
            "kernel": "jaccard_topj", "shape": [B, G, W, J],
            "regime": "narrow" if G <= 32 else "wide", "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: K3.jaccard_topj(x, alive, J), 20),
            "plain_ms": cuda_ms(lambda: R3.topj_all(x, alive, J), 2),
            "library_ms": None, **bound_fields(*topj_bound_s(
                B, G, W, J, 1, *topj_work(alive, J).tolist(), rates))})
    for B, G, W, P in FOLD_SHAPES:
        n_valid = B * P - B // 2  # a few padding rows
        x, alive, instr = fold_input(B, G, W, P, n_valid, rng)
        err = fold_error(x, alive, instr)
        _, touched = fold_work(instr, G, W).tolist()
        bb, bo = fold_bound_s(B, G, W, P, 1, n_valid, touched, rates)
        rows.append({
            "kernel": "bitset_fold", "shape": [B, G, W, P],
            "regime": "narrow" if G <= 32 and W <= 8 else "wide",
            "valid_pairs": n_valid, "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: K3.bitset_fold(x, alive, instr), 20),
            "plain_ms": cuda_ms(lambda: R3.fold_pairs(x, alive, instr), 2),
            "library_ms": None, "bound_us": max(bb, bo) * 1e6,
            "bound_by": "bytes" if bb >= bo else "operations"})
    rows += new_kernel_rows(rng, rates)
    rows += flash_rows(rng)
    emit("kernels", t0, results=rows)


def topj_error(x, alive, J):
    """max |kernel − plain| of `jaccard_topj`; raises unless 0."""
    import torch

    from repro_torch.kernels.bitset_fold import kernel as K3, ref as R3

    got = K3.jaccard_topj(x, alive, J)
    want = R3.topj_all(x, alive, J)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise AssertionError(f"jaccard_topj {tuple(x.shape)} J={J}: max "
                             f"|kernel − plain| = {err}")
    return err


def fold_error(x, alive, instr):
    """max |kernel − plain| of `bitset_fold` over bits and alive, each run
    on its own copy; raises unless 0."""
    import torch

    from repro_torch.kernels.bitset_fold import kernel as K3, ref as R3

    kb, ka = x.clone(), alive.clone()
    pb, pa = x.clone(), alive.clone()
    K3.bitset_fold(kb, ka, instr)
    R3.fold_pairs(pb, pa, instr)
    torch.cuda.synchronize()
    err = max(int((kb.to(torch.int64) - pb.to(torch.int64)).abs().max()),
              int((ka.to(torch.int64) - pa.to(torch.int64)).abs().max()))
    if err:
        raise AssertionError(f"bitset_fold {tuple(x.shape)}: max |kernel − "
                             f"plain| = {err}")
    return err


class CallRecorder:
    """Records the shapes (and the histogram's ids, and what top-J and the
    fold need of their data: `topj_work`, `fold_work`, the fold's pairs a
    group) of every kernel call a path makes, by wrapping the names the
    ops modules call. The kernels' own launch counters are untouched by
    it, and it adds no host sync: the work counts stay on the card until
    `close`. ``keep_fold=True`` also keeps a copy of every fold call's
    inputs, as the call is handed them (`fold_inputs`), for replay."""

    def __init__(self, keep_fold=False):
        import torch

        from repro_torch.kernels.bitset_fold import ops as O3
        from repro_torch.kernels.bitset_jaccard import ops as O1
        from repro_torch.kernels.seghist import ops as O2

        self.O1, self.O2, self.O3 = O1, O2, O3
        self.inter = Counter()
        self.hist: list = []
        self.topj = Counter()
        self.topj_work: dict = {}  # (B, G, W, J) -> summed `topj_work`
        self.fold: list = []  # ((B, G, W, P), valid pairs, touched words)
        # per fold call: groups holding k valid pairs, k = 0..P
        self.fold_groups: list = []
        self.fold_inputs: list = []  # (bits, alive, instr), if keep_fold
        self._topj_work: list = []
        self._fold_work: list = []
        self._orig = (O1.bitset_intersections, O2.segment_histogram,
                      O3.jaccard_topj, O3.bitset_fold)

        def inter(bits, valid, _f=self._orig[0]):
            self.inter[(*bits.shape, int(valid))] += 1
            return _f(bits, valid)

        def hist(ids, S, _f=self._orig[1]):
            self.hist.append((ids.clone(), int(S)))
            return _f(ids, S)

        def topj(bits, alive, J, _f=self._orig[2]):
            self.topj[(*bits.shape, int(J))] += 1
            self._topj_work.append(((*bits.shape, int(J)),
                                    topj_work(alive, int(J))))
            return _f(bits, alive, J)

        def fold(bits, alive, instr, _f=self._orig[3]):
            self.fold.append((*bits.shape, int(instr.shape[1])))
            self._fold_work.append(fold_work(instr, *bits.shape[1:]))
            self.fold_groups.append(torch.bincount(
                (instr[..., 6] > 0).sum(dim=1),
                minlength=int(instr.shape[1]) + 1))
            if keep_fold:
                self.fold_inputs.append((bits.clone(), alive.clone(),
                                         instr.clone()))
            return _f(bits, alive, instr)

        O1.bitset_intersections, O2.segment_histogram = inter, hist
        O3.jaccard_topj, O3.bitset_fold = topj, fold

    def close(self):
        import torch

        (self.O1.bitset_intersections, self.O2.segment_histogram,
         self.O3.jaccard_topj, self.O3.bitset_fold) = self._orig
        work = (torch.stack(self._fold_work).tolist()
                if self._fold_work else [])
        self.fold = [(shape, n, t) for shape, (n, t) in zip(self.fold, work)]
        self.fold_groups = [g.tolist() for g in self.fold_groups]
        for shape, w in self._topj_work:
            acc = self.topj_work.setdefault(shape, [0, 0, 0, 0])
            for k, v in enumerate(w.tolist()):
                acc[k] += v


# each hand-written kernel's launch counter: (`repro_torch.kernels.<name>.kernel`,
# attribute)
LAUNCH_COUNTERS = {
    "bitset_intersections": ("bitset_jaccard", "LAUNCHES"),
    "segment_histogram": ("seghist", "LAUNCHES"),
    "jaccard_topj": ("bitset_fold", "TOPJ_LAUNCHES"),
    "bitset_fold": ("bitset_fold", "FOLD_LAUNCHES"),
    "pairwise_intersections": ("bitset_jaccard", "PAIRWISE_LAUNCHES"),
    "interval_count": ("interval_expand", "LAUNCHES"),
    "rowmin_hash": ("minhash", "LAUNCHES"),
    "flash_attention": ("flash_attn", "LAUNCHES"),
}
# the summarizer's kernels, which the graph phases count
SUMMARY_KERNELS = ("bitset_intersections", "segment_histogram",
                   "jaccard_topj", "bitset_fold")


def launch_counter(name: str):
    """(kernel module, attribute) of ``name``'s launch counter."""
    import importlib

    package, attr = LAUNCH_COUNTERS[name]
    return (importlib.import_module(f"repro_torch.kernels.{package}.kernel"),
            attr)


def reset_launches(kernels=SUMMARY_KERNELS):
    for name in kernels:
        setattr(*launch_counter(name), 0)


def read_launches(kernels=SUMMARY_KERNELS):
    return {name: getattr(*launch_counter(name)) for name in kernels}


def phase_main(graph):
    import torch

    import repro_torch
    from repro_torch.core.transfer import GLOBAL as TRANSFER

    t0 = time.perf_counter()
    recorder = CallRecorder()
    torch.cuda.reset_peak_memory_stats()
    TRANSFER.reset()
    reset_launches()
    try:
        engine = repro_torch.SummarizerEngine(backend="batched", T=20,
                                              device="cuda")
        tw = time.perf_counter()
        summary = engine.run(graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
    finally:
        recorder.close()
    launches = read_launches()
    no_degradation(engine, "main batched")
    transfer = TRANSFER.snapshot()
    lossless = summary.validate_lossless(graph)
    if not lossless:
        raise AssertionError("batched summary does not decompress to the "
                             "input graph")
    for name in ("bitset_intersections", "segment_histogram"):
        if launches[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")
    emit("main", t0, graph={"n": graph.n, "m": graph.m}, T=20,
         wall_seconds=wall, lossless=lossless, merges=engine.stats["merges"],
         cost=summary.cost(), relative_size=summary.relative_size(graph),
         launches=launches, transfer=transfer,
         stage_seconds=stage_seconds(engine),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         distinct_intersection_shapes=len(recorder.inter),
         intersection_calls_by_shape=sorted(
             [[*shape, n] for shape, n in Counter(
                 k[:3] for k in recorder.inter.elements()).items()],
             key=lambda r: -r[-1]),
         histogram_calls=[[int(i.numel()), s] for i, s in recorder.hist],
         histogram_call_stats=[hist_call_stats(i, s)
                               for i, s in recorder.hist])
    return summary, launches, recorder, wall


def phase_parity(graph, batched):
    import numpy as np

    from repro_torch.graphs import generators as GG

    t0 = time.perf_counter()
    checks = []

    def timed(g, backend):
        _, s, wall = run_clean(g, backend, f"parity {backend}")
        return s, wall

    def same(a, b, what, walls):
        ok = (np.array_equal(a.parent, b.parent)
              and np.array_equal(a.edges, b.edges))
        checks.append({"case": what, "equal": ok, "wall_seconds": walls})
        if not ok:
            raise AssertionError(f"{what}: batched and numpy summaries differ")

    host, host_wall = timed(graph, "numpy")
    same(batched, host, "caveman(20000, 11, 0.03) T=20",
         {"numpy": host_wall})
    g2 = GG.rmat(14, 8, seed=0)
    b2, b2_wall = timed(g2, "batched")
    h2, h2_wall = timed(g2, "numpy")
    if not b2.validate_lossless(g2):
        raise AssertionError("rmat(14, 8) batched summary is not lossless")
    same(b2, h2, "rmat(14, 8) T=20", {"batched": b2_wall, "numpy": h2_wall})
    emit("parity", t0, checks=checks, rmat={"n": g2.n, "m": g2.m,
                                           "cost": b2.cost()})
    return g2, b2


def same_summary(a, b):
    import numpy as np

    return (np.array_equal(a.parent, b.parent)
            and np.array_equal(a.edges, b.edges))


def phase_resident(graph, batched, rmat, rmat_batched):
    """The resident path on the main graph, counted and recorded like the
    batched main path, then rmat(14, 8) resident against its batched run."""
    import torch

    import repro_torch
    from repro_torch.core.transfer import GLOBAL as TRANSFER

    t0 = time.perf_counter()
    recorder = CallRecorder()
    torch.cuda.reset_peak_memory_stats()
    TRANSFER.reset()
    reset_launches()
    try:
        engine = repro_torch.SummarizerEngine(backend="resident", T=20,
                                              device="cuda")
        tw = time.perf_counter()
        summary = engine.run(graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
    finally:
        recorder.close()
    launches = read_launches()
    no_degradation(engine, "main resident")
    peak = torch.cuda.max_memory_allocated()
    if not summary.validate_lossless(graph):
        raise AssertionError("resident summary does not decompress to the "
                             "input graph")
    if not same_summary(summary, batched):
        raise AssertionError("resident and batched summaries differ on the "
                             "main graph")
    for name in ("jaccard_topj", "bitset_fold"):
        if launches[name] <= 0:
            raise AssertionError(f"the resident path never launched {name}")
    iters = engine.stats["transfer_iters"]
    steady_upload = [d["phases"].get("upload", 0) for d in iters[1:]]
    if any(steady_upload) or engine._run_ctx.bank is None:
        raise AssertionError(f"steady-state upload is not 0 B (bank live: "
                             f"{engine._run_ctx.bank is not None}): "
                             f"{steady_upload}")
    _, r2, r2_wall = run_clean(rmat, "resident", "rmat(14, 8) resident")
    if not same_summary(r2, rmat_batched):
        raise AssertionError("rmat(14, 8): resident and batched summaries "
                             "differ")
    emit("resident", t0, graph={"n": graph.n, "m": graph.m}, T=20,
         wall_seconds=wall, lossless=True, equal_to_batched=True,
         merges=engine.stats["merges"], cost=summary.cost(),
         launches=launches, rounds=engine.stats["transfer"]["rounds"],
         stage_seconds=stage_seconds(engine),
         transfer={k: engine.stats["transfer"][k] for k in (
             "bytes_h2d", "bytes_d2h", "rounds", "phases")},
         transfer_phases_by_iteration=[d["phases"] for d in iters],
         steady_upload_bytes=steady_upload,
         max_memory_allocated=peak,
         topj_calls_by_shape=sorted([[*k, n] for k, n in
                                     recorder.topj.items()],
                                    key=lambda r: -r[-1]),
         fold_calls_by_shape=fold_calls_by_shape(recorder.fold,
                                                 recorder.fold_groups),
         fold_calls=len(recorder.fold),
         fold_valid_pairs=sum(n for _, n, _ in recorder.fold),
         fold_touched_words=sum(t for _, _, t in recorder.fold),
         rmat={"n": rmat.n, "m": rmat.m, "wall_seconds": r2_wall,
               "equal_to_batched": True, "cost": r2.cost()})
    return launches, recorder, dict(stage_seconds(engine), wall=wall)


STAGES = ("shingle", "group", "pack", "merge_round", "exchange", "emit",
          "prune")


def stage_seconds(engine):
    return {k: engine.stats[k] for k in STAGES if k in engine.stats}


def no_degradation(engine, what):
    """Every engine run outside the injected ones: a kernel or the bank
    that failed and fell back would show in ``stats["degradations"]``."""
    from repro_torch import faults

    n = engine.stats["degradations"]
    if n:
        events = faults.DEGRADATIONS.events_since(
            faults.DEGRADATIONS.count() - n)
        raise AssertionError(f"{what}: {n} degradation(s) on a clean run: "
                             f"{events}")


def run_clean(graph, backend, what, **kw):
    """One engine run on the card that must not degrade; returns the
    engine, the summary and the wall (ending in a synchronize)."""
    import torch

    from repro_torch.core.engine import SummarizerEngine

    engine = SummarizerEngine(backend=backend, device="cuda", **kw)
    tw = time.perf_counter()
    summary = engine.run(graph)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    no_degradation(engine, what)
    return engine, summary, wall


def checkpoint_share(engine):
    """Commit seconds over the merge wall (the five stages + commits)."""
    merge = sum(engine.stats[k] for k in STAGES[:5]) + \
        engine.stats["checkpoint"]
    return engine.stats["checkpoint"] / merge if merge else 0.0


def phase_partitioned(graph, batched, res_stages):
    """Slices E1 and E2 on the card: streamed ingestion with spill runs,
    the resident engine on two partitions and two worker threads, a
    batched four-partition run crashed and resumed under resident on one
    partition, and the completed log replayed under batched on four
    partitions (the owner-bucketed emission). Each engine run starts the
    launch counts at 0."""
    import resource
    import shutil
    import tracemalloc

    import torch

    from repro_torch import faults
    from repro_torch.core.engine import SummarizerEngine
    from repro_torch.core.transfer import GLOBAL as TRANSFER
    from repro_torch.graphs import PartitionedGraph
    from repro_torch.graphs import generators as GG

    t0 = time.perf_counter()
    work = ROOT / "build" / "partitioned"
    shutil.rmtree(work, ignore_errors=True)
    spill, ckpt = work / "spill", work / "ckpt"
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    tracemalloc.start()
    tw = time.perf_counter()
    pg = PartitionedGraph.from_edge_stream(
        graph.n, GG.stream_edges(graph, INGEST_CHUNK), n_parts=2,
        spill_dir=str(spill))
    ingest_s = time.perf_counter() - tw
    traced_peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    left = sorted(p.name for p in spill.glob("run-*"))
    if left:
        raise AssertionError(f"ingestion left spill runs behind: {left}")
    if pg._source is not None or pg.to_graph() != graph:
        raise AssertionError("the streamed PartitionedGraph does not "
                             "reassemble to the input graph")
    ingestion = {"chunk_edges": INGEST_CHUNK, "n_parts": pg.n_parts,
                 "seconds": ingest_s, "traced_peak_bytes": traced_peak,
                 "process_max_rss_bytes_before": rss0,
                 "process_max_rss_bytes_after": rss1,
                 "shard_rows": [s.n_local for s in pg.shards],
                 "shard_entries": [s.n_entries for s in pg.shards]}

    TRANSFER.reset()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    engine = SummarizerEngine(backend="resident", partitions=2, workers=2,
                              device="cuda")
    tw = time.perf_counter()
    summary = engine.run(pg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    launches = read_launches()
    no_degradation(engine, "resident partitions=2")
    if not summary.validate_lossless(graph):
        raise AssertionError("resident partitions=2 summary does not "
                             "decompress to the input graph")
    if not same_summary(summary, batched):
        raise AssertionError("resident partitions=2 and batched "
                             "partitions=1 summaries differ")
    for name in ("jaccard_topj", "bitset_fold"):
        if launches[name] <= 0:
            raise AssertionError(f"resident partitions=2 never launched "
                                 f"{name}")
    iters = engine.stats["transfer_iters"]
    steady_upload = [d["phases"].get("upload", 0) for d in iters[1:]]
    if any(steady_upload) or engine._run_ctx.bank is None:
        raise AssertionError(f"partitions=2 steady-state upload is not 0 B: "
                             f"{steady_upload}")
    resident2 = {"wall_seconds": wall, "launches": launches,
                 "stage_seconds": stage_seconds(engine),
                 "partitions_1_stage_seconds": res_stages,
                 "rounds": engine.stats["transfer"]["rounds"],
                 "max_memory_allocated": torch.cuda.max_memory_allocated()}

    reset_launches()
    crashed = SummarizerEngine(backend="batched", partitions=4, workers=4,
                               device="cuda")
    tw = time.perf_counter()
    try:
        # the site is checked after iteration CRASH_AT's merge_round; the
        # commit comes after its exchange, so the resume starts at 10
        with faults.inject("engine.merge_round", iteration=CRASH_AT):
            crashed.run(graph, checkpoint_dir=str(ckpt))
    except faults.InjectedFault:
        pass
    else:
        raise AssertionError("the checkpointed batched run did not crash")
    torch.cuda.synchronize()
    crash_wall = time.perf_counter() - tw
    crash_launches = read_launches()
    if crash_launches["bitset_intersections"] <= 0:
        raise AssertionError("batched partitions=4 never launched "
                             "bitset_intersections")
    reset_launches()
    resumed = SummarizerEngine(backend="resident", partitions=1,
                               device="cuda")
    tw = time.perf_counter()
    out = resumed.run(graph, checkpoint_dir=str(ckpt), resume=True)
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - tw
    resume_launches = read_launches()
    no_degradation(resumed, "the resumed resident run")
    if resumed.stats.get("resumed_from") != CRASH_AT - 1:
        raise AssertionError(f"resumed from "
                             f"{resumed.stats.get('resumed_from')}, not "
                             f"{CRASH_AT - 1}")
    if not same_summary(out, batched):
        raise AssertionError("the resumed summary differs from the "
                             "uninterrupted batched one")
    for name in ("jaccard_topj", "bitset_fold"):
        if resume_launches[name] <= 0:
            raise AssertionError(f"the resumed resident run never launched "
                                 f"{name}")
    reset_launches()
    replayed = SummarizerEngine(backend="batched", partitions=4,
                                device="cuda")
    tw = time.perf_counter()
    out = replayed.run(graph, checkpoint_dir=str(ckpt), resume=True)
    torch.cuda.synchronize()
    replay_wall = time.perf_counter() - tw
    replay_launches = read_launches()
    no_degradation(replayed, "the replayed batched run")
    if replayed.stats.get("resumed_from") != 20:
        raise AssertionError("the completed log did not replay to the end")
    if not same_summary(out, batched):
        raise AssertionError("the owner-bucketed batched emission differs "
                             "from the batched summary")
    if replay_launches["segment_histogram"] <= 0:
        raise AssertionError("the owner-bucketed batched emission never "
                             "launched segment_histogram")
    shutil.rmtree(work, ignore_errors=True)
    emit("partitioned", t0, graph={"n": graph.n, "m": graph.m}, T=20,
         ingestion=ingestion, resident_partitions_2=dict(
             resident2, lossless=True, equal_to_batched=True,
             steady_upload_bytes=steady_upload),
         crash={"backend": "batched", "partitions": 4, "workers": 4,
                "crash_at": CRASH_AT, "wall_seconds": crash_wall,
                "launches": crash_launches,
                "stage_seconds": stage_seconds(crashed),
                "checkpoint_seconds": crashed.stats["checkpoint"],
                "checkpoint_share": checkpoint_share(crashed),
                "merges": crashed.stats["merges"]},
         resume={"backend": "resident", "partitions": 1,
                 "resumed_from": resumed.stats["resumed_from"],
                 "wall_seconds": resume_wall, "launches": resume_launches,
                 "stage_seconds": stage_seconds(resumed),
                 "checkpoint_seconds": resumed.stats["checkpoint"],
                 "checkpoint_share": checkpoint_share(resumed),
                 "merges": resumed.stats["merges"],
                 "equal_to_batched": True},
         replay={"backend": "batched", "partitions": 4,
                 "resumed_from": replayed.stats["resumed_from"],
                 "wall_seconds": replay_wall, "launches": replay_launches,
                 "stage_seconds": stage_seconds(replayed),
                 "equal_to_batched": True})


class DegradationWatch:
    """The launch counts at each degradation the engine logs (a handler on
    the ``repro_torch.engine`` logger, where every fallback warns): what a
    run launched after it is its final counts less these."""

    def __init__(self):
        import logging

        class Handler(logging.Handler):
            def emit(handler, record):
                self.at.append(read_launches())

        self.at = []
        self.handler = Handler(logging.WARNING)
        self.logger = logging.getLogger("repro_torch.engine")
        self.logger.addHandler(self.handler)

    def after(self, launches):
        if len(self.at) != 1:
            raise AssertionError(f"{len(self.at)} degradations logged, not 1")
        return {k: v - self.at[0][k] for k, v in launches.items()}

    def close(self):
        self.logger.removeHandler(self.handler)


def injected_run(graph, backend, want, what, site, **plan):
    """One engine run on the card under ``faults.inject(site, **plan)``:
    equal bit for bit to ``want``, lossless, exactly one degradation.
    Counts start at 0; returns the engine, its wall, its launches and the
    launches after the degradation."""
    import torch

    from repro_torch import faults
    from repro_torch.core.engine import SummarizerEngine
    from repro_torch.core.transfer import GLOBAL as TRANSFER

    TRANSFER.reset()
    reset_launches()
    watch = DegradationWatch()
    try:
        engine = SummarizerEngine(backend=backend, device="cuda")
        tw = time.perf_counter()
        with faults.inject(site, **plan):
            summary = engine.run(graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
        launches = read_launches()
        after = watch.after(launches)
    finally:
        watch.close()
    if engine.stats["degradations"] != 1:
        raise AssertionError(f"{what}: {engine.stats['degradations']} "
                             f"degradations, not 1")
    if not same_summary(summary, want):
        raise AssertionError(f"{what}: the summary differs from the clean "
                             f"run's")
    if not summary.validate_lossless(graph):
        raise AssertionError(f"{what}: the summary is not lossless")
    return engine, wall, launches, after


def write_snap_text(graph, path):
    """``graph`` as gzipped SNAP edge-list text, each edge once (u < v)."""
    import gzip

    import numpy as np

    src = np.repeat(np.arange(graph.n), np.diff(graph.indptr))
    keep = src < graph.indices
    pairs = np.stack([src[keep], graph.indices[keep]], axis=1)
    lines = "\n".join(f"{u}\t{v}" for u, v in pairs.tolist())
    text = (f"# Undirected graph: caveman(20000, 11, 0.03)\n"
            f"# Nodes: {graph.n} Edges: {pairs.shape[0]}\n"
            f"# FromNodeId\tToNodeId\n{lines}\n").encode()
    path.write_bytes(gzip.compress(text, compresslevel=6))
    return len(text), int(pairs.shape[0])


def phase_faults(graph, batched, res_launches):
    """Slices E3 and E4 on the card: a kernel-dispatch, a bank-advance and
    a bank-extract fault in resident runs and a rank-dispatch fault in a
    batched run, each finishing equal to its clean run with exactly one
    degradation and its kernels still launched; the chaos driver's stage
    kills and kernel fault; and the dataset cache over the main graph
    written as SNAP text. The extract and rank-dispatch faults run on
    rmat(12, 8) (parity's rmat(14, 8) takes ≈ 30 s a run on the host's
    sequential sweep of its wide groups). Each engine run starts the
    counts at 0."""
    import shutil

    import torch

    from repro_torch import faults
    from repro_torch.graphs import datasets
    from repro_torch.graphs import generators as GG
    from repro_torch.kernels.bitset_jaccard import ops as jaccard_ops
    from repro_torch.launch import chaos

    t0 = time.perf_counter()
    out = {}

    # 1. resident, a kernel-dispatch fault: the arena retries on the plain
    # versions and keeps them for its life; the other arenas run kernels
    _, wall, launches, after = injected_run(
        graph, "resident", batched, "kernel-dispatch fault",
        "kernel.bitset_fold.round", hit=2)
    for name in ("jaccard_topj", "bitset_fold"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel-dispatch fault: {name} never "
                                 f"launched")
    out["kernel_round"] = {
        "site": "kernel.bitset_fold.round", "hit": 2, "wall_seconds": wall,
        "launches": launches, "launches_after_degradation": after,
        "clean_launches": {k: res_launches[k] for k in
                           ("jaccard_topj", "bitset_fold")},
        "degradations": 1, "equal_to_batched": True, "lossless": True}

    # 2. resident, a bank-advance fault at iteration 1's exchange: the run
    # context goes, later iterations upload host-built workspaces to
    # arenas that keep their kernels
    engine, wall, launches, after = injected_run(
        graph, "resident", batched, "bank-advance fault",
        "resident.bank.advance")
    upload = [d["phases"].get("upload", 0)
              for d in engine.stats["transfer_iters"]]
    if engine._run_ctx is not None:
        raise AssertionError("bank-advance fault: the run context survived")
    for name in ("jaccard_topj", "bitset_fold"):
        if after[name] <= 0:
            raise AssertionError(f"bank-advance fault: {name} never "
                                 f"launched after the degradation")
    if not any(upload[1:]):
        raise AssertionError(f"bank-advance fault: no workspace uploaded "
                             f"after iteration 1: {upload}")
    out["bank_advance"] = {
        "site": "resident.bank.advance", "wall_seconds": wall,
        "launches": launches, "launches_after_degradation": after,
        "upload_bytes_by_iteration": upload,
        "stage_seconds": stage_seconds(engine), "degradations": 1,
        "equal_to_batched": True, "lossless": True}

    # the clean batched run that parts 3 and 4 are held to, its rank
    # dispatches counted for part 4's hit
    rmat = GG.rmat(12, 8, seed=0)
    reset_launches()
    jaccard_ops.DISPATCHES = 0
    _, rmat_batched, clean_wall = run_clean(rmat, "batched",
                                            "rmat(12, 8) batched")
    dispatches = jaccard_ops.DISPATCHES
    clean_launches = read_launches()
    if not rmat_batched.validate_lossless(rmat):
        raise AssertionError("rmat(12, 8) batched summary is not lossless")
    out["rmat_clean"] = {"graph": "rmat(12, 8)", "n": rmat.n, "m": rmat.m,
                         "wall_seconds": clean_wall,
                         "dispatches": dispatches,
                         "launches": clean_launches}

    # 3. resident on rmat(12, 8), a bank-extract fault in iteration 1's
    # merge_round: pack and merge_round rebuild on host workspaces
    engine, wall, launches, after = injected_run(
        rmat, "resident", rmat_batched, "bank-extract fault",
        "resident.bank.extract")
    if engine._run_ctx is not None:
        raise AssertionError("bank-extract fault: the run context survived")
    for name in ("jaccard_topj", "bitset_fold"):
        if after[name] <= 0:
            raise AssertionError(f"bank-extract fault: {name} never "
                                 f"launched after the degradation")
    out["bank_extract"] = {
        "graph": "rmat(12, 8)", "site": "resident.bank.extract",
        "wall_seconds": wall, "launches": launches,
        "launches_after_degradation": after, "degradations": 1,
        "equal_to_batched": True, "lossless": True}

    # 4. batched on rmat(12, 8), a rank-dispatch fault at half the clean
    # run's dispatches: that chunk ranks on the host popcount for the rest
    # of its sweep
    if dispatches < 2:
        raise AssertionError(f"the clean batched run made {dispatches} rank "
                             f"dispatches")
    hit = dispatches // 2
    _, wall, launches, after = injected_run(
        rmat, "batched", rmat_batched, "rank-dispatch fault",
        "kernel.bitset_jaccard.intersections", hit=hit)
    inter = launches["bitset_intersections"]
    if not 0 < inter < clean_launches["bitset_intersections"]:
        raise AssertionError(f"rank-dispatch fault: {inter} intersection "
                             f"launches against the clean run's "
                             f"{clean_launches['bitset_intersections']}")
    out["rank_dispatch"] = {
        "graph": "rmat(12, 8)", "site": "kernel.bitset_jaccard.intersections",
        "hit": hit, "clean_dispatches": dispatches, "wall_seconds": wall,
        "launches": launches,
        "clean_launches": clean_launches,
        "launches_after_degradation": after, "degradations": 1,
        "equal_to_batched": True, "lossless": True}

    # 5. the chaos driver on the card
    tw = time.perf_counter()
    chaos.run_stage_kills()
    kills_wall = time.perf_counter() - tw
    reset_launches()
    tw = time.perf_counter()
    chaos.run_kernel_fault(device="cuda")
    out["chaos"] = {"stage_kills": 5, "stage_kills_seconds": kills_wall,
                    "kernel_fault_seconds": time.perf_counter() - tw,
                    "kernel_fault_launches": read_launches()}

    # 6. the dataset cache over the main graph as SNAP text, served by an
    # opener that reads the local file: nothing fetches
    work = ROOT / "build" / "datasets"
    shutil.rmtree(work, ignore_errors=True)
    cache = work / "cache"
    work.mkdir(parents=True)
    source = work / "source.txt.gz"
    text_bytes, edges = write_snap_text(graph, source)

    def opener(url):
        return open(source, "rb")

    try:
        with faults.inject("datasets.fetch"):
            datasets.fetch("email-Enron", cache=str(cache), opener=opener)
    except faults.InjectedFault:
        pass
    else:
        raise AssertionError("the injected datasets.fetch fault never fired")
    left = sorted(p.name for p in cache.iterdir())
    if left:
        raise AssertionError(f"the failed fetch left files behind: {left}")
    tw = time.perf_counter()
    loaded = datasets.load_remote("email-Enron", cache=str(cache),
                                  opener=opener)
    load_s = time.perf_counter() - tw
    if loaded != graph:
        raise AssertionError("load_remote of the SNAP text differs from the "
                             "graph")
    cached = sorted(p.name for p in cache.iterdir())
    if cached != ["email-Enron.txt.gz", "email-Enron.txt.gz.sha256"]:
        raise AssertionError(f"unexpected cache contents: {cached}")
    out["datasets"] = {"name": "email-Enron", "edges": edges,
                       "text_bytes": text_bytes,
                       "file_bytes": source.stat().st_size,
                       "load_seconds": load_s, "equal_to_graph": True,
                       "fault_left_files": 0}
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    emit("faults", t0, graph={"n": graph.n, "m": graph.m}, T=20, **out)


def fold_calls_by_shape(fold, groups):
    """The recorded fold calls by shape ``[B, G, W, P]``, the most called
    first: calls, valid pairs, groups holding a pair, and
    ``pairs_per_group[k]``, the groups holding k valid pairs (k = 1..P),
    all summed over the shape's calls."""
    by: dict = {}
    for (shape, n_valid, _), per in zip(fold, groups):
        acc = by.setdefault(tuple(shape), {
            "shape": list(shape), "calls": 0, "valid_pairs": 0,
            "groups_with_pairs": 0, "pairs_per_group": [0] * (len(per) - 1)})
        acc["calls"] += 1
        acc["valid_pairs"] += n_valid
        acc["groups_with_pairs"] += sum(per[1:])
        acc["pairs_per_group"] = [a + b for a, b in
                                  zip(acc["pairs_per_group"], per[1:])]
    return sorted(by.values(), key=lambda r: -r["calls"])


def phase_trace(graph, backend, top=8):
    """One more run of a path under `torch.profiler`: the device's busy
    time by kernel, copy and torch op, against the run's wall time.
    Reported, not asserted: the wall of this run includes the profiler's
    own cost."""
    from repro_torch.core.engine import SummarizerEngine

    t0 = time.perf_counter()
    engine = SummarizerEngine(backend=backend, device="cuda")
    wall, by_name = traced(lambda: engine.run(graph))
    no_degradation(engine, f"traced {backend}")
    emit_trace(t0, backend, wall, by_name, top=top)
    return by_name


def kernel_record(recorder, launches, res_recorder, res_launches, rng,
                  device_us, rates):
    """The per-kernel contract line: times summed over each path's calls,
    each distinct call shape checked against the plain version, timed once
    and weighted by its count. ``launches`` are each path's counted run
    (batched: intersections, histogram; resident: top-J, fold).
    ``device_ms`` is the kernel's own device time over the traced rerun of
    its path (None where the profiler saw no device time)."""
    import torch

    from repro_torch.kernels.bitset_fold import kernel as K3, ref as R3
    from repro_torch.kernels.bitset_jaccard import kernel as K1, ref as R1
    from repro_torch.kernels.seghist import kernel as K2, ref as R2

    # comparison launches do not count
    saved = (K1.LAUNCHES, K2.LAUNCHES, K3.TOPJ_LAUNCHES, K3.FOLD_LAUNCHES)
    inter = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bb=0.0, bo=0.0, err=0,
                 unit=None)
    for (B, G, W, valid), n in recorder.inter.items():
        x = inter_input(B, G, W, rng)
        got = K1.bitset_intersections(x, valid)
        want = R1.bitset_intersections(x, valid)
        inter["err"] = max(inter["err"], int(
            (got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        inter["ms"] += n * cuda_ms(lambda: K1.bitset_intersections(x, valid), 10)
        inter["plain_ms"] += n * cuda_ms(
            lambda: R1.bitset_intersections(x, valid), 2)
        inter["library_ms"] += n * cuda_ms(inter_library(x), 5)
        bb, bo, inter["unit"] = inter_bound_s(B, G, W, valid, rates)
        inter["bb"] += n * bb
        inter["bo"] += n * bo
    hist = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bb=0.0, bo=0.0, err=0)
    for ids, S in recorder.hist:
        got = K2.segment_histogram(ids, S)
        want = R2.segment_histogram(ids, S)
        hist["err"] = max(hist["err"], int(
            (got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        valid_ids = ids[ids >= 0].to(torch.int64)
        hist["ms"] += cuda_ms(lambda: K2.segment_histogram(ids, S), 20)
        hist["plain_ms"] += cuda_ms(lambda: R2.segment_histogram(ids, S), 5)
        hist["library_ms"] += cuda_ms(
            lambda: torch.bincount(valid_ids, minlength=S), 5)
        bb, bo = hist_bound_s(ids, S, rates)
        hist["bb"] += bb
        hist["bo"] += bo
    topj = dict(ms=0.0, plain_ms=0.0, library_ms=None, bb=0.0, bo=0.0,
                err=0, unit=None)
    for (B, G, W, J), n in res_recorder.topj.items():
        x, alive = topj_input(B, G, W, rng)
        topj["err"] = max(topj["err"], topj_error(x, alive, J))
        topj["ms"] += n * cuda_ms(lambda: K3.jaccard_topj(x, alive, J), 5)
        topj["plain_ms"] += n * cuda_ms(lambda: R3.topj_all(x, alive, J), 1)
        bb, bo, topj["unit"] = topj_bound_s(B, G, W, J, n, *res_recorder
                                            .topj_work[(B, G, W, J)], rates)
        topj["bb"] += bb
        topj["bo"] += bo
    fold = dict(ms=0.0, plain_ms=0.0, library_ms=None, bb=0.0, bo=0.0,
                err=0)
    by_shape: dict = {}
    for shape, n_valid, touched in res_recorder.fold:
        by_shape.setdefault(shape, []).append(n_valid)
        bb, bo = fold_bound_s(*shape, 1, n_valid, touched, rates)
        fold["bb"] += bb
        fold["bo"] += bo
    for (B, G, W, P), valid in by_shape.items():
        # timed at the shape's mean valid-pair count, weighted by its calls
        x, alive, instr = fold_input(B, G, W, P,
                                     round(sum(valid) / len(valid)), rng)
        fold["err"] = max(fold["err"], fold_error(x, alive, instr))
        fold["ms"] += len(valid) * cuda_ms(
            lambda: K3.bitset_fold(x, alive, instr), 5)
        fold["plain_ms"] += len(valid) * cuda_ms(
            lambda: R3.fold_pairs(x, alive, instr), 1)
    K1.LAUNCHES, K2.LAUNCHES, K3.TOPJ_LAUNCHES, K3.FOLD_LAUNCHES = saved
    for name, acc in (("bitset_intersections", inter),
                      ("segment_histogram", hist)):
        if acc["err"]:
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"the main path's calls by {acc['err']}")
    out = []
    for name, acc, n_launch, src, replaces, names in (
            ("bitset_intersections", inter, launches,
             "src/repro_torch/csrc/bitset_intersections.cu",
             "src/repro/kernels/bitset_jaccard/kernel.py:85",
             ("bitset_intersections_kernel",)),
            ("segment_histogram", hist, launches,
             "src/repro_torch/csrc/segment_histogram.cu",
             "src/repro/kernels/seghist/kernel.py:39", HIST_KERNELS),
            ("jaccard_topj", topj, res_launches,
             "src/repro_torch/csrc/jaccard_topj.cu",
             "src/repro/kernels/bitset_fold/kernel.py:78",
             ("jaccard_topj_narrow_kernel", "jaccard_topj_wide_kernel")),
            ("bitset_fold", fold, res_launches,
             "src/repro_torch/csrc/bitset_fold.cu",
             "src/repro/kernels/bitset_fold/kernel.py:129", FOLD_KERNELS)):
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n_launch[name],
            "max_abs_err": acc["err"], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"],
            "bound_ms": max(acc["bb"], acc["bo"]) * 1e3,
            "bound_by": "bytes" if acc["bb"] >= acc["bo"] else "operations",
            **({"bound_unit": acc["unit"]} if acc.get("unit") else {}),
            "library_ms": acc["library_ms"],
            "device_ms": device_ms(device_us, names)})
    return out


class IntervalRecorder:
    """Keeps a copy of the inputs of every interval-count call the serving
    path makes, by wrapping the name `interval_expand.ops` calls. The
    kernel's own launch counter is untouched by it; the copies are small
    device tiles and need no host sync."""

    def __init__(self):
        from repro_torch.kernels.interval_expand import ops as OI

        self.OI = OI
        self.calls: list = []
        self._orig = OI.interval_counts

        def rec(lo, hi, sign, pos, _f=self._orig):
            self.calls.append(tuple(t.clone() for t in (lo, hi, sign, pos)))
            return _f(lo, hi, sign, pos)

        OI.interval_counts = rec

    def close(self):
        self.OI.interval_counts = self._orig


def answers_agree(graph, queries, by_backend):
    """Every backend's answers equal each other and the input graph's CSR
    (the summary is lossless, so the CSR is the ground truth). Raises on
    the first disagreement; returns the neighbors/edge split."""
    import numpy as np

    kinds = Counter()
    for i, q in enumerate(queries):
        got = {b: a[i] for b, a in by_backend.items()}
        if q[0] == "neighbors":
            v = q[1]
            want = graph.indices[graph.indptr[v]:graph.indptr[v + 1]]
            ok = all(isinstance(a, np.ndarray) and a.dtype == np.int64
                     and np.array_equal(a, want) for a in got.values())
        else:
            want = graph.has_edge(q[1], q[2])
            ok = all(isinstance(a, bool) and a == want for a in got.values())
        if not ok:
            raise AssertionError(f"query {i} {q}: answers {got} differ from "
                                 f"the input graph's {want!r}")
        kinds[q[0]] += 1
    return dict(kinds)


def phase_serve(graph, summary, label):
    """Pack ``summary``, round-trip the `.npz` under `build/`, and drain
    `SERVE_QUERIES` queries through `SummaryQueryServer` on the card with
    the kernel backend (interval-count launches counted from 0), then with
    torch and numpy; all three equal each other and the graph's CSR."""
    import torch

    from repro_torch.core.summary_ir import PackedSummary
    from repro_torch.kernels.interval_expand import kernel as KI
    from repro_torch.launch.summary_serve import (SummaryQueryServer,
                                                  make_queries)

    t0 = time.perf_counter()
    tw = time.perf_counter()
    packed = summary.pack_for_serving()
    (ROOT / "build").mkdir(exist_ok=True)
    path = packed.save(str(ROOT / "build" / f"serve_{label}.npz"))
    ps = PackedSummary.load(path)
    pack_s = time.perf_counter() - tw
    queries = make_queries(graph.n, SERVE_QUERIES, edge_frac=0.25, seed=1)
    torch.cuda.reset_peak_memory_stats()
    answers, walls = {}, {}
    recorder = IntervalRecorder()
    KI.LAUNCHES = 0
    try:
        server = SummaryQueryServer(ps, batch_slots=SERVE_SLOTS,
                                    backend="kernel", device="cuda")
        tw = time.perf_counter()
        answers["kernel"] = server.run(queries)
        torch.cuda.synchronize()
        walls["kernel"] = time.perf_counter() - tw
    finally:
        recorder.close()
    launches = KI.LAUNCHES
    if launches <= 0:
        raise AssertionError(f"serving {label} never launched interval_count")
    for backend in ("torch", "numpy"):
        server = SummaryQueryServer(ps, batch_slots=SERVE_SLOTS,
                                    backend=backend, device="cuda")
        tw = time.perf_counter()
        answers[backend] = server.run(queries)
        torch.cuda.synchronize()
        walls[backend] = time.perf_counter() - tw
    if KI.LAUNCHES != launches:
        raise AssertionError("the torch or numpy backend launched the "
                             "interval kernel")
    kinds = answers_agree(graph, queries, answers)
    shapes = Counter(tuple(c[0].shape) + (c[3].shape[1],)
                     for c in recorder.calls)
    emit("serve", t0, graph=label, n=graph.n, m=graph.m,
         queries=len(queries), kinds=kinds, slots=SERVE_SLOTS,
         artifact_bytes=ps.nbytes(), artifact=str(Path(path).name),
         max_depth=ps.max_depth, pack_save_load_seconds=pack_s,
         wall_seconds=walls,
         queries_per_second={b: len(queries) / w for b, w in walls.items()},
         equal_backends=True, equal_to_csr=True, launches=launches,
         call_shapes=sorted([[*k, n] for k, n in shapes.items()],
                            key=lambda r: -r[-1]),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return ps, queries, recorder.calls, launches


def phase_shingles(graph, rmat):
    """`node_shingles` on the card for ``graph`` (rows of width 128) for
    each of `SHINGLE_SEEDS` against the engine's host
    `node_shingles_u32`; `group_jaccard` on the card over the neighbor sets
    of the `JACCARD_ROWS` highest-degree nodes of ``rmat`` against its
    plain version on the CPU and the host sets. Launches counted from 0."""
    import numpy as np
    import torch

    from repro_torch.core import minhash as CM
    from repro_torch.kernels.bitset_jaccard import kernel as K1, ops as O1
    from repro_torch.kernels.minhash import kernel as KM, ops as OM

    t0 = time.perf_counter()
    rows, owners = OM.pack_adjacency(graph.indptr, graph.indices, 128)
    rows_t = torch.from_numpy(rows.view(np.int32)).cuda()
    owners_t = torch.from_numpy(owners).cuda()
    consts, checks = [], []
    KM.LAUNCHES = 0
    for sub_seed in SHINGLE_SEEDS:
        a, b = (int(c) for c in CM.u32_seed_consts(sub_seed))
        tw = time.perf_counter()
        got = OM.node_shingles(rows_t, owners_t, graph.n, a, b).cpu().numpy()
        card_s = time.perf_counter() - tw
        tw = time.perf_counter()
        want = CM.node_shingles_u32(graph, sub_seed)
        host_s = time.perf_counter() - tw
        if not np.array_equal(got, want):
            raise AssertionError(f"node_shingles on the card differ from the "
                                 f"host's for sub-seed {sub_seed}")
        consts.append((a, b))
        checks.append({"sub_seed": sub_seed, "equal": True,
                       "card_seconds": card_s, "host_seconds": host_s})
    rowmin_launches = KM.LAUNCHES
    if rowmin_launches <= 0:
        raise AssertionError("node_shingles never launched rowmin_hash")
    top = np.argsort(-np.diff(rmat.indptr), kind="stable")[:JACCARD_ROWS]
    sets = [set(map(int, rmat.neighbors(int(u)))) for u in top]
    bits = O1.pack_bitsets(sets, rmat.n)
    K1.PAIRWISE_LAUNCHES = 0
    tw = time.perf_counter()
    jac = O1.group_jaccard(bits, device="cuda")
    card_s = time.perf_counter() - tw
    pairwise_launches = K1.PAIRWISE_LAUNCHES
    if pairwise_launches <= 0:
        raise AssertionError("group_jaccard never launched "
                             "pairwise_intersections")
    tw = time.perf_counter()
    plain = O1.group_jaccard(bits, device="cpu")
    plain_s = time.perf_counter() - tw
    if not np.array_equal(jac, plain):
        raise AssertionError("group_jaccard on the card differs from its "
                             "plain version")
    rng = np.random.default_rng(2)
    pairs = rng.integers(0, len(sets), size=(2000, 2))
    for i, j in pairs:
        inter = len(sets[i] & sets[j])
        union = len(sets[i] | sets[j])
        want = np.float32(inter) / np.float32(union) if union else 0.0
        if jac[i, j] != want:
            raise AssertionError(f"group_jaccard[{i}, {j}] = {jac[i, j]}, "
                                 f"host sets give {want}")
    emit("shingles", t0, rows=list(rows.shape), node_checks=checks,
         rowmin_launches=rowmin_launches, jaccard_shape=list(bits.shape),
         jaccard_card_seconds=card_s, jaccard_plain_cpu_seconds=plain_s,
         jaccard_sampled_pairs=len(pairs), pairwise_launches=pairwise_launches)
    bits_t = torch.from_numpy(bits.view(np.int32)).cuda()
    return {"rows": rows_t, "owners": owners_t, "n": graph.n,
            "consts": consts, "rowmin_launches": rowmin_launches,
            "bits": bits_t, "pairwise_launches": pairwise_launches}


class FlashRecorder:
    """Counts the flash kernel's calls on a path by shape, and keeps a copy
    of the inputs of the first call of each shape, by wrapping the name
    `flash_attn.ops` calls. The kernel's own launch counter is untouched."""

    def __init__(self):
        from repro_torch.kernels.flash_attn import ops as OF

        self.OF = OF
        self.calls = Counter()
        self.inputs: dict = {}
        self._orig = OF.flash_attention_bhsd

        def rec(q, k, v, *, causal=True, window=0, _f=self._orig):
            key = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                   q.shape[3], v.shape[3], str(q.dtype).split(".")[-1],
                   bool(causal), int(window))
            self.calls[key] += 1
            if key not in self.inputs:
                self.inputs[key] = (q.clone(), k.clone(), v.clone())
            return _f(q, k, v, causal=causal, window=window)

        OF.flash_attention_bhsd = rec

    def close(self):
        self.OF.flash_attention_bhsd = self._orig


def rel_l2(a, b):
    """||a − b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def phase_lm_serve():
    """qwen2.5-3b at full width and depth in bf16 on the card, weights from
    `torch.Generator(seed=0)`: 16 prompts of 1,024 tokens drained through
    `BatchServer(batch_slots=8)`, 32 greedy tokens each, flash launches
    counted from 0 (36 layers × 2 prefills). Each prefill and decode step
    ends in a synchronize, as a streaming server's would, so its wall is
    what the user waits. Then, on the same card, checks (a)–(c) of
    `lm_checks`."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attn import kernel as KF
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    if cfg.attn_impl != "pallas_flash":
        raise AssertionError(f"the port's default attn_impl is "
                             f"{cfg.attn_impl!r}, not the flash kernel")
    tw = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - tw
    n_params = sum(t.numel() for t in tensor_leaves(params))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=LM_PROMPT_LEN)
               for _ in range(LM_PROMPTS)]
    server = BatchServer(cfg, params, batch_slots=LM_SLOTS, device="cuda")
    recorder = FlashRecorder()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_launches()
    try:
        d = timed_drain(server, prompts, LM_GEN)
    finally:
        recorder.close()
    outs, prefill_s, decode_s = d["outs"], d["prefill_s"], d["decode_s"]
    first_logits, drain_s = d["first_logits"], d["drain_s"]
    launches = KF.LAUNCHES
    launches_by = dict(KF.LAUNCHES_BY)
    peak = torch.cuda.max_memory_allocated()
    want_launches = cfg.n_layers * (LM_PROMPTS // LM_SLOTS)
    if launches != want_launches:
        raise AssertionError(f"lm_serve launched flash_attention {launches} "
                             f"times, expected {want_launches}")
    if launches_by["tc_bf16"] != launches:
        raise AssertionError(f"lm_serve's flash launches by variant are "
                             f"{launches_by}: not all on the bf16 "
                             f"tensor-core kernel")
    check_answers("lm_serve", outs, LM_GEN, cfg.vocab)
    batch = torch.from_numpy(np.stack(prompts[:LM_SLOTS])).cuda()
    gen = torch.from_numpy(np.stack(outs[:LM_SLOTS])).cuda().long()
    checks = lm_checks(cfg, params, batch, gen, first_logits)
    prompt_tokens = LM_PROMPTS * LM_PROMPT_LEN
    emit("lm_serve", t0, arch=LM_ARCH, layers=cfg.n_layers,
         d_model=cfg.d_model, params=n_params, dtype=cfg.dtype,
         attn_impl=cfg.attn_impl, init_seconds=init_s,
         prompts=LM_PROMPTS, prompt_len=LM_PROMPT_LEN, gen_tokens=LM_GEN,
         slots=LM_SLOTS, drain_seconds=drain_s,
         prefill_tokens_per_s=prompt_tokens / sum(prefill_s),
         ttft_seconds=prefill_s, decode_ms_per_step=1e3 * sum(decode_s)
         / len(decode_s), decode_steps=len(decode_s),
         generated_tokens_per_s=LM_PROMPTS * LM_GEN / drain_s,
         max_memory_allocated=peak, flash_launches=launches,
         flash_launches_by_variant=launches_by,
         flash_calls=[[*k, c] for k, c in recorder.calls.items()],
         checks=checks)
    return {"server": server, "prompts": prompts, "launches": launches,
            "recorder": recorder}


def free_card():
    """Give back to the card what dropped objects held. A `BatchServer`
    keeps a lambda that refers to the server: a reference cycle, which
    only the cycle collector frees, and with it the weights it holds."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def reset_flash_launches():
    from repro_torch.kernels.flash_attn import kernel as KF

    KF.LAUNCHES = 0
    for name in KF.LAUNCHES_BY:
        KF.LAUNCHES_BY[name] = 0


def timed_drain(server, prompts, gen, keep=LM_DECODE_CHECK):
    """``server.run(prompts, gen)`` with each prefill and decode step ending
    in a synchronize, as a streaming server's would, so its wall is what
    the user waits. Returns the answers, the prefill and decode walls, the
    drain's wall and the first batch's logits (its prefill's, then its
    first decode steps', ``keep`` in all)."""
    import dataclasses

    import torch

    api, decode = server.api, server.decode
    prefill_s, decode_s, first_logits = [], [], []

    def timed_prefill(*a, **k):
        tw = time.perf_counter()
        logits, cache = api.prefill(*a, **k)
        torch.argmax(logits[:, -1], dim=-1).cpu()  # the first token, on host
        prefill_s.append(time.perf_counter() - tw)
        if len(prefill_s) == 1:
            first_logits.append(logits[:, -1].clone())
        return logits, cache

    def timed_decode(*a):
        tw = time.perf_counter()
        logits, cache = decode(*a)
        torch.argmax(logits[:, -1], dim=-1).cpu()
        decode_s.append(time.perf_counter() - tw)
        if len(prefill_s) == 1 and len(first_logits) < keep:
            first_logits.append(logits[:, -1].clone())
        return logits, cache

    server.api = dataclasses.replace(api, prefill=timed_prefill)
    server.decode = timed_decode
    try:
        tw = time.perf_counter()
        outs = server.run(prompts, gen_tokens=gen)
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - tw
    finally:
        server.api, server.decode = api, decode
    return {"outs": outs, "prefill_s": prefill_s, "decode_s": decode_s,
            "first_logits": first_logits, "drain_s": drain_s}


def check_answers(what, outs, gen, vocab):
    import numpy as np

    for o in outs:
        if not (isinstance(o, np.ndarray) and o.shape == (gen,)
                and o.dtype == np.int32 and 0 <= o.min()
                and o.max() < vocab):
            raise AssertionError(f"{what} answer {o!r} is not {gen} tokens "
                                 f"in [0, {vocab})")


def prefill_drops(server, prompts, n_layers):
    """Each prefill's dropped (token, k) pairs summed over the layers: the
    ``dropped_pairs`` of the `moe.route` spans under each `serve.prefill`
    of one traced drain of ``prompts`` (one decode step too, whose routing
    stays under `serve.decode`). Raises unless every prefill routed
    ``n_layers`` times."""
    from repro_torch import tracing

    with tracing.recording() as rec:
        server.run(prompts, gen_tokens=2)
    routes = [sum(s.name == "moe.route" for s in g)
              for g in tracing.within(rec.spans, "serve.prefill")]
    if set(routes) != {n_layers}:
        raise AssertionError(f"prefills routed {routes} times, expected "
                             f"{n_layers} each")
    return rec.sums_within("serve.prefill", "moe.route", "dropped_pairs")


class RoutingPin:
    """Pins the MoE routing of one forward to another's: `record` keeps
    each layer's `moe.route` result, `pin` then runs with each layer's
    expert choices, ranks and slots taken from the record (its weights
    renormalised from this run's own probabilities) and counts the
    (token, k) choices that this run would have made otherwise. Top-k is
    a discrete choice: two right computations that differ in the last
    bits pick another expert for a token whose two candidates' weights
    nearly tie, and that moves the logits past any float tolerance, so a
    kernel is held to its twin with the routing pinned, and the flips are
    reported."""

    def __init__(self):
        from repro_torch.models import moe as M

        self.M, self._orig = M, M.route
        self.recorded, self.flips, self._i = [], 0, 0

    @contextlib.contextmanager
    def record(self):
        def rec(p, cfg, x):
            r = self._orig(p, cfg, x)
            self.recorded.append(r)
            return r

        with self._patched(rec):
            yield

    @contextlib.contextmanager
    def pin(self):
        def pinned(p, cfg, x):
            r = self._orig(p, cfg, x)
            want = self.recorded[self._i]
            self._i += 1
            self.flips += int((r.top_e != want.top_e).sum())
            top_p = r.probs.gather(-1, want.top_e)
            top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
            return r._replace(top_p=top_p, top_e=want.top_e, rank=want.rank,
                              slot=want.slot, dropped=want.dropped)

        self._i, self.flips = 0, 0
        with self._patched(pinned):
            yield
        if self._i != len(self.recorded):
            raise AssertionError(f"pinned {self._i} routings of "
                                 f"{len(self.recorded)} recorded")

    @contextlib.contextmanager
    def _patched(self, fn):
        self.M.route = fn
        try:
            yield
        finally:
            self.M.route = self._orig


def pinned_logits(params, cfg, batch):
    """Prefill's last-position logits through the chunked twin and through
    the flash kernel, the flash run's routing pinned to the chunked run's,
    and the flash run's own (free) logits: (chunked, pinned, free, flips
    of the free run against the chunked one)."""
    pin = RoutingPin()
    with pin.record():
        chunked = last_logits(params, cfg, batch, "xla_chunked")
    with pin.pin():
        pinned = last_logits(params, cfg, batch, "pallas_flash")
    free = last_logits(params, cfg, batch, "pallas_flash")
    return chunked, pinned, free, pin.flips


def free_fields(free, chunked, flips):
    """What the flash run gave with its own routing: the choices that
    flipped against the chunked run's, and its logits' distance."""
    return {"free_routing_flips": flips,
            "free_rel_l2": rel_l2(free, chunked),
            "free_max_abs_diff": (free.float() - chunked.float()).abs().max()
            .item()}


def first_layers(params, n):
    """The served weights cut to their first ``n`` layers, cast to f32."""
    def cast(tree, cut):
        if isinstance(tree, dict):
            return {k: cast(v, cut) for k, v in tree.items()}
        return (tree[:n] if cut else tree).float()

    return {k: cast(v, k == "layers") for k, v in params.items()}


def phase_lm_mla_moe():
    """Slices F2 + F3 on the card. (1) deepseek-v2-lite-16b at full width
    and all 27 layers in bf16 (MLA + MoE, 16.2B parameters), weights from
    `torch.Generator(seed=0)`: 16 prompts of 1,024 tokens through
    `BatchServer(batch_slots=8)`, 32 greedy tokens each, at the config's
    capacity factor 1.25; flash launches counted from 0 (27 × 2 prefills,
    all `tc_bf16` at q/k width 192 and v width 128 by the recorded call
    shapes); dropped pairs per prefill. (2) Checks on the same weights:
    (a) prefill logits, flash kernel vs the chunked twin with the flash
    run's routing pinned to the twin's (`RoutingPin`; the free run's
    flips reported), in bf16 at full depth (clear-margin greedy tokens)
    and in f32 on the first 4 layers (atol 2e-4, rtol 1e-3); (c) at
    ``capacity_factor = n_experts`` in f32 on those 4 layers, 8 decode
    steps of one prompt vs a teacher-forced forward; (d)
    `mla_decode_absorbed` vs `mla_decode` on one layer in f32, and the
    served model's decode ms/step under each. (4) One batch (prefill and 8
    decode steps) traced. (3) qwen3-moe-235b-a22b at full width cut to 2
    of its 94 layers: one batch of 8 × 1,024, 8 greedy tokens, 2 flash
    launches at its GQA shape, check (a) in f32 at those 2 layers."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attn import kernel as KF
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(MLA_MOE_ARCH)
    if cfg.attn_impl != "pallas_flash":
        raise AssertionError(f"the port's default attn_impl is "
                             f"{cfg.attn_impl!r}, not the flash kernel")
    free_card()
    tw = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - tw
    n_params = sum(t.numel() for t in tensor_leaves(params))
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tensor_leaves(params))
    torch.cuda.reset_peak_memory_stats()  # the drain's peak, not init's
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=LM_PROMPT_LEN)
               for _ in range(LM_PROMPTS)]
    server = BatchServer(cfg, params, batch_slots=LM_SLOTS, device="cuda")
    recorder = FlashRecorder()
    reset_flash_launches()
    try:
        d = timed_drain(server, prompts, LM_GEN)
    finally:
        recorder.close()
    launches, launches_by = KF.LAUNCHES, dict(KF.LAUNCHES_BY)
    peak = torch.cuda.max_memory_allocated()
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    want_launches = cfg.n_layers * (LM_PROMPTS // LM_SLOTS)
    shapes = {k[5:7] for k in recorder.calls}
    if launches != want_launches or launches_by["tc_bf16"] != launches \
            or shapes != {(qk, m.v_head_dim)}:
        raise AssertionError(
            f"lm_mla_moe launched flash {launches} times ({launches_by}), "
            f"at (D, Dv) {shapes}: expected {want_launches}, all tc_bf16, "
            f"all at ({qk}, {m.v_head_dim})")
    check_answers("lm_mla_moe", d["outs"], LM_GEN, cfg.vocab)
    drops = prefill_drops(server, prompts, cfg.n_layers)
    batch = torch.from_numpy(np.stack(prompts[:LM_SLOTS])).cuda()
    gen = torch.from_numpy(np.stack(d["outs"][:LM_SLOTS])).cuda().long()
    checks = mla_moe_checks(cfg, params, batch, gen, server, prompts)
    tw = time.perf_counter()
    wall, by_name = traced(lambda: server.run(prompts[:LM_SLOTS],
                                              gen_tokens=MLA_MOE_TRACE_GEN),
                           warmup=lambda: server.run(prompts[:1],
                                                     gen_tokens=2))
    emit_trace(tw, "lm-mla-moe", wall, by_name, top=16)
    prompt_tokens = LM_PROMPTS * LM_PROMPT_LEN
    fields = dict( arch=MLA_MOE_ARCH, layers=cfg.n_layers,
         d_model=cfg.d_model, params=n_params, weight_bytes=weight_bytes,
         dtype=cfg.dtype, attn_impl=cfg.attn_impl, init_seconds=init_s,
         capacity_factor=cfg.moe.capacity_factor, prompts=LM_PROMPTS,
         prompt_len=LM_PROMPT_LEN, gen_tokens=LM_GEN, slots=LM_SLOTS,
         drain_seconds=d["drain_s"],
         prefill_tokens_per_s=prompt_tokens / sum(d["prefill_s"]),
         ttft_seconds=d["prefill_s"],
         decode_ms_per_step=1e3 * sum(d["decode_s"]) / len(d["decode_s"]),
         decode_steps=len(d["decode_s"]),
         generated_tokens_per_s=LM_PROMPTS * LM_GEN / d["drain_s"],
         max_memory_allocated=peak,
         dropped_pairs_per_prefill=drops,
         routed_pairs_per_prefill=cfg.n_layers * LM_SLOTS * LM_PROMPT_LEN
         * cfg.moe.top_k,
         flash_launches=launches, flash_launches_by_variant=launches_by,
         flash_calls=[[*k, c] for k, c in recorder.calls.items()],
         checks=checks)
    del server, params, batch, gen, d
    free_card()
    emit("lm_mla_moe", t0, **fields, gqa_moe_cut=gqa_moe_cut())
    return {"launches": launches, "recorder": recorder, "device_us": by_name}


def mla_moe_checks(cfg, params, batch, gen, server, prompts):
    """Checks (a), (c) and (d) of `phase_lm_mla_moe` on the served
    weights. The bf16 gate is greedy-token agreement where the margin is
    clear (the ≈ 2% bf16 floor of a random deep model, `lm_checks`); the
    numerical gates run in f32 on the first 4 layers of the same weights,
    because an f32 copy of all 27 (64.8 GB) does not fit beside them."""
    import dataclasses

    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T

    checks, failed = {}, []
    chunked, flash, free, flips = pinned_logits(params, cfg, batch)
    diff = (flash.float() - chunked.float()).abs().max().item()
    clear, clear_ok, agree = clear_tokens_agree(flash, chunked, diff)
    checks["a_bf16"] = {"rel_l2": rel_l2(flash, chunked),
                        "max_abs_diff": diff, "tokens_clear": clear,
                        "tokens_clear_agree": clear_ok, "tokens_agree": agree,
                        **free_fields(free, chunked, flips)}
    if clear_ok != clear:
        failed.append("a_bf16: a clear greedy token differs")
    del flash, chunked, free
    n = MLA_MOE_F32_LAYERS
    cfg4 = dataclasses.replace(cfg, dtype="float32", n_layers=n)
    p4 = first_layers(params, n)
    chunked4, flash4, free4, flips4 = pinned_logits(p4, cfg4, batch)
    checks["a_f32_4_layers"] = {
        "rel_l2": rel_l2(flash4, chunked4),
        "max_abs_diff": (flash4 - chunked4).abs().max().item(),
        **free_fields(free4, chunked4, flips4)}
    # (c): capacity for every pair, so decode is the forward's row
    full = dataclasses.replace(cfg4, moe=dataclasses.replace(
        cfg4.moe, capacity_factor=float(cfg4.moe.n_experts)))
    steps, rows = LM_DECODE_CHECK, MLA_MOE_C_ROWS
    logits, cache = T.prefill(p4, full, batch[:rows],
                              cache_len=batch.shape[1] + steps)
    stepped = [logits[:, -1]]
    for g in range(steps - 1):
        logits, cache = T.decode_step(p4, full, cache, gen[:rows, g:g + 1],
                                      batch.shape[1] + g)
        stepped.append(logits[:, -1])
    stepped = torch.stack(stepped, dim=1)[..., :cfg.vocab]
    forced = forced_logits(p4, full, batch[:rows], gen[:rows], steps)
    checks["c_f32_4_layers"] = {
        "steps": steps, "rows": rows,
        "capacity_factor": full.moe.capacity_factor,
        "rel_l2": rel_l2(stepped, forced),
        "max_abs_diff": (stepped - forced).abs().max().item()}
    # (d): one layer's decode, absorbed vs expanded, on the filled cache
    p0 = T.layer(p4["layers"], 0)["attn"]
    c0 = T.layer(cache["attn"], 0)
    pos = batch.shape[1] + steps - 2  # the last slot the steps wrote
    x = torch.randn(rows, 1, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    ca = {k: v.clone() for k, v in c0.items()}
    cb = {k: v.clone() for k, v in c0.items()}
    absorbed, _ = A.mla_decode_absorbed(p0, cfg4, x, ca, pos)
    expanded, _ = A.mla_decode(p0, cfg4, x, cb, pos)
    checks["d_f32_layer"] = {
        "rel_l2": rel_l2(absorbed, expanded),
        "max_abs_diff": (absorbed - expanded).abs().max().item(),
        "cache_len": c0["ckv"].shape[1],
        "absorbed_ms": cuda_ms(lambda: A.mla_decode_absorbed(
            p0, cfg4, x, ca, pos), 20),
        "expanded_ms": cuda_ms(lambda: A.mla_decode(p0, cfg4, x, cb, pos),
                               20)}
    for name, got, want in (("a_f32_4_layers", flash4, chunked4),
                            ("c_f32_4_layers", stepped, forced),
                            ("d_f32_layer", absorbed, expanded)):
        if not torch.allclose(got, want, atol=LM_F32_ATOL, rtol=LM_F32_RTOL):
            failed.append(f"{name} beyond atol {LM_F32_ATOL}, rtol "
                          f"{LM_F32_RTOL}")
    del p4, cache, ca, cb
    # (d) on the served model: decode ms/step under each, one batch each
    ms = {}
    for mode in (False, True):
        object.__setattr__(cfg, "_absorbed_mla", mode)
        try:
            d = timed_drain(server, prompts[:LM_SLOTS], LM_DECODE_CHECK + 1)
        finally:
            object.__setattr__(cfg, "_absorbed_mla", False)
        ms["absorbed" if mode else "expanded"] = d
    checks["d_bf16_served"] = {
        f"{k}_decode_ms_per_step": 1e3 * sum(v["decode_s"])
        / len(v["decode_s"]) for k, v in ms.items()}
    checks["d_bf16_served"]["tokens_agree"] = int(sum(
        (a == b).sum() for a, b in zip(ms["absorbed"]["outs"],
                                       ms["expanded"]["outs"])))
    if failed:
        raise AssertionError(f"lm_mla_moe checks failed: {failed}; {checks}")
    return checks


def gqa_moe_cut():
    """qwen3-moe-235b-a22b at full width, cut to 2 of its 94 layers (470
    GB in bf16 does not fit; 2 layers are 12.4 GB): one batch of 8
    prompts of 1,024 tokens, 8 greedy tokens, 2 flash launches at its GQA
    shape; check (a) in f32 at those 2 layers."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attn import kernel as KF
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(GQA_MOE_ARCH),
                              n_layers=GQA_MOE_LAYERS)
    held = torch.cuda.memory_allocated()  # what deepseek's part left behind
    tw = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - tw
    n_params = sum(t.numel() for t in tensor_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=LM_PROMPT_LEN)
               for _ in range(LM_SLOTS)]
    server = BatchServer(cfg, params, batch_slots=LM_SLOTS, device="cuda")
    recorder = FlashRecorder()
    reset_flash_launches()
    try:
        d = timed_drain(server, prompts, GQA_MOE_GEN)
    finally:
        recorder.close()
    launches, launches_by = KF.LAUNCHES, dict(KF.LAUNCHES_BY)
    if launches != cfg.n_layers or launches_by["tc_bf16"] != launches:
        raise AssertionError(f"qwen3-moe cut launched flash {launches} "
                             f"times ({launches_by}), expected "
                             f"{cfg.n_layers} on tc_bf16")
    check_answers("qwen3-moe cut", d["outs"], GQA_MOE_GEN, cfg.vocab)
    peak = torch.cuda.max_memory_allocated()
    drops = prefill_drops(server, prompts, cfg.n_layers)
    batch = torch.from_numpy(np.stack(prompts)).cuda()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    del server
    p32 = f32_tree_(params)  # leaf by leaf: the bf16 copy goes as it casts
    del params
    chunked, flash, free, flips = pinned_logits(p32, cfg32, batch)
    check = {"rel_l2": rel_l2(flash, chunked),
             "max_abs_diff": (flash - chunked).abs().max().item(),
             **free_fields(free, chunked, flips)}
    del p32
    free_card()
    if not torch.allclose(flash, chunked, atol=LM_F32_ATOL, rtol=LM_F32_RTOL):
        raise AssertionError(f"qwen3-moe cut check a_f32 beyond atol "
                             f"{LM_F32_ATOL}, rtol {LM_F32_RTOL}: {check}")
    return {"arch": GQA_MOE_ARCH, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": n_params,
            "allocated_before_init": held, "init_seconds": init_s,
            "prompts": LM_SLOTS,
            "prompt_len": LM_PROMPT_LEN, "gen_tokens": GQA_MOE_GEN,
            "prefill_seconds": d["prefill_s"],
            "decode_ms_per_step": 1e3 * sum(d["decode_s"])
            / len(d["decode_s"]),
            "max_memory_allocated": peak,
            "dropped_pairs_per_prefill": drops,
            "flash_launches": launches,
            "flash_calls": [[*k, c] for k, c in recorder.calls.items()],
            "a_f32": check}


def serving_fields(d, prompts, prompt_len, gen):
    """The serving metrics of a timed drain (`timed_drain`'s dict)."""
    return {"prompts": prompts, "prompt_len": prompt_len, "gen_tokens": gen,
            "slots": LM_SLOTS, "drain_seconds": d["drain_s"],
            "prefill_tokens_per_s": prompts * prompt_len
            / sum(d["prefill_s"]),
            "ttft_seconds": d["prefill_s"],
            "decode_ms_per_step": 1e3 * sum(d["decode_s"])
            / len(d["decode_s"]),
            "decode_steps": len(d["decode_s"]),
            "generated_tokens_per_s": prompts * gen / d["drain_s"]}


def flash_gate(what, recorder, want):
    """Raises unless the counted run launched flash exactly as ``want``
    (a `Counter` of recorded call shapes), every launch on `tc_bf16`.
    Returns (launches, launches by variant)."""
    from repro_torch.kernels.flash_attn import kernel as KF

    launches, by = KF.LAUNCHES, dict(KF.LAUNCHES_BY)
    if launches != sum(want.values()) or by["tc_bf16"] != launches \
            or recorder.calls != want:
        raise AssertionError(
            f"{what} launched flash {launches} times ({by}) at "
            f"{dict(recorder.calls)}: expected {dict(want)}, all tc_bf16")
    return launches, by


def gate_close(what, got, want, atol, rtol, failed):
    """Appends to ``failed`` unless |got − want| <= atol + rtol·|want|."""
    import torch

    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        failed.append(f"{what} beyond atol {atol}, rtol {rtol}")


def phase_lm_ssm_encdec():
    """Slices F4 + F5 on the card, each model at full width and depth in
    bf16, weights from `torch.Generator(seed=0)`, freed before the next:
    (1) mamba2-130m and (2) zamba2-7b through `BatchServer(batch_slots=8)`
    (16 prompts of 1,024 tokens, 32 greedy tokens each; flash launches
    counted from 0: none for mamba2, 14 shared-block applications × 2
    prefills at head dim 112 for zamba2) with `ssm_checks`, and zamba2's
    trace (one batch, prefill and 8 steps; the SSD scan's device span in a
    prefill by CUDA events; one decode step's launches); (3)
    whisper-small's 16 clips of 1,500 frame embeddings and 64-token
    prompts through `api.prefill` and `api.decode_step` (`encdec_model`).
    Returns the flash drains for `flash_record`."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_card()
    fields, drains = {}, []
    for arch in (SSM_ARCH, HYBRID_ARCH):
        fields[arch], drain = ssm_model(arch)
        drains.append(drain)
        free_card()
    fields[ENCDEC_ARCH], drain = encdec_model()
    drains.append(drain)
    free_card()
    emit("lm_ssm_encdec", t0, **fields)
    return drains


def ssm_model(arch):
    """One SSM or hybrid model served and checked (`phase_lm_ssm_encdec`):
    its fields and its flash drain."""
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    tw = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - tw
    leaves = list(tensor_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, size=LM_PROMPT_LEN)
               for _ in range(LM_PROMPTS)]
    server = BatchServer(cfg, params, batch_slots=LM_SLOTS, device="cuda")
    recorder = FlashRecorder()
    reset_flash_launches()
    try:
        d = timed_drain(server, prompts, LM_GEN)
    finally:
        recorder.close()
    peak = torch.cuda.max_memory_allocated()
    n_attn = len(T._hybrid_groups(cfg)) if cfg.attn_every else 0
    hd = cfg.resolved_head_dim
    want = Counter({(LM_SLOTS, cfg.n_heads, cfg.n_kv_heads, LM_PROMPT_LEN,
                     LM_PROMPT_LEN, hd, hd, "bfloat16", True, 0):
                    n_attn * (LM_PROMPTS // LM_SLOTS)} if n_attn else {})
    launches, by = flash_gate(arch, recorder, want)
    check_answers(arch, d["outs"], LM_GEN, cfg.vocab)
    batch = torch.from_numpy(np.stack(prompts[:LM_SLOTS])).cuda()
    gen = torch.from_numpy(np.stack(d["outs"][:LM_SLOTS])).cuda().long()
    checks = ssm_checks(cfg, params, batch, gen, d["first_logits"])
    out = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "shared_attn_applications": n_attn,
           "params": sum(t.numel() for t in leaves),
           "weight_bytes": sum(t.numel() * t.element_size() for t in leaves),
           "dtype": cfg.dtype, "init_seconds": init_s,
           **serving_fields(d, LM_PROMPTS, LM_PROMPT_LEN, LM_GEN),
           "max_memory_allocated": peak, "flash_launches": launches,
           "flash_launches_by_variant": by,
           "flash_calls": [[*k, c] for k, c in recorder.calls.items()],
           "checks": checks}
    device_us = {}
    if cfg.attn_every:
        out["trace"], device_us = hybrid_trace(cfg, params, server, prompts,
                                               batch)
    del server, params, leaves, batch, gen, d
    return out, {"launches": launches, "recorder": recorder,
                 "device_us": device_us}


def ssm_checks(cfg, params, batch, gen, stepped):
    """Checks of an SSM or hybrid model on its served weights: (a) in a
    hybrid, prefill's last logits with the flash kernel against the
    chunked twin, in bf16 at full depth (greedy tokens agree where the
    margin is clear; relative L2 printed) and in f32 on the first
    `HYBRID_F32_LAYERS` layers (two groups, the shared block applied
    after each; atol 2e-4, rtol 1e-3); (c) the drain's
    first decode steps against a teacher-forced forward in bf16 (clear
    tokens), and in f32 8 steps of one prompt replayed along the drain's
    tokens, at the reference's tolerance for these families (atol 5e-2,
    `tests/test_serving.py`), its max |Δ| printed."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as T

    checks, failed = {}, []
    n = len(stepped)
    stepped = torch.stack(stepped, dim=1)[..., :cfg.vocab]
    forced = forced_logits(params, cfg, batch, gen, n)
    cdiff = (stepped.float() - forced.float()).abs().max().item()
    c_clear, c_ok, c_agree = clear_tokens_agree(stepped, forced, cdiff)
    checks["c_bf16"] = {"steps": n, "rel_l2": rel_l2(stepped, forced),
                        "max_abs_diff": cdiff, "tokens_clear": c_clear,
                        "tokens_clear_agree": c_ok, "tokens_agree": c_agree}
    if c_ok != c_clear:
        failed.append("c_bf16: a clear greedy token differs")
    if cfg.attn_every:
        flash = last_logits(params, cfg, batch, "pallas_flash")
        chunked = last_logits(params, cfg, batch, "xla_chunked")
        diff = (flash.float() - chunked.float()).abs().max().item()
        clear, clear_ok, agree = clear_tokens_agree(flash, chunked, diff)
        checks["a_bf16"] = {"rel_l2": rel_l2(flash, chunked),
                            "max_abs_diff": diff, "tokens_clear": clear,
                            "tokens_clear_agree": clear_ok,
                            "tokens_agree": agree}
        if clear_ok != clear:
            failed.append("a_bf16: a clear greedy token differs")
        del flash, chunked
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if cfg.attn_every:
        cut = dataclasses.replace(cfg32, n_layers=HYBRID_F32_LAYERS)
        pc = first_layers(params, cut.n_layers)
        flash32 = last_logits(pc, cut, batch, "pallas_flash")
        chunked32 = last_logits(pc, cut, batch, "xla_chunked")
        checks["a_f32"] = {"layers": cut.n_layers,
                           "rel_l2": rel_l2(flash32, chunked32),
                           "max_abs_diff": (flash32 - chunked32).abs().max()
                           .item()}
        gate_close("a_f32", flash32, chunked32, LM_F32_ATOL, LM_F32_RTOL,
                   failed)
        del pc, flash32, chunked32
    p32 = f32_tree(params)
    rows, steps = 1, LM_DECODE_CHECK
    logits, cache = T.prefill(p32, cfg32, batch[:rows],
                              cache_len=batch.shape[1] + steps)
    steps32 = [logits[:, -1]]
    for g in range(steps - 1):
        logits, cache = T.decode_step(p32, cfg32, cache, gen[:rows, g:g + 1],
                                      batch.shape[1] + g)
        steps32.append(logits[:, -1])
    steps32 = torch.stack(steps32, dim=1)[..., :cfg.vocab]
    forced32 = forced_logits(p32, cfg32, batch[:rows], gen[:rows], steps)
    checks["c_f32"] = {"steps": steps, "rows": rows,
                       "rel_l2": rel_l2(steps32, forced32),
                       "max_abs_diff": (steps32 - forced32).abs().max()
                       .item(), "atol": SSM_DECODE_ATOL}
    gate_close("c_f32", steps32, forced32, SSM_DECODE_ATOL, 0.0, failed)
    del p32, cache
    if failed:
        raise AssertionError(f"{cfg.name} checks failed: {failed}; {checks}")
    return checks


def hybrid_trace(cfg, params, server, prompts, batch):
    """One batch (prefill and 8 decode steps) under the profiler: the
    device's busy share and its top ops; the SSD scan's device span in
    one prefill (its `ssm.scan` spans, `tracing`) beside that prefill's wall;
    one decode step traced alone for its launches."""
    import torch

    from repro_torch import tracing
    from repro_torch.models import transformer as T

    tw = time.perf_counter()
    wall, by_name = traced(lambda: server.run(prompts[:LM_SLOTS],
                                              gen_tokens=HYBRID_TRACE_GEN),
                           warmup=lambda: server.run(prompts[:1],
                                                     gen_tokens=2))
    emit_trace(tw, "lm-hybrid", wall, by_name, top=16)
    with tracing.recording() as rec:
        tw = time.perf_counter()
        _, cache = T.prefill(params, cfg, batch,
                             cache_len=batch.shape[1] + 1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - tw
    scan_calls, _, scan_s, _ = rec.table()["ssm.scan"]
    scan_ms = scan_s * 1e3
    tok = batch[:, -1:]
    step_wall, step_by = traced(lambda: T.decode_step(
        params, cfg, cache, tok, batch.shape[1]), warmup=True)
    busy_us = sum(v["device_us"] for v in by_name.values())
    step_busy_us = sum(v["device_us"] for v in step_by.values())
    fields = {"wall_seconds": wall, "device_busy_share": busy_us * 1e-6
              / wall, "prefill_seconds": prefill_s, "ssd_scan_ms": scan_ms,
              "ssd_scan_share_of_prefill": scan_ms * 1e-3 / prefill_s,
              "ssd_scan_calls": scan_calls,
              "decode_step_seconds": step_wall,
              "decode_step_launches": sum(v["count"]
                                          for v in step_by.values()),
              "decode_step_device_busy_share": step_busy_us * 1e-6
              / step_wall}
    return fields, by_name


def api_drain(params, cfg, extra, prompts, gen, offset=0,
              keep=LM_DECODE_CHECK):
    """`BatchServer.run`'s loop for a model whose batches carry more than
    tokens (``extra``: whisper's ``"frames"``, a VLM's ``"embeds"``, one
    row a prompt): each batch of `LM_SLOTS` one `api.prefill` (a cache of
    ``offset`` + prompt + ``gen`` slots, ``offset`` the positions before
    the prompt: a VLM's patches) and ``gen − 1`` greedy
    `api.decode_step`s from position ``offset`` + prompt, each ending in
    a synchronize. Returns `timed_drain`'s dict."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import mask_pad_logits
    from repro_torch.models.api import get_api

    api = get_api(cfg)
    prefill_s, decode_s, first_logits, outs = [], [], [], []
    tw = time.perf_counter()
    for c0 in range(0, len(prompts), LM_SLOTS):
        toks = torch.from_numpy(np.stack(prompts[c0:c0 + LM_SLOTS])).cuda()
        plen = offset + toks.shape[1]
        ts = time.perf_counter()
        batch = {k: v[c0:c0 + LM_SLOTS] for k, v in extra.items()}
        logits, cache = api.prefill(params, cfg, {**batch, "tokens": toks},
                                    cache_len=plen + gen)
        cur = torch.argmax(mask_pad_logits(cfg, logits[:, -1]),
                           dim=-1)[:, None]
        cur.cpu()
        prefill_s.append(time.perf_counter() - ts)
        if c0 == 0:
            first_logits.append(logits[:, -1].clone())
        seq = [cur]
        for g in range(gen - 1):
            ts = time.perf_counter()
            logits, cache = api.decode_step(params, cfg, cache, cur, plen + g)
            cur = torch.argmax(mask_pad_logits(cfg, logits[:, -1]),
                               dim=-1)[:, None]
            cur.cpu()
            decode_s.append(time.perf_counter() - ts)
            if c0 == 0 and len(first_logits) < keep:
                first_logits.append(logits[:, -1].clone())
            seq.append(cur)
        outs += list(torch.cat(seq, dim=1).to(torch.int32).cpu().numpy())
    torch.cuda.synchronize()
    return {"outs": outs, "prefill_s": prefill_s, "decode_s": decode_s,
            "first_logits": first_logits,
            "drain_s": time.perf_counter() - tw}


def encdec_model():
    """whisper-small served (`api_drain`: 16 clips of 1,500 frame
    embeddings drawn N(0, 1) from the seeded generator, 64-token prompts,
    32 greedy tokens, batches of 8), its flash launches gated by call
    shape, and `encdec_checks`. Returns its fields and its flash drain."""
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec as E

    cfg = get_config(ENCDEC_ARCH)
    tw = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = E.init_params(cfg, gen, device="cuda")
    frames = torch.randn((LM_PROMPTS, ENC_LEN, cfg.d_model), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - tw
    leaves = list(tensor_leaves(params))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=ENC_PROMPT_LEN)
               for _ in range(LM_PROMPTS)]
    torch.cuda.reset_peak_memory_stats()
    recorder = FlashRecorder()
    reset_flash_launches()
    try:
        d = api_drain(params, cfg, {"frames": frames}, prompts, LM_GEN)
    finally:
        recorder.close()
    peak = torch.cuda.max_memory_allocated()
    h, hd, L = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
    batches = LM_PROMPTS // LM_SLOTS

    def call(sq, sk, causal, hkv=cfg.n_kv_heads):  # cross: n_heads wide
        return (LM_SLOTS, h, hkv, sq, sk, hd, hd, "bfloat16", causal, 0)

    want = Counter({call(ENC_LEN, ENC_LEN, False):
                    cfg.encoder_layers * batches,
                    call(ENC_PROMPT_LEN, ENC_PROMPT_LEN, True): L * batches,
                    call(ENC_PROMPT_LEN, ENC_LEN, False, h): L * batches,
                    call(1, ENC_LEN, False, h): L * (LM_GEN - 1) * batches})
    launches, by = flash_gate(ENCDEC_ARCH, recorder, want)
    check_answers(ENCDEC_ARCH, d["outs"], LM_GEN, cfg.vocab)
    batch = torch.from_numpy(np.stack(prompts[:LM_SLOTS])).cuda()
    gen_toks = torch.from_numpy(np.stack(d["outs"][:LM_SLOTS])).cuda().long()
    checks = encdec_checks(cfg, params, frames[:LM_SLOTS], batch, gen_toks,
                           d["first_logits"])
    out = {"layers": L, "encoder_layers": cfg.encoder_layers,
           "d_model": cfg.d_model, "params": sum(t.numel() for t in leaves),
           "weight_bytes": sum(t.numel() * t.element_size() for t in leaves),
           "dtype": cfg.dtype, "init_seconds": init_s,
           "enc_len": ENC_LEN, "frames_per_s": LM_PROMPTS * ENC_LEN
           / sum(d["prefill_s"]),
           **serving_fields(d, LM_PROMPTS, ENC_PROMPT_LEN, LM_GEN),
           "max_memory_allocated": peak, "flash_launches": launches,
           "flash_launches_by_variant": by,
           "flash_calls": [[*k, c] for k, c in recorder.calls.items()],
           "checks": checks}
    del params, leaves, frames, batch, gen_toks, d
    return out, {"launches": launches, "recorder": recorder,
                 "device_us": {}}


def encdec_checks(cfg, params, frames, batch, gen, stepped):
    """whisper's checks on its served weights: (a) the encoder's output
    and prefill's last logits with the flash kernel against the chunked
    twin, in bf16 (relative L2 printed; clear greedy tokens agree) and in
    f32 at full depth (the same weights cast; atol 2e-4, rtol 1e-3); (c)
    8 decode steps replayed along the drain's tokens in f32 against a
    teacher-forced `encdec.forward` (atol 2e-4, rtol 1e-3), and the
    drain's own bf16 steps against it (clear tokens)."""
    import dataclasses

    import torch

    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T

    def run(p, c, impl):
        c = dataclasses.replace(c, attn_impl=impl)
        enc = E.encode(p, c, frames)
        return enc, E.prefill(p, c, frames, batch)[0][:, -1, :c.vocab]

    def forced(p, c, n):
        seq = torch.cat([batch, gen[:, :n - 1]], dim=1)
        hidden = E.forward(p, c, frames, seq, return_hidden=True)[0]
        return T._logits(p, c, hidden[:, batch.shape[1] - 1:])[..., :c.vocab]

    checks, failed = {}, []
    enc_f, flash = run(params, cfg, "pallas_flash")
    enc_c, chunked = run(params, cfg, "xla_chunked")
    diff = (flash.float() - chunked.float()).abs().max().item()
    clear, clear_ok, agree = clear_tokens_agree(flash, chunked, diff)
    checks["a_bf16"] = {"encoder_rel_l2": rel_l2(enc_f, enc_c),
                        "rel_l2": rel_l2(flash, chunked),
                        "max_abs_diff": diff, "tokens_clear": clear,
                        "tokens_clear_agree": clear_ok, "tokens_agree": agree}
    if clear_ok != clear:
        failed.append("a_bf16: a clear greedy token differs")
    n = len(stepped)
    stepped = torch.stack(stepped, dim=1)[..., :cfg.vocab]
    want = forced(params, cfg, n)
    cdiff = (stepped.float() - want.float()).abs().max().item()
    c_clear, c_ok, c_agree = clear_tokens_agree(stepped, want, cdiff)
    checks["c_bf16"] = {"steps": n, "rel_l2": rel_l2(stepped, want),
                        "max_abs_diff": cdiff, "tokens_clear": c_clear,
                        "tokens_clear_agree": c_ok, "tokens_agree": c_agree}
    if c_ok != c_clear:
        failed.append("c_bf16: a clear greedy token differs")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = f32_tree(params)
    enc32_f, flash32 = run(p32, cfg32, "pallas_flash")
    enc32_c, chunked32 = run(p32, cfg32, "xla_chunked")
    checks["a_f32"] = {"encoder_max_abs_diff": (enc32_f - enc32_c).abs()
                       .max().item(),
                       "rel_l2": rel_l2(flash32, chunked32),
                       "max_abs_diff": (flash32 - chunked32).abs().max()
                       .item()}
    gate_close("a_f32 encoder", enc32_f, enc32_c, LM_F32_ATOL, LM_F32_RTOL,
               failed)
    gate_close("a_f32 logits", flash32, chunked32, LM_F32_ATOL, LM_F32_RTOL,
               failed)
    logits, cache = E.prefill(p32, cfg32, frames, batch,
                              cache_len=batch.shape[1] + n)
    steps32 = [logits[:, -1]]
    for g in range(n - 1):
        logits, cache = E.decode_step(p32, cfg32, cache, gen[:, g:g + 1],
                                      batch.shape[1] + g)
        steps32.append(logits[:, -1])
    steps32 = torch.stack(steps32, dim=1)[..., :cfg.vocab]
    forced32 = forced(p32, cfg32, n)
    checks["c_f32"] = {"steps": n, "rel_l2": rel_l2(steps32, forced32),
                       "max_abs_diff": (steps32 - forced32).abs().max()
                       .item()}
    gate_close("c_f32", steps32, forced32, LM_F32_ATOL, LM_F32_RTOL, failed)
    del p32, cache
    if failed:
        raise AssertionError(f"{cfg.name} checks failed: {failed}; {checks}")
    return checks


def phase_lm_vlm():
    """Slice F6 on the card: internvl2-26b at full width and all 48 layers
    in bf16 (19,860,664,320 parameters by `param_count`), weights from
    `torch.Generator(seed=0)`: 16 requests, each `make_batch`'s 1,024
    patch embeddings and 1,024 text tokens (S 2,048), in batches of 8
    through `api.prefill` and `api.decode_step` (`api_drain`: a cache of
    patches + text + 32 generated slots, decode from position 2,048), 32
    greedy tokens each; flash launches counted from 0 (48 layers × 2
    prefills, all `tc_bf16` at (8, 48, 8, 2048, 2048), D 128); then
    `vlm_checks`. Returns its flash drain for `flash_record`."""
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_card()
    cfg = get_config(VLM_ARCH)
    tw = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - tw
    leaves = list(tensor_leaves(params))
    tw = time.perf_counter()
    batch = make_batch(cfg, TokenStream(cfg.vocab, LM_PROMPTS, LM_PROMPT_LEN),
                       0, device="cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - tw
    embeds = batch.pop("embeds")
    prompts = list(batch.pop("tokens")[:, :LM_PROMPT_LEN].cpu().numpy())
    torch.cuda.reset_peak_memory_stats()
    recorder = FlashRecorder()
    reset_flash_launches()
    try:
        d = api_drain(params, cfg, {"embeds": embeds}, prompts, LM_GEN,
                      offset=cfg.n_patches)
    finally:
        recorder.close()
    peak = torch.cuda.max_memory_allocated()
    S, hd = cfg.n_patches + LM_PROMPT_LEN, cfg.resolved_head_dim
    want = Counter({(LM_SLOTS, cfg.n_heads, cfg.n_kv_heads, S, S, hd, hd,
                     "bfloat16", True, 0):
                    cfg.n_layers * (LM_PROMPTS // LM_SLOTS)})
    launches, by = flash_gate(VLM_ARCH, recorder, want)
    check_answers(VLM_ARCH, d["outs"], LM_GEN, cfg.vocab)
    toks = torch.from_numpy(np.stack(prompts[:LM_SLOTS])).cuda()
    gen = torch.from_numpy(np.stack(d["outs"][:LM_SLOTS])).cuda().long()
    checks = vlm_checks(cfg, params, embeds[:LM_SLOTS], toks, gen,
                        d["first_logits"])
    fields = {"arch": VLM_ARCH, "layers": cfg.n_layers,
              "d_model": cfg.d_model, "n_patches": cfg.n_patches,
              "text_len": LM_PROMPT_LEN,
              "params": sum(t.numel() for t in leaves),
              "param_count": cfg.param_count(),
              "weight_bytes": sum(t.numel() * t.element_size()
                                  for t in leaves),
              "dtype": cfg.dtype, "init_seconds": init_s,
              "data_seconds": data_s,
              **serving_fields(d, LM_PROMPTS, S, LM_GEN),
              "max_memory_allocated": peak, "flash_launches": launches,
              "flash_launches_by_variant": by,
              "flash_calls": [[*k, c] for k, c in recorder.calls.items()],
              "checks": checks}
    del params, leaves, embeds, toks, gen, d
    free_card()
    emit("lm_vlm", t0, **fields)
    return {"launches": launches, "recorder": recorder, "device_us": {}}


def vlm_checks(cfg, params, embeds, toks, gen, stepped):
    """internvl2-26b's checks on its served weights, one batch of 8: (ii)
    prefill's last logits, flash kernel vs the chunked twin, in bf16 at
    full depth (clear greedy tokens agree) and in f32 on the first 4
    layers of the same weights (an f32 copy of all 48, 79 GB, does not
    fit; atol 2e-4, rtol 1e-3); (iii) in f32 on those layers, patch
    embeddings that are the table's rows of a token prefix give the
    hidden states of that prefix as tokens, on 2 rows; (iv) 8 decode
    steps replayed along the drain's tokens in f32 on those layers against
    a teacher-forced forward with the same embeddings (atol 2e-4, rtol
    1e-3), and the drain's own bf16 steps against the full-depth forward
    (clear tokens)."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as T

    P, text, n = cfg.n_patches, toks.shape[1], len(stepped)

    def last(p, c, impl, e):
        c = dataclasses.replace(c, attn_impl=impl)
        return T.prefill(p, c, toks, embeds=e)[0][:, -1, :c.vocab]

    def forced(p, c, e):
        seq = torch.cat([toks, gen[:, :n - 1]], dim=1)
        hidden = T.forward(p, c, seq, embeds=e, return_hidden=True)[0]
        return T._logits(p, c, hidden[:, P + text - 1:])[..., :c.vocab]

    checks, failed = {}, []
    flash = last(params, cfg, "pallas_flash", embeds)
    chunked = last(params, cfg, "xla_chunked", embeds)
    diff = (flash.float() - chunked.float()).abs().max().item()
    clear, clear_ok, agree = clear_tokens_agree(flash, chunked, diff)
    checks["ii_bf16"] = {"rel_l2": rel_l2(flash, chunked),
                         "max_abs_diff": diff, "tokens_clear": clear,
                         "tokens_clear_agree": clear_ok,
                         "tokens_agree": agree}
    if clear_ok != clear:
        failed.append("ii_bf16: a clear greedy token differs")
    stepped = torch.stack(stepped, dim=1)[..., :cfg.vocab]
    want = forced(params, cfg, embeds)
    cdiff = (stepped.float() - want.float()).abs().max().item()
    c_clear, c_ok, c_agree = clear_tokens_agree(stepped, want, cdiff)
    checks["iv_bf16"] = {"steps": n, "rel_l2": rel_l2(stepped, want),
                         "max_abs_diff": cdiff, "tokens_clear": c_clear,
                         "tokens_clear_agree": c_ok, "tokens_agree": c_agree}
    if c_ok != c_clear:
        failed.append("iv_bf16: a clear greedy token differs")
    del flash, chunked, want
    cfg4 = dataclasses.replace(cfg, dtype="float32", n_layers=VLM_F32_LAYERS)
    p4, e32 = first_layers(params, VLM_F32_LAYERS), embeds.float()
    flash4 = last(p4, cfg4, "pallas_flash", e32)
    chunked4 = last(p4, cfg4, "xla_chunked", e32)
    checks["ii_f32_4_layers"] = {
        "rel_l2": rel_l2(flash4, chunked4),
        "max_abs_diff": (flash4 - chunked4).abs().max().item()}
    gate_close("ii_f32_4_layers", flash4, chunked4, LM_F32_ATOL, LM_F32_RTOL,
               failed)
    rows = VLM_PREFIX_ROWS
    prefix, rest = toks[:rows, :P], toks[rows:2 * rows]
    a = T.forward(p4, cfg4, rest, embeds=p4["embed"][prefix],
                  return_hidden=True)[0]
    b = T.forward(p4, cfg4, torch.cat([prefix, rest], dim=1),
                  return_hidden=True)[0]
    checks["iii_prefix_f32_4_layers"] = {
        "rows": rows, "bitwise_equal": bool(torch.equal(a, b)),
        "max_abs_diff": (a - b).abs().max().item()}
    gate_close("iii_prefix_f32_4_layers", a, b, LM_F32_ATOL, LM_F32_RTOL,
               failed)
    del a, b
    logits, cache = T.prefill(p4, cfg4, toks, embeds=e32,
                              cache_len=P + text + n)
    steps32 = [logits[:, -1]]
    for g in range(n - 1):
        logits, cache = T.decode_step(p4, cfg4, cache, gen[:, g:g + 1],
                                      P + text + g)
        steps32.append(logits[:, -1])
    steps32 = torch.stack(steps32, dim=1)[..., :cfg.vocab]
    forced32 = forced(p4, cfg4, e32)
    checks["iv_f32_4_layers"] = {
        "steps": n, "rel_l2": rel_l2(steps32, forced32),
        "max_abs_diff": (steps32 - forced32).abs().max().item()}
    gate_close("iv_f32_4_layers", steps32, forced32, LM_F32_ATOL,
               LM_F32_RTOL, failed)
    del p4, e32, cache
    if failed:
        raise AssertionError(f"lm_vlm checks failed: {failed}; {checks}")
    return checks


def phase_lm_train():
    """Slice F7 on the card, each part on its own line and each model
    freed before the next: (a) `train_whole` (qwen2.5-3b), (b)
    `train_parity`, (c) `train_resume` (mamba2-130m through
    `launch.train.main`)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_card()
    whole = None
    for name, fn in (("a_qwen2.5-3b", train_whole),
                     ("b_card_eq_cpu_f32", train_parity),
                     ("c_mamba2-130m_resume", train_resume)):
        t0 = time.perf_counter()
        fields = fn()
        free_card()
        emit("lm_train", t0, part=name, **fields)
        whole = whole or fields
    return whole


def train_whole():
    """qwen2.5-3b at full width and all 36 layers: bf16 parameters, AdamW
    with f32 moments, ``remat="full"``, `TokenStream` batches of 4 × 1,024
    tokens, 6 steps of `ResilientLoop` without checkpoints, each step
    ending in a synchronize. Gates: every loss finite, no flash launch
    (training attends through the chunked twin). The model-FLOPs share is
    `roofline.model_flops_for` (6·N·tokens a step, N by `param_count`; the
    recompute of remat left out) over the median step's seconds, against
    989 TFLOP/s."""
    import math
    import statistics

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.kernels.flash_attn import kernel as KF
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS
    from repro_torch.train.fault_tolerance import ResilientLoop

    cfg = get_config(LM_ARCH)
    if cfg.remat != "full" or cfg.dtype != "bfloat16":
        raise AssertionError(f"{LM_ARCH} trains with remat {cfg.remat!r} in "
                             f"{cfg.dtype}, not 'full' in bfloat16")
    tw = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    state = TS.init_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - tw
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tensor_leaves(state))
    step = TS.build_train_step(TS.TrainPlan(cfg=cfg, total_steps=TRAIN_STEPS))
    times, metrics = [], []

    def timed(state, batch):
        ts = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        return out

    stream = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ)
    loop = ResilientLoop(timed, state,
                         lambda s: make_batch(cfg, stream, s, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    reset_flash_launches()
    _, end = loop.run(0, TRAIN_STEPS, lambda s, m: metrics.append(
        {k: float(v) for k, v in m.items()}))
    peak = torch.cuda.max_memory_allocated()
    launches = KF.LAUNCHES
    losses = [m["loss"] for m in metrics]
    if end != TRAIN_STEPS or loop.failures or len(losses) != TRAIN_STEPS \
            or not all(math.isfinite(x) for x in losses) or launches:
        raise AssertionError(
            f"{LM_ARCH} training: reached step {end}, failures "
            f"{loop.failures}, losses {losses}, {launches} flash launches")
    tooling_memory(cfg, state)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    RL = roofline()
    TRAIN_SHAPE = ShapeConfig("lm_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    steady = statistics.median(times[1:])
    n = cfg.param_count()
    del loop, state, params
    return {"layers": cfg.n_layers, "d_model": cfg.d_model,
            "param_count": n, "remat": cfg.remat, "dtype": cfg.dtype,
            "moment_dtype": "float32", "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "init_seconds": init_s,
            "state_bytes": state_bytes, "step_seconds": times,
            "steady_step_seconds": steady,
            "tokens_per_s": tokens / steady,
            "model_flops_share": RL.model_flops_for(cfg, TRAIN_SHAPE)
            / steady / RL.PEAK_FLOPS["bfloat16"],
            "model_flops_note": "roofline.model_flops_for: 6·N·tokens, "
                                "remat's recompute left out, against 989 "
                                "TFLOP/s bf16 (data sheet)",
            "max_memory_allocated": peak, "flash_launches": launches,
            "losses": losses,
            "grad_norms": [m["grad_norm"] for m in metrics],
            "lrs": [m["lr"] for m in metrics]}


def train_parity():
    """qwen2.5-3b at full width cut to 2 layers, in f32, one batch of 1 ×
    128: the port's loss and gradients on the card equal its loss and
    gradients on the CPU (the same weights, TF32 off) within atol 2e-4,
    rtol 1e-3, the grad norm too; then `torch.autograd.gradcheck` in f64
    on the card of both autograd functions (`rms_norm`,
    `lowp_matmul_f32`)."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.kernels.flash_attn import kernel as KF
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    cfg = TS.train_config(dataclasses.replace(
        get_config(LM_ARCH), n_layers=TRAIN_PARITY_LAYERS, dtype="float32"))
    card = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    host = adamw.tree_map(lambda t: t.cpu(), card)
    stream = TokenStream(cfg.vocab, 1, TRAIN_PARITY_SEQ)
    n = KF.LAUNCHES
    lc, gc = TS.loss_and_grads(card, cfg, make_batch(cfg, stream, 0,
                                                     device="cuda"))
    tw = time.perf_counter()
    lh, gh = TS.loss_and_grads(host, cfg, make_batch(cfg, stream, 0,
                                                     device="cpu"))
    cpu_s = time.perf_counter() - tw
    failed = []
    gate_close("loss", lc.cpu(), lh, LM_F32_ATOL, LM_F32_RTOL, failed)
    nc = adamw.global_norm(dict(enumerate(gc)))
    nh = adamw.global_norm(dict(enumerate(gh)))
    gate_close("grad_norm", nc.cpu(), nh, LM_F32_ATOL, LM_F32_RTOL, failed)
    worst = 0.0
    for i, (a, b) in enumerate(zip(gc, gh)):
        a = a.cpu()
        worst = max(worst, (a - b).abs().max().item())
        gate_close(f"grad leaf {i}", a, b, LM_F32_ATOL, LM_F32_RTOL, failed)
    rng = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((3, 4, 8), generator=rng, device="cuda",
                    dtype=torch.float64, requires_grad=True)
    w = (1 + 0.1 * torch.randn(8, generator=rng, device="cuda",
                               dtype=torch.float64)).requires_grad_()
    wm = torch.randn((8, 5), generator=rng, device="cuda",
                     dtype=torch.float64, requires_grad=True)
    grad_checks = {
        "rms_norm": torch.autograd.gradcheck(
            lambda a, b: L.rms_norm(a, b, 1e-6), (x, w)),
        "lowp_matmul_f32": torch.autograd.gradcheck(L.lowp_matmul_f32,
                                                    (x, wm))}
    out = {"layers": TRAIN_PARITY_LAYERS, "d_model": cfg.d_model,
           "seq": TRAIN_PARITY_SEQ, "loss_card": lc.item(),
           "loss_cpu": lh.item(), "grad_norm_card": nc.item(),
           "grad_norm_cpu": nh.item(), "grad_leaves": len(gc),
           "max_abs_grad_diff": worst, "cpu_seconds": cpu_s,
           "flash_launches": KF.LAUNCHES - n, "gradcheck_f64": grad_checks}
    if KF.LAUNCHES != n:
        failed.append("flash launched in training")
    if failed:
        raise AssertionError(f"lm_train card == CPU failed: {failed}; {out}")
    return out


MD_STORE = "md_store"  # the one-rank group's FileStore, under build/
MD_SHARDS = 4         # world of the shard-by-shard run
MD_STEPS = 4          # data-parallel steps of qwen2.5-3b
MD_PSUM_N = 1 << 24   # values of the compressed all-reduce
MD_DEVICE = "cuda"    # the card (a CPU rehearsal sets "cpu")


def phase_multi_device(graph, batched, main_wall, launches, res_stages,
                       res_launches, train):
    """Slice E5 on the card, inside a one-rank NCCL process group started
    from a `FileStore` under `build/` and destroyed at the end, so later
    phases run as before: (a) `md_engines`, (b) `md_shards`, (c)
    `md_train`, (e) `md_remesh` of (c)'s state, (d) `md_psum`, each on
    its own line."""
    import torch
    import torch.distributed as dist

    store = ROOT / "build" / MD_STORE
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        t0 = time.perf_counter()
        fields, captured = md_engines(graph, batched, main_wall, launches,
                                      res_stages, res_launches)
        emit("multi_device", t0, part="a_engine_mesh", **fields)
        kept = []  # (c)'s state and mesh, which (e) takes over
        for name, fn in (("b_shards_in_turn", lambda: md_shards(graph,
                                                                captured)),
                         ("c_qwen2.5-3b_data_parallel",
                          lambda: md_train(train, kept)),
                         ("e_remesh", lambda: md_remesh(kept)),
                         ("d_compressed_psum", md_psum)):
            t0 = time.perf_counter()
            fields = fn()
            free_card()
            emit("multi_device", t0, part=name, **fields)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def md_engines(graph, batched, main_wall, launches, res_stages,
               res_launches):
    """(a) The main graph under `make_data_mesh()` with the batched and the
    resident backends. Captures the widest intersection batch the mesh
    dispatch handed its per-rank body and the widest arena the resident
    run uploaded, for `md_shards`."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core import resident as R
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh()
    captured = {"tile": None, "arena": None}
    orig_rank, orig_up = D.intersections_rank, R.ResidentBitmapArena.\
        from_workspace.__func__

    def rank_body(batch, B, rank, world, device):
        if captured["tile"] is None or B > captured["tile"][1]:
            captured["tile"] = (batch.copy(), B)
        return orig_rank(batch, B, rank, world, device)

    def upload(cls, ws, **kw):
        arena = orig_up(cls, ws, **kw)
        if captured["arena"] is None or arena.B > captured["arena"][1]:
            captured["arena"] = ({k: v.clone() for k, v in
                                  arena.state.items()}, arena.B, arena.J)
        return arena

    out = {}
    D.intersections_rank = rank_body
    R.ResidentBitmapArena.from_workspace = classmethod(upload)
    try:
        for backend, want, plain_launches, plain_wall in (
                ("batched", ("bitset_intersections", "segment_histogram"),
                 launches, main_wall),
                ("resident", ("jaccard_topj", "bitset_fold"), res_launches,
                 res_stages["wall"])):
            reset_launches()
            engine, summary, wall = run_clean(graph, backend,
                                              f"mesh {backend}", T=20,
                                              mesh=mesh)
            got = read_launches()
            if not (summary.validate_lossless(graph)
                    and same_summary(summary, batched)):
                raise AssertionError(f"mesh {backend}: the summary is not "
                                     f"the main batched one")
            for name in want:
                if got[name] <= 0:
                    raise AssertionError(f"mesh {backend} never launched "
                                         f"{name}")
            out[backend] = {"wall_seconds": wall, "launches": got,
                            "no_mesh_wall_seconds": plain_wall,
                            "no_mesh_launches": plain_launches,
                            "stage_seconds": stage_seconds(engine),
                            "equal_to_batched": True, "lossless": True}
    finally:
        D.intersections_rank = orig_rank
        R.ResidentBitmapArena.from_workspace = classmethod(orig_up)
    torch.cuda.synchronize()
    out["mesh"] = {"shape": list(mesh.mesh.shape),
                   "dims": list(mesh.mesh_dim_names)}
    return out, captured


def md_shards(graph, captured):
    """(b) Each sharded function's per-rank body for ranks 0..3 of a world
    of 4, one after the other on the card, against the unsharded call:
    the node shingles of the graph's edge blocks (MIN over the ranks), the
    intersection kernel on the widest tile batch of (a) (rows concatenated,
    each shard with its own valid count), and one arena round on the
    widest arena of (a): the top-J proposal (`ops.propose_dense`) and the
    fold of one accepted pair a group (`ops.fold_shard`), every state
    tensor concatenated."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core.merging import theta_to_p
    from repro_torch.kernels._build import pow2
    from repro_torch.kernels.bitset_fold import ops as FO
    from repro_torch.kernels.bitset_jaccard.kernel import bitset_intersections
    from repro_torch.launch.mesh import block

    n = MD_SHARDS
    out = {}
    # node shingles of the edge blocks
    src = np.repeat(np.arange(graph.n), np.diff(graph.indptr))
    pad = (-src.size) % n
    src_p = torch.from_numpy(np.concatenate([src, np.full(pad, graph.n)]))
    dst_p = torch.from_numpy(np.concatenate(
        [graph.indices.astype(np.int64), np.zeros(pad, np.int64)]))
    src_p, dst_p = src_p.to(MD_DEVICE), dst_p.to(MD_DEVICE)
    a, b = 2654435761, 0x9E3779B9
    parts = [D.shingles_local(src_p[block(src_p.numel(), r, n)],
                              dst_p[block(dst_p.numel(), r, n)], graph.n,
                              a, b) for r in range(n)]
    want = D.node_shingles_dense(src_p[:src.size], dst_p[:src.size],
                                 graph.n, a, b)
    if not torch.equal(torch.stack(parts).amin(0), want):
        raise AssertionError("per-rank shingles differ from the dense ones")
    out["shingles"] = {"edges": int(src.size), "equal": True}
    # the intersection kernel, shard by shard
    tile, B = captured["tile"]
    Bs = pow2(-(-B // n), floor=1)
    batch = np.zeros((n * Bs, *tile.shape[1:]), dtype=np.uint32)
    batch[:B] = tile[:B]
    got = torch.cat([D.intersections_rank(batch, B, r, n, MD_DEVICE)
                     for r in range(n)])
    whole = bitset_intersections(torch.from_numpy(
        batch.view(np.int32)).to(MD_DEVICE), B)
    if not torch.equal(got, whole):
        raise AssertionError("per-rank intersections differ from the "
                             "unsharded kernel call")
    out["intersections"] = {"B": B, "Bp": n * Bs, "G": tile.shape[1],
                            "W": tile.shape[2], "valid_by_rank": [
                                int(np.clip(B - r * Bs, 0, Bs))
                                for r in range(n)], "equal": True}
    # one arena round
    state, B, J = captured["arena"]
    Bp = state["bits"].shape[0]
    Bq = n * pow2(-(-Bp // n), floor=1)
    if Bq != Bp:  # pad with inert all-dead, all-zero groups
        state = {k: torch.cat([v, v.new_zeros((Bq - Bp, *v.shape[1:]))])
                 for k, v in state.items()}
    Bs = Bq // n
    shards = [{k: v[block(Bq, r, n)].clone() for k, v in state.items()}
              for r in range(n)]
    theta_p = theta_to_p(0.0)
    whole = FO.propose_dense(state, J, theta_p, None)
    got = torch.cat([FO.propose_dense(s, J, theta_p, None) for s in shards])
    if not torch.equal(got, whole):
        raise AssertionError("per-rank proposals differ from the unsharded "
                             "top-J round")
    acc = whole.cpu().numpy()
    if not acc[..., 1].any():
        raise AssertionError("the arena round accepted no proposal to fold")
    gb, gr = np.nonzero(acc[..., 1])
    first = np.concatenate([[True], gb[1:] != gb[:-1]])[:gb.size]
    gb, ga, gz = gb[first], gr[first], acc[gb[first], gr[first], 2]
    keep = ga != gz
    gb, ga, gz = (torch.from_numpy(x[keep].astype(np.int64)).to(MD_DEVICE)
                  for x in (gb, ga, gz))
    slot = torch.zeros_like(gb)
    G = state["bits"].shape[1]
    P = min(2, max(G // 2, 1))
    FO.fold(state, gb, slot, ga, gz, P)
    for r, s in enumerate(shards):
        FO.fold_shard(s, gb, slot, ga, gz, P, r * Bs)
    for k, v in state.items():
        if not torch.equal(torch.cat([s[k] for s in shards]), v):
            raise AssertionError(f"per-rank folds differ from the "
                                 f"unsharded fold in {k}")
    out["arena_round"] = {"B": B, "Bp": Bq, "G": G, "J": J,
                          "dirty_rows": int(acc[..., 0].sum()),
                          "accepted": int(acc[..., 1].sum()),
                          "folded_pairs": int(gb.numel()), "equal": True}
    return out


def md_train(train, kept):
    """(c) qwen2.5-3b at full width and depth through the data-parallel
    step with ZeRO-1 on the one-rank group (`make_host_mesh(1, 1)`), 4
    steps of 4 × 1,024 from `lm_train`'s seed, batches and schedule. Gate:
    the losses equal `lm_train`'s plain step's first 4 bit for bit. If
    they do not, both runs are taken again here under
    `torch.use_deterministic_algorithms` (the backward's atomics may
    reorder sums) and held to each other. The last data-parallel run's
    state and mesh are appended to ``kept`` for `md_remesh`."""
    import os

    import torch

    from repro_torch.launch.mesh import make_host_mesh

    plain = train["losses"][:MD_STEPS]
    mesh = make_host_mesh(1, 1)
    got, times, peak = md_qwen_steps(mesh, kept)
    mode = "default"
    if got != plain:
        mode = "deterministic"
        kept.clear()
        free_card()
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            plain = md_qwen_steps(None)[0]
            got, times, peak = md_qwen_steps(mesh, kept)
        finally:
            torch.use_deterministic_algorithms(False)
    if got != plain:
        raise AssertionError(f"data-parallel losses {got} are not the plain "
                             f"step's {plain} ({mode} mode)")
    import statistics

    return {"mode": mode, "losses": got, "plain_losses": plain,
            "bitwise_equal": True, "step_seconds": times,
            "steady_step_seconds": statistics.median(times[1:]),
            "plain_steady_step_seconds": train["steady_step_seconds"],
            "max_memory_allocated": peak,
            "plain_max_memory_allocated": train["max_memory_allocated"],
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "zero1": True}


def md_qwen_steps(mesh, kept=None):
    """``MD_STEPS`` steps of qwen2.5-3b as `train_whole` takes them (seed
    0, `TokenStream` batches, schedule over ``TRAIN_STEPS``), through the
    data-parallel step under ``mesh`` (the plain step for None): losses,
    seconds a step, peak memory. With ``kept`` (a list) the state and
    ``mesh`` are appended to it instead of dropped."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS

    cfg = get_config(LM_ARCH)
    plan = TS.TrainPlan(cfg=cfg, total_steps=TRAIN_STEPS, mesh=mesh)
    params = T.init_params(cfg, torch.Generator(
        device=MD_DEVICE).manual_seed(0), device=MD_DEVICE)
    state = TS.init_state(params, plan.opt, plan)
    step = TS.build_train_step(plan)
    stream = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for s in range(MD_STEPS):
        batch = make_batch(cfg, stream, s, device=MD_DEVICE, mesh=mesh)
        ts = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if kept is not None:
        kept.append((state, mesh))
    del state, params
    free_card()
    return losses, times, peak


DIGEST_CHUNK = 1 << 26  # int16 words a pass of `bit_digest`


def bit_digest(t) -> tuple:
    """(dtype, shape, two sums) of ``t``'s bit patterns read as int16
    words, the second weighted by position (mod 65,521, plus 1), summed
    in int64 on ``t``'s device: no sum can overflow (|word · weight| <
    2^31, fewer than 2^32 words). Bit-equal tensors give equal digests; a
    changed, moved or lost word changes them."""
    import torch

    words = t.detach().contiguous().reshape(-1).view(torch.int16)
    s0 = torch.zeros((), dtype=torch.int64, device=t.device)
    s1 = torch.zeros_like(s0)
    for i in range(0, words.numel(), DIGEST_CHUNK):
        x = words[i:i + DIGEST_CHUNK].to(torch.int64)
        pos = (torch.arange(i, i + x.numel(), device=t.device) % 65521) + 1
        s0 += x.sum()
        s1 += (x * pos).sum()
    return str(t.dtype), tuple(t.shape), int(s0), int(s1)


def sorted_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order (`remesh_state`'s
    and the checkpoints' order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    return [tree]


def local_tree(tree):
    """A tree of `elastic.Placed` leaves as the tree of this rank's
    blocks."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    return tree.local


def md_remesh(kept):
    """(e) (c)'s qwen2.5-3b state (bf16 parameters, f32 moments) moved by
    `elastic.remesh_state`, no device named, onto `make_mesh_for([0], 1)`
    under `train_step.state_specs`; one step through `build_train_step`
    on that mesh; the state after it moved back onto (c)'s mesh. Gates,
    at each move: every leaf gathered whole (one at a time) has the
    `bit_digest` its whole tensor had before the move — two copies of
    the state never sit beside a third — every block is on ``cuda:0``;
    the step's loss is finite. Seconds, bytes and peak memory a move."""
    import math

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.train import elastic as EL
    from repro_torch.train import train_step as TS

    t_part = time.perf_counter()
    state, home = kept.pop()
    cfg = get_config(LM_ARCH)
    card = torch.device("cuda", 0) if MD_DEVICE == "cuda" else torch.device(
        MD_DEVICE)

    def specs_on(st, mesh):
        return TS.state_specs(TS.TrainPlan(cfg=cfg, mesh=mesh))

    def whole(leaf):  # one rank: a block is the whole tensor
        return leaf.local if isinstance(leaf, EL.Placed) else leaf

    def timed_move(st, mesh):
        want = [bit_digest(whole(t)) for t in sorted_leaves(st)]
        nbytes = sum(whole(t).numel() * whole(t).element_size()
                     for t in sorted_leaves(st))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = EL.remesh_state(st, mesh, specs_on)
        torch.cuda.synchronize()
        line = {"seconds": time.perf_counter() - t0, "bytes_moved": nbytes,
                "leaves": len(want),
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
        return out, want, line

    def check(moved, want, line):
        t0 = time.perf_counter()
        leaves = sorted_leaves(moved)
        off_card = sum(p.local.device != card for p in leaves)
        differ = len(leaves) != len(want)
        for p, w in zip(leaves, want):
            differ += bit_digest(EL.gather_full(p)) != w
        line.update(check_seconds=time.perf_counter() - t0,
                    leaves_differing=int(differ), blocks_off_card=off_card)
        if differ or off_card:
            raise AssertionError(f"e_remesh: {line}")

    new = EL.make_mesh_for([0], 1)
    moved, want, there = timed_move(state, new)
    del state
    free_card()
    check(moved, want, there)

    # the step updates the blocks in place: ``moved`` then holds its state
    plan = TS.TrainPlan(cfg=cfg, total_steps=TRAIN_STEPS, mesh=new)
    batch = make_batch(cfg, TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ),
                       MD_STEPS, device=MD_DEVICE, mesh=new)
    t0 = time.perf_counter()
    loss = float(TS.build_train_step(plan)(local_tree(moved), batch)[1][
        "loss"])
    step_s = time.perf_counter() - t0
    del batch
    free_card()
    if not math.isfinite(loss):
        raise AssertionError(f"e_remesh: the step after the move gave loss "
                             f"{loss}")

    back, want, back_line = timed_move(moved, home)
    del moved
    free_card()
    check(back, want, back_line)
    del back
    return {"arch": LM_ARCH, "moment_dtype": plan.opt.moment_dtype,
            "to": list(new.mesh.shape), "there": there,
            "step_loss": loss, "step_seconds": step_s, "back": back_line,
            "bit_equal": True, "blocks_on": str(card),
            "part_seconds": time.perf_counter() - t_part}


def md_psum():
    """(d) `compressed_psum` over the one-rank group on 2^24 values: equal
    to quantize → dequantize of g + err, and the carried error to what
    that rounding left; its time by CUDA events."""
    import torch

    from repro_torch.optim import grad_compression as GC

    gen = torch.Generator(device=MD_DEVICE).manual_seed(0)
    g = torch.randn(MD_PSUM_N, generator=gen, device=MD_DEVICE)
    err = 1e-3 * torch.randn(MD_PSUM_N, generator=gen, device=MD_DEVICE)
    mean, new_err = GC.compressed_psum(g, err)
    x = g + err
    q, scale, n = GC.quantize_int8(x)
    deq = GC.dequantize_int8(q, scale, n)
    if not (torch.equal(mean, deq) and torch.equal(new_err, x - deq)):
        raise AssertionError("compressed_psum on one rank is not quantize → "
                             "dequantize")
    ms = cuda_ms(lambda: GC.compressed_psum(g, err), 10)
    return {"n": MD_PSUM_N, "equal": True, "ms": ms,
            "max_abs_err_vs_g_plus_err": float((mean - x).abs().max())}


def ckpt_gap(a, b, step):
    """(bit for bit equal?, max |a − b| over every leaf, NaN where either
    holds one) of two checkpoints of ``step`` (`train.checkpoint`'s
    layout: arrays in manifest order, bf16 as raw bytes)."""
    import numpy as np

    def read(d):
        d = Path(d) / f"step_{step:08d}"
        return d, json.loads((d / "manifest.json").read_text())["arrays"]

    def as_f64(x, entry):
        if entry.get("raw_bytes"):
            x = (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        return x.astype(np.float64).reshape(-1)

    (da, ma), (db, mb) = read(a), read(b)
    if [e["key"] for e in ma] != [e["key"] for e in mb]:
        raise AssertionError(f"checkpoints {da} and {db} hold other leaves")
    same, gap = True, 0.0
    for ea, eb in zip(ma, mb):
        xa, xb = np.load(da / ea["file"]), np.load(db / eb["file"])
        same &= xa.dtype == xb.dtype and xa.tobytes() == xb.tobytes()
        if xa.size:
            gap = np.fmax(gap, np.abs(as_f64(xa, ea) - as_f64(xb, eb)).max())
    return same, float(gap)


def train_resume():
    """mamba2-130m whole (the training CLI's default arch) through
    `launch.train.main(["--device", "cuda", ...])`: 8 steps of 8 × 128,
    checkpoints every 4, under `build/train_ckpt/`. Two uninterrupted
    runs first: if their final states differ (the embedding's backward
    accumulates with atomics), the rest runs under
    `torch.use_deterministic_algorithms` with ``CUBLAS_WORKSPACE_CONFIG``
    set, and an uninterrupted run is taken again there. Then a run whose
    step fails at step 6 on every attempt of its first pass: the loop
    restores step 4 and replays. Gates: the failure fired max_retries + 1
    times, the replayed losses are the uninterrupted run's, and the final
    state equals the uninterrupted run's bit for bit. The gap between the
    two first runs is printed either way, and every loss must be
    finite."""
    import math
    import os
    import shutil

    import torch

    from repro_torch.launch import train as LT
    from repro_torch.train.fault_tolerance import FaultToleranceConfig

    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    args = ["--arch", SSM_ARCH, "--steps", str(RESUME_STEPS), "--ckpt-every",
            str(RESUME_CKPT_EVERY), "--device", "cuda", "--log-every",
            str(RESUME_STEPS)]
    runs = {}

    def run(name, fault=False):
        orig, left = LT.build_train_step, [0]
        if fault:
            left[0] = FaultToleranceConfig().max_retries + 1

            def faulty(plan):
                step = orig(plan)

                def wrapped(state, batch):
                    if int(state["opt"]["step"]) == RESUME_FAIL_AT \
                            and left[0]:
                        left[0] -= 1
                        raise RuntimeError(f"injected failure at step "
                                           f"{RESUME_FAIL_AT}")
                    return step(state, batch)

                return wrapped

            LT.build_train_step = faulty
        tw = time.perf_counter()
        try:
            losses = LT.main(args + ["--ckpt-dir", str(root / name)])
        finally:
            LT.build_train_step = orig
        runs[name] = {"seconds": time.perf_counter() - tw, "losses": losses,
                      "faults_left": left[0]}
        return losses

    full = run("a")
    run("b")
    same_ab, gap_ab = ckpt_gap(root / "a", root / "b", RESUME_STEPS)
    mode, ref = "default", "a"
    if not same_ab:
        mode, ref = "deterministic", "c"
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        if ref == "c":
            full = run("c")
        got = run("f", fault=True)
    finally:
        torch.use_deterministic_algorithms(False)
    same, gap = ckpt_gap(root / ref, root / "f", RESUME_STEPS)
    k, r = RESUME_FAIL_AT, RESUME_CKPT_EVERY
    out = {"mode": mode, "uninterrupted_bitwise_equal": same_ab,
           "uninterrupted_max_abs_gap": gap_ab,
           "resumed_bitwise_equal": same, "resumed_max_abs_gap": gap,
           "runs": runs}
    if runs["f"]["faults_left"] or len(got) != RESUME_STEPS + k - r \
            or got[:k] != full[:k] or got[k:] != full[r:] or not same \
            or not all(math.isfinite(x) for x in full):
        raise AssertionError(f"lm_train resume check failed: {out}")
    shutil.rmtree(root, ignore_errors=True)
    return out


@contextlib.contextmanager
def plain_attention():
    """Within: `flash_attn.ops` calls the kernel's plain version (f32
    scores and sums, the output in the input's type) instead of the
    kernel. Used only to measure the bf16 floor, never on a counted run."""
    from repro_torch.kernels.flash_attn import ops as OF, ref as RF

    kernel = OF.flash_attention_bhsd
    OF.flash_attention_bhsd = RF.attention_ref
    try:
        yield
    finally:
        OF.flash_attention_bhsd = kernel


def last_logits(params, cfg, batch, impl):
    """The prefill's last-position logits over the real vocabulary."""
    import dataclasses

    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(cfg, attn_impl=impl)
    return T.prefill(params, cfg, batch)[0][:, -1, :cfg.vocab]


def forced_logits(params, cfg, batch, gen, n):
    """A teacher-forced forward over prompt + the first ``n − 1`` generated
    tokens: the logits at the ``n`` positions that predict them."""
    import torch

    from repro_torch.models import transformer as T

    seq = torch.cat([batch, gen[:, :n - 1]], dim=1)
    hidden = T.forward(params, cfg, seq, return_hidden=True)[0]
    return T._logits(params, cfg, hidden[:, batch.shape[1] - 1:])[
        ..., :cfg.vocab]


def clear_tokens_agree(got, want, diff):
    """Greedy tokens agree wherever ``want``'s top-2 margin exceeds twice
    the largest |got − want|: (clear, agreeing among clear, agreeing)."""
    top2 = want.float().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * diff
    agree = got.argmax(-1) == want.argmax(-1)
    return int(clear.sum()), int(agree[clear].sum()), int(agree.sum())


def lm_checks(cfg, params, batch, gen, stepped):
    """Checks (a)–(c) of the served model, on one batch.

    bf16 at full depth sits at its own rounding floor: on this random
    36-layer model two equally right computations of the logits differ by
    about 2% in relative L2 (the flash path against the same model with
    the kernel's plain version in its place, and the bf16 model against
    an f32 copy of it; both are printed), so a bf16 logit bound cannot
    tell a right kernel from a wrong one. The bf16 runs are held to greedy-token agreement where the margin
    is clear, with their relative L2 reported; the numerical gates run at
    full depth in f32 (the same weights cast), at the reference's own
    tolerance between its two attention paths.

    (a) prefill's last-position logits, flash kernel vs the chunked twin;
    (b) the same at full width and 2 layers in f32 with fresh weights;
    (c) the drain's first decode steps (``stepped``: the prefill's logits,
        then each step's) vs a teacher-forced forward over prompt +
        generated tokens; in f32 the same decode is replayed along the
        drain's tokens."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as T

    checks = {}
    n = len(stepped)
    stepped = torch.stack(stepped, dim=1)[..., :cfg.vocab]
    # bf16, full depth: the served path
    flash = last_logits(params, cfg, batch, "pallas_flash")
    chunked = last_logits(params, cfg, batch, "xla_chunked")
    diff = (flash.float() - chunked.float()).abs().max().item()
    clear, clear_ok, agree = clear_tokens_agree(flash, chunked, diff)
    with plain_attention():  # the same model, the kernel's plain version
        plain = last_logits(params, cfg, batch, "pallas_flash")
    checks["a_bf16"] = {"rel_l2": rel_l2(flash, chunked),
                        "max_abs_diff": diff, "tokens_clear": clear,
                        "tokens_clear_agree": clear_ok,
                        "tokens_agree": agree,
                        "rel_l2_to_plain_version": rel_l2(flash, plain)}
    forced = forced_logits(params, cfg, batch, gen, n)
    cdiff = (stepped.float() - forced.float()).abs().max().item()
    c_clear, c_ok, c_agree = clear_tokens_agree(stepped, forced, cdiff)
    checks["c_bf16"] = {"steps": n, "rel_l2": rel_l2(stepped, forced),
                        "max_abs_diff": cdiff, "tokens_clear": c_clear,
                        "tokens_clear_agree": c_ok, "tokens_agree": c_agree}
    # f32, full depth: the same weights cast
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = f32_tree(params)
    flash32 = last_logits(p32, cfg32, batch, "pallas_flash")
    chunked32 = last_logits(p32, cfg32, batch, "xla_chunked")
    checks["a_f32"] = {"rel_l2": rel_l2(flash32, chunked32),
                       "max_abs_diff": (flash32 - chunked32).abs().max()
                       .item(),
                       "bf16_flash_vs_f32": rel_l2(flash, flash32),
                       "bf16_chunked_vs_f32": rel_l2(chunked, chunked32)}
    logits, cache = T.prefill(p32, cfg32, batch,
                              cache_len=batch.shape[1] + n)
    steps32 = [logits[:, -1]]
    for g in range(n - 1):
        logits, cache = T.decode_step(p32, cfg32, cache, gen[:, g:g + 1],
                                      batch.shape[1] + g)
        steps32.append(logits[:, -1])
    steps32 = torch.stack(steps32, dim=1)[..., :cfg.vocab]
    forced32 = forced_logits(p32, cfg32, batch, gen, n)
    checks["c_f32"] = {"steps": n, "rel_l2": rel_l2(steps32, forced32),
                       "max_abs_diff": (steps32 - forced32).abs().max()
                       .item()}
    del p32, cache
    # (b) f32, full width, 2 layers, fresh weights
    cfg2 = dataclasses.replace(cfg32, n_layers=2)
    p2 = T.init_params(cfg2, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    flash2 = last_logits(p2, cfg2, batch, "pallas_flash")
    chunked2 = last_logits(p2, cfg2, batch, "xla_chunked")
    checks["b_f32_2_layers"] = {
        "rel_l2": rel_l2(flash2, chunked2),
        "max_abs_diff": (flash2 - chunked2).abs().max().item()}
    del p2
    failed = []
    if clear_ok != clear:
        failed.append("a_bf16: a clear greedy token differs")
    if c_ok != c_clear:
        failed.append("c_bf16: a clear greedy token differs")
    for name, got, want in (("a_f32", flash32, chunked32),
                            ("c_f32", steps32, forced32),
                            ("b_f32_2_layers", flash2, chunked2)):
        if not torch.allclose(got, want, atol=LM_F32_ATOL, rtol=LM_F32_RTOL):
            failed.append(f"{name} beyond atol {LM_F32_ATOL}, rtol "
                          f"{LM_F32_RTOL}")
    if failed:
        raise AssertionError(f"lm_serve checks failed: {failed}; {checks}")
    return checks


def f32_tree_(tree):
    """``tree``'s tensors cast to f32 in place of the originals."""
    for k, v in tree.items():
        tree[k] = f32_tree_(v) if isinstance(v, dict) else v.float()
    return tree


def f32_tree(tree):
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    return tree.float()


def tensor_leaves(tree):
    """The tensors of a nested parameter dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    else:
        yield tree


def phase_trace_lm(lm):
    """The drain once more under the profiler — every prompt, its prefills
    whole, ``LM_TRACE_GEN`` tokens each — after a warm-up run of one
    prompt and 2 tokens: the device's busy share and its top ops over
    prefill and decode."""
    t0 = time.perf_counter()
    wall, by_name = traced(lambda: lm["server"].run(lm["prompts"],
                                                    gen_tokens=LM_TRACE_GEN),
                           warmup=lambda: lm["server"].run(
                               lm["prompts"][:1], gen_tokens=2))
    emit_trace(t0, "lm-serve", wall, by_name, top=12)
    return by_name


def flash_record(drains):
    """The flash kernel's contract entry over the LM drains (``drains``:
    each phase's launch count, `FlashRecorder` and traced device times):
    each distinct call shape re-run on its recorded inputs against the
    plain version, timed beside it and SDPA, bounded, and weighted by its
    call count. ``library_ms`` is null, with the reason, when SDPA refuses
    one of the shapes (v narrower than q and k); ``by_shape`` keeps each
    shape's sums."""
    from repro_torch.kernels.flash_attn import kernel as KF, ref as RF

    saved = KF.LAUNCHES  # comparison launches do not count
    acc = dict(ms=0.0, plain_ms=0.0, bb=0.0, bo=0.0, err=0.0)
    by_shape, notes = [], []
    for drain in drains:
        rec = drain["recorder"]
        for key, n in rec.calls.items():
            q, k, v = rec.inputs[key]
            *_, causal, window = key
            err = flash_error(q, k, v, causal, window)
            ms = n * cuda_ms(lambda: KF.flash_attention_bhsd(
                q, k, v, causal=causal, window=window), 10)
            plain = n * cuda_ms(lambda: RF.attention_ref(
                q, k, v, causal=causal, window=window), 3)
            lib = library_fields(q, k, v, causal, window)
            if lib["library_ms"] is not None:
                lib["library_ms"] *= n
            else:
                notes.append(lib["library_note"])
            bb, bo = flash_bound_s(*key)
            by_shape.append({"shape": list(key), "launches": n, "ms": ms,
                             "plain_ms": plain, "bound_ms": n * max(bb, bo)
                             * 1e3, **lib, "max_abs_err": err})
            acc["err"] = max(acc["err"], err)
            acc["ms"] += ms
            acc["plain_ms"] += plain
            acc["bb"] += n * bb
            acc["bo"] += n * bo
    KF.LAUNCHES = saved
    names = ("flash_attention_tc_kernel", "flash_attention_kernel")
    return [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attn/kernel.py:80",
        "launches": sum(d["launches"] for d in drains),
        "max_abs_err": acc["err"], "ms": acc["ms"],
        "plain_ms": acc["plain_ms"],
        "bound_ms": max(acc["bb"], acc["bo"]) * 1e3,
        "bound_by": "bytes" if acc["bb"] >= acc["bo"] else "operations",
        "library_ms": None if notes else sum(
            r["library_ms"] for r in by_shape),
        **({"library_note": notes[0]} if notes else {}),
        "device_ms": sum(device_ms(d["device_us"], names) or 0.0
                         for d in drains) or None,
        "by_shape": by_shape}]


def traced(fn, warmup=False):
    """Run ``fn`` once under `torch.profiler`: its wall and the device's
    busy time by kernel, copy and torch op. The profiler drops the device
    activities of its first millisecond or so (seen as missing launches in
    short traces), so with ``warmup`` a discarded warm-up step runs first
    — ``fn`` itself, or ``warmup`` where it is a function (a shorter run
    of what ``fn`` runs, whose shapes an earlier phase has already warmed)
    — and the run of ``fn`` after it is the one recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    steps = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup else None
    with profile(activities=[ProfilerActivity.CUDA], schedule=steps) as prof:
        if warmup:
            (warmup if callable(warmup) else fn)()
            torch.cuda.synchronize()
            prof.step()
        tw = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
        if warmup:
            prof.step()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            by_name[e.key] = {"device_us": us, "count": e.count}
    return wall, by_name


def emit_trace(t0, what, wall, by_name, top=8):
    busy_us = sum(v["device_us"] for v in by_name.values())
    ranked = dict(sorted(by_name.items(),
                         key=lambda kv: -kv[1]["device_us"])[:top])
    emit("trace", t0, backend=what, wall_seconds=wall,
         device_busy_us=busy_us,
         device_busy_share=busy_us * 1e-6 / wall if busy_us else None,
         kernel_launches=sum(v["count"] for v in by_name.values()),
         by_name=ranked)


def phase_trace_serving(served, shingles):
    """The kernel-backend drains of every served summary (``served``: its
    `PackedSummary` and queries) and the shingle calls once more each under
    the profiler, after a warm-up run."""
    from repro_torch.kernels.bitset_jaccard import kernel as K1
    from repro_torch.kernels.minhash import ops as OM
    from repro_torch.launch.summary_serve import SummaryQueryServer

    t0 = time.perf_counter()
    servers = [(SummaryQueryServer(ps, batch_slots=SERVE_SLOTS,
                                   backend="kernel", device="cuda"), queries)
               for ps, queries in served]

    def drains():
        for server, queries in servers:
            server.run(queries)

    wall, by_name = traced(drains, warmup=True)
    emit_trace(t0, "serve-kernel", wall, by_name)
    t0 = time.perf_counter()

    def calls():
        for a, b in shingles["consts"]:
            OM.node_shingles(shingles["rows"], shingles["owners"],
                             shingles["n"], a, b)
        K1.pairwise_intersections(shingles["bits"])

    wall2, by_name2 = traced(calls, warmup=True)
    emit_trace(t0, "shingles", wall2, by_name2)
    return {**by_name, **by_name2}


def device_ms(device_us, names):
    return sum(v["device_us"] for k, v in device_us.items()
               if any(n in k for n in names)) * 1e-3 or None


def serving_kernel_record(serve_calls, serve_launches, shingles, device_us,
                          rates):
    """The contract entries of the three serving/shingle kernels: each
    path's calls re-run against the plain version, timed and bounded."""
    import torch

    from repro_torch.kernels.bitset_jaccard import kernel as K1, ref as R1
    from repro_torch.kernels.interval_expand import kernel as KI, ref as RI
    from repro_torch.kernels.minhash import kernel as KM, ref as RM

    # comparison launches do not count
    saved = (KI.LAUNCHES, KM.LAUNCHES, K1.PAIRWISE_LAUNCHES)
    iv = dict(ms=0.0, plain_ms=0.0, library_ms=None, bb=0.0, bo=0.0, err=0)
    for x in serve_calls:
        B, E = x[0].shape
        P = x[3].shape[1]
        iv["err"] = max(iv["err"], exact_error(
            "interval_count", KI.interval_counts(*x), RI.interval_counts(*x),
            (B, E, P)))
        iv["ms"] += cuda_ms(lambda: KI.interval_counts(*x), 5)
        iv["plain_ms"] += cuda_ms(lambda: RI.interval_counts(*x), 1)
        bb, bo = interval_bound_s(B, E, P, *interval_work(*x), rates)
        iv["bb"] += bb
        iv["bo"] += bo
    rm = dict(ms=0.0, plain_ms=0.0, library_ms=None, bb=0.0, bo=0.0, err=0)
    nbr = shingles["rows"]
    for a, b in shingles["consts"]:
        rm["err"] = max(rm["err"], exact_error(
            "rowmin_hash", KM.rowmin_hash(nbr, a, b), RM.rowmin_hash(nbr, a, b),
            tuple(nbr.shape)))
        rm["ms"] += cuda_ms(lambda: KM.rowmin_hash(nbr, a, b), 20)
        rm["plain_ms"] += cuda_ms(lambda: RM.rowmin_hash(nbr, a, b), 2)
        bb, bo = rowmin_bound_s(nbr, rates)
        rm["bb"] += bb
        rm["bo"] += bo
    bits = shingles["bits"]
    G, W = bits.shape
    bb, bo, unit = pairwise_bound_s(G, W, rates)
    pw = dict(ms=cuda_ms(lambda: K1.pairwise_intersections(bits), 20),
              plain_ms=cuda_ms(lambda: R1.pairwise_intersection(bits), 2),
              library_ms=cuda_ms(pairwise_library(bits), 10), bb=bb, bo=bo,
              unit=unit,
              err=exact_error("pairwise_intersections",
                              K1.pairwise_intersections(bits),
                              R1.pairwise_intersection(bits), (G, W)))
    KI.LAUNCHES, KM.LAUNCHES, K1.PAIRWISE_LAUNCHES = saved
    out = []
    for name, acc, n_launch, src, replaces, names in (
            ("interval_count", iv, serve_launches,
             "src/repro_torch/csrc/interval_count.cu",
             "src/repro/kernels/interval_expand/kernel.py:43",
             ("interval_count_kernel", "interval_probe_kernel")),
            ("rowmin_hash", rm, shingles["rowmin_launches"],
             "src/repro_torch/csrc/rowmin_hash.cu",
             "src/repro/kernels/minhash/kernel.py:42",
             ("rowmin_hash_kernel",)),
            ("pairwise_intersections", pw, shingles["pairwise_launches"],
             "src/repro_torch/csrc/pairwise_intersections.cu",
             "src/repro/kernels/bitset_jaccard/kernel.py:44",
             ("pairwise_intersections_kernel",))):
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": acc["err"], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"],
            "bound_ms": max(acc["bb"], acc["bo"]) * 1e3,
            "bound_by": "bytes" if acc["bb"] >= acc["bo"] else "operations",
            **({"bound_unit": acc["unit"]} if acc.get("unit") else {}),
            "library_ms": acc["library_ms"],
            "device_ms": device_ms(device_us, names)})
    return out


# ------------------------------------------------------------ model axis
MA_BATCH, MA_PROMPT, MA_STEPS = 4, 1024, 8
MA_ENC_LEN, MA_DEC_LEN = 1500, 64   # whisper's encoder frames, decoder rows
MA_RTOL, MA_ATOL = 1e-4, 1e-5       # max|Δ| ≤ 1e-4·max|ref| + 1e-5


def ma_close(got, want):
    """(max |Δ|, its bound, within?) of one tensor against its reference."""
    err = (got.float() - want.float()).abs().max().item()
    bound = MA_RTOL * want.float().abs().max().item() + MA_ATOL
    return err, bound, err <= bound


def ma_ranks(cfg, tree, m, body, cache=None):
    """``body(blocks)`` on each rank r < m of a model axis of m, one after
    the other on the card between collectives (`local_ranks.run_ranks`),
    under `rank_context`: ``blocks`` the rank's blocks of ``tree``
    (`shard_params`); ``cache``: the cache's spec tree."""
    from repro_torch.launch.local_ranks import run_ranks
    from repro_torch.models import sharding as SH

    sizes = {"data": 1, "model": m}

    def fn(r, model, data):
        blocks = SH.shard_params(cfg, tree, sizes, ("data",),
                                 {"data": 0, "model": r})
        with SH.rank_context(sizes, ("data",), model, data, batch=MA_BATCH,
                             cache=cache):
            return body(blocks)

    return run_ranks(fn, m)


def ma_compare(name, ranks, want, fields, failed):
    """Every rank's outputs (a list of tensors) against the unsharded
    ones: the worst error and its bound into ``fields``."""
    worst, bound = 0.0, 0.0
    for outs in ranks:
        for got, w in zip(outs, want):
            err, b, ok = ma_close(got, w)
            worst, bound = max(worst, err), max(bound, b)
            if not ok:
                failed.append(f"{name}: {err} > {b}")
    fields[name] = {"max_abs_err": worst, "bound": bound}


def ma_flash(fn):
    """``fn()`` with the flash kernel's calls recorded and its launches
    counted from 0: (result, launches, recorder)."""
    from repro_torch.kernels.flash_attn import kernel as KF

    rec = FlashRecorder()
    reset_flash_launches()
    try:
        out = fn()
    finally:
        rec.close()
    return out, KF.LAUNCHES, rec


def ma_flash_ms(rec):
    """Each recorded call shape's kernel time on its first inputs: [[shape,
    calls, ms]]."""
    from repro_torch.kernels.flash_attn import kernel as KF

    out = []
    for key, n in rec.calls.items():
        q, k, v = rec.inputs[key]
        *_, causal, window = key
        ms = cuda_ms(lambda: KF.flash_attention_bhsd(
            q, k, v, causal=causal, window=window), 5)
        out.append([list(key), n, ms])
    return out


def ma_layer(cfg, shapes, seed):
    """f32 weights of ``shapes`` on the card from ``torch.Generator``."""
    import torch

    from repro_torch.models import transformer as T

    return T.build_params(shapes, cfg, torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")


def ma_cache(cfg, c, slots):
    """The prefill's (b, s, ·) attention cache ``c`` as an L = 1 cache of
    ``slots`` slots: whole, or the rank's blocks under a rank context."""
    from repro_torch.models import transformer as T

    full = T.cache_shapes(cfg, MA_BATCH, slots)["attn"]
    shapes = {"attn": {n: (1, *full[n][1:]) for n in c}}
    specs = T.cache_specs(cfg, shapes, MA_BATCH)
    out = T.zero_cache(shapes, specs, next(iter(c.values())).dtype, "cuda")
    return T.fill_cache(out, {"attn": {n: t[None] for n, t in c.items()}},
                        specs)


def ma_cache_specs(cfg, m, slots):
    """The spec tree of an L = 1 attention cache on a model axis of m."""
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T

    full = T.cache_shapes(cfg, MA_BATCH, slots)["attn"]
    shapes = {"attn": {n: (1, *s[1:]) for n, s in full.items()}}
    return SH.cache_pspecs(cfg, shapes, {"data": 1, "model": m}, ("data",),
                           MA_BATCH)


def ma_attention(cfg, tree, m, x, xs, full_fn, step_fn):
    """Prefill ``full_fn(p, x)`` -> (out, cache), then a decode step
    ``step_fn(p, x_t, cache, pos)`` for each of ``xs``, on one layer:
    unsharded, then on each rank of m. Returns (outputs, its flash
    recorder, each rank's outputs, the ranks' flash launches and
    recorder)."""
    from repro_torch.models import transformer as T

    slots = x.shape[1] + len(xs)

    def run(p):
        out, c = full_fn(p, x)
        cache = ma_cache(cfg, c, slots)
        outs = [out]
        for i, xt in enumerate(xs):
            outs.append(step_fn(p, xt, T.layer(cache["attn"], 0),
                                x.shape[1] + i))
        return outs

    want, _, whole_rec = ma_flash(lambda: run(tree))
    ranks, launches, rec = ma_flash(lambda: ma_ranks(
        cfg, tree, m, run, cache=ma_cache_specs(cfg, m, slots)))
    return want, whole_rec, ranks, launches, rec


def phase_model_axis():
    """Slice E6a on one card: per-rank bodies of the model axis run for
    ranks 0..m-1 one after the other (`local_ranks.run_ranks`: a collective
    combines the ranks' tensors in rank order, as NCCL's would), each at
    full width in f32, held to the unsharded block on the same inputs
    within max|Δ| ≤ 1e-4·max|ref| + 1e-5: (a) qwen2.5-3b's attention
    block and MLP at m = 2 (heads-sharded cache) and m = 4 (k and v
    gathered, the cache's time over the model axis), a 4 × 1,024 prefill
    and 8 decode steps, and the vocab-parallel ``embed`` and ``lm_head``
    at m = 4; (b) deepseek-v2-lite-16b's MLA (prefill, 8 steps of
    `mla_decode` and of `mla_decode_absorbed`, the latent cache's time
    over the model axis) and its MoE FFN (16 experts a rank, the 2
    shared experts a row block) on one input, the routing integers
    equal; (c) zamba2-7b's Mamba2 block (``in_proj`` gathered, the norm
    across ranks, the state's heads) and its shared attention block at
    D 112; (d) whisper-small's encoder layer over 1,500 frames and its
    cross call at m = 4. Each block's flash launches (counted from 0;
    none fails the phase) and the kernel's ms at the rank's head counts
    beside the unsharded call's, on the phase's own lines."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention as A
    from repro_torch.models import encdec as ED
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as SH
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_card()
    t_all = time.perf_counter()
    failed, drains = [], []
    gen = torch.Generator(device="cuda").manual_seed(7)

    def cfg_of(arch):
        return dataclasses.replace(get_config(arch), dtype="float32")

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def report(part, t0, m, want_rec, launches, rec, fields):
        if launches == 0:
            failed.append(f"{part}: no flash launch")
        drains.append(launches)
        emit("model_axis", t0, part=part, model=m, flash_launches=launches,
             flash_rank_calls=ma_flash_ms(rec),
             flash_whole_calls=ma_flash_ms(want_rec) if want_rec else [],
             **fields)

    def attention_block(part, cfg, tree, m, shared=False):
        """One attention block + its MLP, prefill and MA_STEPS steps."""
        t0 = time.perf_counter()
        x = rand(MA_BATCH, MA_PROMPT, cfg.d_model)
        xs = [rand(MA_BATCH, 1, cfg.d_model) for _ in range(MA_STEPS)]
        pos = torch.arange(MA_PROMPT, device="cuda").expand(MA_BATCH, -1)
        key = "shared_attn" if shared else "layers"

        def lp(p):
            return p[key] if shared else T.layer(p[key], 0)

        full = (lambda p, xx: T.attn_block_full(lp(p), cfg, xx, pos)[:2])
        step = (lambda p, xx, c, t: T.attn_block_decode(lp(p), cfg, xx, c,
                                                        t)[0])
        want, whole_rec, ranks, launches, rec = ma_attention(
            cfg, tree, m, x, xs, full, step)
        fields = {}
        ma_compare("prefill_and_decode", ranks, want, fields, failed)
        report(part, t0, m, whole_rec, launches, rec, fields)

    # (a) qwen2.5-3b
    cfg = cfg_of("qwen2.5-3b")
    tree = {"layers": ma_layer(cfg, T.attn_block_shapes(cfg, (1,)), 1)}
    for m in (2, 4):
        attention_block(f"a_qwen2.5-3b_block_m{m}", cfg, tree, m)
    del tree
    t0 = time.perf_counter()
    V = cfg.padded_vocab
    vt = {"embed": rand(V, cfg.d_model) * 0.02,
          "lm_head": rand(cfg.d_model, V) / cfg.d_model ** 0.5,
          "final_norm": torch.ones(cfg.d_model, device="cuda")}
    toks = torch.randint(0, cfg.vocab, (MA_BATCH, MA_PROMPT),
                         generator=gen, device="cuda")
    h = rand(MA_BATCH, 1, cfg.d_model)

    def vocab_body(p):
        return [T.embed_tokens(p["embed"], cfg, toks), T._logits(p, cfg, h)]

    ranks = ma_ranks(cfg, vt, 4, vocab_body)
    fields = {"rows_a_rank": V // 4}
    want = vocab_body(vt)
    ma_compare("embed_and_logits", ranks, want, fields, failed)
    if not all(torch.equal(r[0], want[0]) for r in ranks):
        failed.append("vocab-parallel embed is not exact")
    emit("model_axis", t0, part="a_qwen2.5-3b_vocab_m4", model=4, **fields)
    del vt, ranks, want
    free_card()

    # (b) deepseek-v2-lite-16b: MLA, then the MoE FFN on one input
    cfg = cfg_of("deepseek-v2-lite-16b")
    shapes = T.attn_block_shapes(cfg, (1,))
    tree = {"layers": ma_layer(cfg, {"attn": shapes["attn"]}, 2)}
    for absorbed in (False, True):
        t0 = time.perf_counter()
        c2 = dataclasses.replace(cfg)
        object.__setattr__(c2, "_absorbed_mla", absorbed)
        step_fn = A.mla_decode_absorbed if absorbed else A.mla_decode
        x = rand(MA_BATCH, MA_PROMPT, cfg.d_model)
        xs = [rand(MA_BATCH, 1, cfg.d_model) for _ in range(MA_STEPS)]
        pos = torch.arange(MA_PROMPT, device="cuda").expand(MA_BATCH, -1)
        full = (lambda p, xx: A.mla_full(T.layer(p["layers"], 0)["attn"],
                                         c2, xx, pos))
        step = (lambda p, xx, c, t: step_fn(T.layer(p["layers"], 0)["attn"],
                                            c2, xx, c, t)[0])
        want, whole_rec, ranks, launches, rec = ma_attention(
            c2, tree, 4, x, xs, full, step)
        fields = {}
        ma_compare("prefill_and_decode", ranks, want, fields, failed)
        report("b_deepseek_mla_" + ("absorbed" if absorbed else "expanded")
               + "_m4", t0, 4, whole_rec, launches, rec, fields)
    del tree
    free_card()
    t0 = time.perf_counter()
    tree = {"layers": ma_layer(cfg, {"moe": shapes["moe"]}, 3)}
    xs = [rand(MA_BATCH, MA_PROMPT, cfg.d_model),
          rand(MA_BATCH, 1, cfg.d_model)]
    routes = {}
    orig = MOE.route

    def rec_route(p, c, x):
        r = orig(p, c, x)
        routes.setdefault(threading_name(), []).append(
            (r.top_e, r.slot, int(r.dropped)))
        return r

    MOE.route = rec_route
    try:
        def moe_body(p):
            lp = T.layer(p["layers"], 0)["moe"]
            return [MOE.moe_ffn(lp, cfg, x)[0] for x in xs]

        want = moe_body(tree)
        whole_routes = routes.pop(threading_name())
        ranks = ma_ranks(cfg, tree, 4, moe_body)
    finally:
        MOE.route = orig
    fields = {"experts_a_rank": cfg.moe.n_experts // 4,
              "dropped_pairs": [d for _, _, d in whole_routes]}
    ma_compare("moe_prefill_and_decode", ranks, want, fields, failed)
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for got in routes.values()
               for a, b in zip(got, whole_routes)) and len(routes) == 4
    fields["routing_equal"] = same
    if not same:
        failed.append("deepseek MoE routing differs on a rank")
    emit("model_axis", t0, part="b_deepseek_moe_m4", model=4, **fields)
    del tree, ranks, want
    free_card()

    # (c) zamba2-7b: a Mamba2 block, then the shared attention block
    cfg = cfg_of("zamba2-7b")
    t0 = time.perf_counter()
    tree = {"layers": ma_layer(cfg, {"ln": (1, cfg.d_model),
                                     "mamba": SSM.param_shapes(cfg, (1,))},
                               4)}
    x = rand(MA_BATCH, MA_PROMPT, cfg.d_model)
    xs = [rand(MA_BATCH, 1, cfg.d_model) for _ in range(MA_STEPS)]

    def ssm_body(p):
        lp = T.layer(p["layers"], 0)
        out, c = T.ssm_block_full(lp, cfg, x)
        outs = [out]
        for xt in xs:
            o, c = T.ssm_block_decode(lp, cfg, xt, c)
            outs.append(o)
        return outs

    want = ssm_body(tree)
    ranks = ma_ranks(cfg, tree, 4, ssm_body)
    fields = {"heads_a_rank": SSM.dims(cfg)[1] // 4}
    ma_compare("mamba2_prefill_and_decode", ranks, want, fields, failed)
    emit("model_axis", t0, part="c_zamba2_mamba2_m4", model=4, **fields)
    del tree, ranks, want
    tree = {"shared_attn": ma_layer(cfg, T.attn_block_shapes(cfg), 5)}
    attention_block("c_zamba2_shared_attn_m4", cfg, tree, 4, shared=True)
    del tree
    free_card()

    # (d) whisper-small: one encoder layer, then the cross call
    cfg = dataclasses.replace(cfg_of("whisper-small"), encoder_layers=1)
    t0 = time.perf_counter()
    d = cfg.d_model
    enc_tree = ma_layer(cfg, {"frontend": (d, d), "enc_norm": (d,),
                              "enc_layers": ED.param_shapes(cfg)[
                                  "enc_layers"]}, 6)
    frames = rand(MA_BATCH, MA_ENC_LEN, d)
    xq = rand(MA_BATCH, MA_DEC_LEN, d)
    x1 = rand(MA_BATCH, 1, d)
    xt_tree = {"layers": {"xattn": ma_layer(
        cfg, A.cross_param_shapes(cfg, (1,)), 7)}}

    def enc_body(p):
        return [ED.encode(p, cfg, frames)]

    def cross_body(p):
        lp = T.layer(p["layers"]["xattn"], 0)
        kv = A.cross_precompute(lp, cfg, enc)
        return [A.cross_full(lp, cfg, xq, kv), A.cross_full(lp, cfg, x1, kv)]

    want, _, whole_rec = ma_flash(lambda: enc_body(enc_tree))
    enc = want[0]
    ranks, launches, rec = ma_flash(lambda: ma_ranks(cfg, enc_tree, 4,
                                                     enc_body))
    fields = {}
    ma_compare("encoder_layer", ranks, want, fields, failed)
    report("d_whisper_encoder_m4", t0, 4, whole_rec, launches, rec, fields)
    t0 = time.perf_counter()
    want, _, whole_rec = ma_flash(lambda: cross_body(xt_tree))
    ranks, launches, rec = ma_flash(lambda: ma_ranks(cfg, xt_tree, 4,
                                                     cross_body))
    fields = {}
    ma_compare("cross_prefill_and_decode", ranks, want, fields, failed)
    report("d_whisper_cross_m4", t0, 4, whole_rec, launches, rec, fields)
    del enc_tree, xt_tree, ranks, want, enc
    free_card()
    if failed:
        raise AssertionError(f"model_axis failed: {failed}")
    emit("model_axis", t_all, part="total", flash_launches=sum(drains))


# ------------------------------------------------------ model-axis training
MT_STEP_LAYERS, MT_STEPS = 2, 2  # the AdamW check: qwen2.5-3b cut, steps


def mt_config(arch, **cut):
    """``arch`` in f32 through the chunked twin (the training path), cut
    to ``cut`` (layers), at full width."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.train import train_step as TS

    return TS.train_config(dataclasses.replace(
        get_config(arch), dtype="float32", **cut))


def mt_backward(cfg, tree, loss_fn, inputs, m, routes=None):
    """``loss_fn(params, *inputs)`` and its gradients, unsharded and then
    on each rank of a model axis of m one after the other
    (`local_ranks.run_ranks`) on the rank's blocks of ``tree``: the
    backward seeded with 1/m of the loss and each leaf SUMmed over the
    axes its spec replicates it on (`train_step.reduce_grads`, the train
    step's reduction); the inputs' gradients are the ranks' partials.
    Returns ((loss, leaf grads, input grads) unsharded, [the same per
    rank], the rank coordinates' mesh sizes)."""
    import torch

    from repro_torch.launch.local_ranks import run_ranks
    from repro_torch.models import sharding as SH
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    sizes = {"data": 1, "model": m}
    sums = TS.grad_sums(cfg, sizes, ("data",), tree)

    def grads(params, scale):
        flat = adamw.leaves(params)
        xs = [x.detach().requires_grad_(True) for x in inputs]
        for t in flat:
            t.requires_grad_(True)
        try:
            loss = loss_fn(params, *xs)
            g = torch.autograd.grad(loss * scale, flat + xs,
                                    materialize_grads=True)
        finally:
            for t in flat:
                t.requires_grad_(False)
        return loss.detach(), list(g[:len(flat)]), list(g[len(flat):])

    want = grads(tree, 1.0)

    def fn(r, model, data):
        blocks = SH.shard_params(cfg, tree, sizes, ("data",),
                                 {"data": 0, "model": r})
        with SH.rank_context(sizes, ("data",), model, data):
            loss, g, gx = grads(blocks, 1.0 / m)
            return loss, TS.reduce_grads(g, sums, 1), gx

    return want, run_ranks(fn, m), sizes


def mt_compare(name, cfg, tree, want, ranks, sizes, fields, failed):
    """Each leaf's gradient assembled from the ranks' blocks, and the
    inputs' gradients summed over the ranks, against the unsharded ones
    (`ma_close`'s bound); the ranks' losses against the unsharded loss."""
    import torch

    from repro_torch.models import sharding as SH
    from repro_torch.optim import adamw

    specs = adamw.leaves(SH.param_pspecs(cfg, tree, sizes, ("data",)))
    worst = {}  # kind -> (max |Δ|, its bound) of the worst err / bound

    def check(kind, what, got, w):
        err, bound, ok = ma_close(got, w)
        if kind not in worst or err / bound > worst[kind][0] / worst[kind][1]:
            worst[kind] = (err, bound)
        if not ok:
            failed.append(f"{name} {what}: {err} > {bound}")

    for i, (w, spec) in enumerate(zip(want[1], specs)):
        whole = torch.empty_like(w)
        for r, (_, g, _) in enumerate(ranks):
            whole[SH.local_block(tuple(w.shape), spec, sizes,
                                 {"data": 0, "model": r})] = g[i]
        check("leaf", f"leaf {i}", whole, w)
    for j, w in enumerate(want[2]):
        check("input", f"input {j}", sum(gx[j] for _, _, gx in ranks), w)
    for loss, _, _ in ranks:
        check("loss", "loss", loss, want[0])
    fields[name] = {"leaves": len(specs),
                    **{f"{k}_max_abs_err": v[0] for k, v in worst.items()},
                    **{f"{k}_bound": v[1] for k, v in worst.items()}}


def phase_model_axis_train():
    """Training under a model axis on one card (`phase_model_axis`'s
    per-rank bodies, now forward and backward): at full width in f32,
    4 × 1,024 tokens, each leaf's gradient SUMmed by the train step's
    reduction and assembled from the ranks' blocks, and each input's
    gradient summed over the ranks, held to the unsharded one within
    max|Δ| ≤ 1e-4·max|ref| + 1e-5: (a) qwen2.5-3b cut to one layer with
    its vocabulary-parallel embedding, lm_head and loss (`lm_loss`) at m 2
    and 4; (b) deepseek-v2-lite-16b's MLA block and MoE FFN (+ its aux
    loss) on one input at m 4, the routing integers equal; (c) zamba2-7b
    cut to one Mamba2 layer and its shared block, through `lm_loss`, at
    m 4; (d) whisper-small cut to one encoder and one decoder layer,
    through `lm_loss`, at m 4; (e) qwen2.5-3b cut to 2 layers through 2
    AdamW steps at m 2 (the gradients reduced as the train step reduces
    them, the clipping norm across the ranks by `norm_axes`): the loss,
    grad norm and every parameter equal one device's
    `build_train_step`. No flash launch: training attends through the
    chunked twin."""
    import torch

    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.kernels.flash_attn import kernel as KF
    from repro_torch.models import attention as A
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.api import lm_loss, param_shapes
    from repro_torch.models.layers import rms_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_card()
    t_all = time.perf_counter()
    failed = []
    launches = KF.LAUNCHES
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def batch_of(cfg):
        stream = TokenStream(cfg.vocab, 4, 1024, seed=0)
        return make_batch(cfg, stream, 0, device="cuda")

    def whole_model(part, arch, m, seed, **cut):
        t0 = time.perf_counter()
        cfg = mt_config(arch, **cut)
        tree = ma_layer(cfg, param_shapes(cfg), seed)
        batch = batch_of(cfg)
        want, ranks, sizes = mt_backward(
            cfg, tree, lambda p: lm_loss(p, cfg, batch), (), m)
        fields = {"params": sum(t.numel() for t in tensor_leaves(tree))}
        mt_compare("lm_loss", cfg, tree, want, ranks, sizes, fields, failed)
        del tree, want, ranks
        free_card()
        emit("model_axis_train", t0, part=part, model=m, **cut, **fields)

    # (a) qwen2.5-3b: one layer, the vocabulary-parallel ends and the loss
    for m in (2, 4):
        whole_model(f"a_qwen2.5-3b_m{m}", LM_ARCH, m, 1, n_layers=1)

    # (b) deepseek-v2-lite-16b: the MLA block, then the MoE FFN
    t0 = time.perf_counter()
    cfg = mt_config(MLA_MOE_ARCH)
    shapes = T.attn_block_shapes(cfg, (1,))
    x = rand(4, 1024, cfg.d_model)
    dy = rand(4, 1024, cfg.d_model)
    pos = torch.arange(1024, device="cuda").expand(4, -1)
    tree = ma_layer(cfg, {"layers": {"ln1": shapes["ln1"],
                                     "attn": shapes["attn"]}}, 2)

    def mla_loss(p, xx):
        lp = T.layer(p["layers"], 0)
        out, _ = A.mla_full(lp["attn"], cfg, rms_norm(xx, lp["ln1"],
                                                      cfg.norm_eps), pos)
        return (out * dy).sum()

    want, ranks, sizes = mt_backward(cfg, tree, mla_loss, (x,), 4)
    fields = {}
    mt_compare("mla_block", cfg, tree, want, ranks, sizes, fields, failed)
    del tree, want, ranks
    tree = ma_layer(cfg, {"layers": {"moe": shapes["moe"]}}, 3)
    routes = {}
    orig = MOE.route

    def rec_route(p, c, xx):
        r = orig(p, c, xx)
        routes.setdefault(threading_name(), []).append((r.top_e, r.slot))
        return r

    def moe_loss(p, xx):
        out, aux = MOE.moe_ffn(T.layer(p["layers"], 0)["moe"], cfg, xx)
        return (out * dy).sum() + 0.01 * aux

    MOE.route = rec_route
    try:
        want, ranks, sizes = mt_backward(cfg, tree, moe_loss, (x,), 4)
    finally:
        MOE.route = orig
    mt_compare("moe_ffn", cfg, tree, want, ranks, sizes, fields, failed)
    mine = routes.pop(threading_name())
    same = len(routes) == 4 and all(
        len(got) == len(mine) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(got, mine)) for got in routes.values())
    if not same:
        failed.append("deepseek MoE routing differs on a rank")
    fields["routing_equal"] = same
    fields["experts_a_rank"] = cfg.moe.n_experts // 4
    del tree, want, ranks, x, dy
    free_card()
    emit("model_axis_train", t0, part="b_deepseek_mla_moe_m4", model=4,
         **fields)

    # (c) zamba2-7b: one Mamba2 layer and the shared block; (d) whisper
    whole_model("c_zamba2-7b_m4", HYBRID_ARCH, 4, 4, n_layers=1)
    whole_model("d_whisper-small_m4", ENCDEC_ARCH, 4, 5, n_layers=1,
                encoder_layers=1)

    # (e) two AdamW steps of qwen2.5-3b cut to 2 layers at m 2
    t0 = time.perf_counter()
    fields = mt_steps(failed)
    emit("model_axis_train", t0, part="e_qwen2.5-3b_adamw_m2", model=2,
         n_layers=MT_STEP_LAYERS, **fields)
    free_card()
    if KF.LAUNCHES != launches:
        failed.append(f"{KF.LAUNCHES - launches} flash launches in training")
    if failed:
        raise AssertionError(f"model_axis_train failed: {failed}")
    emit("model_axis_train", t_all, part="total")


def mt_steps(failed):
    """`MT_STEPS` AdamW steps (warmup 1: the second moves the weights) of
    qwen2.5-3b cut to `MT_STEP_LAYERS` layers, by one device's
    `build_train_step` and by per-rank bodies at m 2 — `loss_and_grads`
    on the rank's blocks, `reduce_grads`, `adamw.apply_updates` with the
    clipping norm over the ranks (`norm_axes`) — their losses, grad
    norms and parameters after the steps compared."""
    import torch

    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.launch.local_ranks import run_ranks
    from repro_torch.models import sharding as SH
    from repro_torch.models.api import param_shapes
    from repro_torch.optim import adamw, schedules
    from repro_torch.train import train_step as TS

    cfg = mt_config(LM_ARCH, n_layers=MT_STEP_LAYERS)
    tree = ma_layer(cfg, param_shapes(cfg), 6)
    plan = TS.TrainPlan(cfg=cfg, warmup=1, total_steps=10)
    sizes = {"data": 1, "model": 2}
    blocks = [SH.shard_params(cfg, tree, sizes, ("data",),
                              {"data": 0, "model": r}) for r in range(2)]
    stream = TokenStream(cfg.vocab, 4, 1024, seed=0)
    batches = [make_batch(cfg, stream, s, device="cuda")
               for s in range(MT_STEPS)]
    state = TS.init_state(tree, plan.opt)
    step = TS.build_train_step(plan)
    want = []
    for b in batches:
        state, met = step(state, b)
        want.append({k: float(v) for k, v in met.items()})
    sums = TS.grad_sums(cfg, sizes, ("data",))
    held = TS.norm_axes(cfg, sizes, ("data",))

    def fn(r, model, data):
        st = TS.init_state(blocks[r], plan.opt)
        out = []
        with SH.rank_context(sizes, ("data",), model, data):
            lay = SH.layout()
            norms = [lay.axis(a) if a else None for a in held]
            for b in batches:
                loss, flat = TS.loss_and_grads(st["params"], cfg, b)
                flat = TS.reduce_grads(flat, sums, 1)
                lr = schedules.cosine_with_warmup(
                    st["opt"]["step"], warmup=plan.warmup,
                    total=plan.total_steps)
                met = adamw.apply_updates(
                    st["params"], adamw.unflatten(st["params"], flat),
                    st["opt"], plan.opt, lr, norm_axes=norms)
                out.append({"loss": float(loss), **{
                    k: float(v) for k, v in met.items()}})
        return out

    ranks = run_ranks(fn, 2)
    fields = {"losses": [w["loss"] for w in want],
              "grad_norms": [w["grad_norm"] for w in want],
              "rank_metrics": ranks[0]}
    for got in ranks:
        for g, w in zip(got, want):
            for k in ("loss", "grad_norm", "lr"):
                err, bound, ok = ma_close(torch.tensor(g[k]),
                                          torch.tensor(w[k]))
                if not ok:
                    failed.append(f"adamw step {k}: {err} > {bound}")
    specs = adamw.leaves(SH.param_pspecs(cfg, param_shapes(cfg), sizes,
                                         ("data",)))
    worst, bound_at = 0.0, 1.0
    for i, (w, spec) in enumerate(zip(adamw.leaves(state["params"]), specs)):
        whole = torch.empty_like(w)
        for r in range(2):
            whole[SH.local_block(tuple(w.shape), spec, sizes,
                                 {"data": 0, "model": r})] = \
                adamw.leaves(blocks[r])[i]
        err, bound, ok = ma_close(whole, w)
        if err / bound >= worst / bound_at:
            worst, bound_at = err, bound
        if not ok:
            failed.append(f"adamw step leaf {i}: {err} > {bound}")
    fields.update(param_max_abs_err=worst, param_bound=bound_at)
    return fields


# ------------------------------------------------------------------ tooling
TOOLING_GRAPH = (2000, 11, 0.03)  # caveman(n_cliques, size, rewire), seed 0


def tooling_baselines():
    """The flat baselines of tooling (a) on the host (`core.baselines`:
    SWEG at T=20, RANDOMIZED, SAGS-like; seed 0, the reference's
    defaults) on `TOOLING_GRAPH`: each summary's losslessness, relative
    size, cost and seconds. Runs in a worker process beside the card's
    phases (`phase_tooling_compactness`)."""
    from repro_torch.core import baselines as BL
    from repro_torch.graphs import generators as GG

    graph = GG.caveman(*TOOLING_GRAPH, seed=0)
    out = {}
    for name, fn in (("sweg", lambda: BL.sweg(graph, T=20, seed=0)),
                     ("randomized", lambda: BL.randomized(graph, seed=0)),
                     ("sags_like", lambda: BL.sags_like(graph, seed=0))):
        tw = time.perf_counter()
        summ = fn()
        secs = time.perf_counter() - tw
        out[name] = {"lossless": bool(summ.validate_lossless(graph)),
                     "relative_size": summ.relative_size(graph),
                     "cost": summ.cost(), "seconds": secs}
    return out


def phase_tooling_compactness():
    """Tooling (a), the paper's compactness comparison on
    ``caveman(2000, 11, 0.03, seed=0)`` (109,997 edges): the flat
    baselines start on the host in a worker process (`tooling_baselines`,
    ≈ 20 s of one core, off the card's path), SLUGGER runs through
    `summarize(T=20, backend="resident")` on the card, launch counts from
    0 (top-J and fold must launch). Returns what `finish_tooling_
    compactness` gates and prints once the LM phases have run."""
    import concurrent.futures
    import multiprocessing

    import torch

    import repro_torch
    from repro_torch.graphs import generators as GG

    t0 = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    future = pool.submit(tooling_baselines)
    graph = GG.caveman(*TOOLING_GRAPH, seed=0)
    reset_launches()
    tw = time.perf_counter()
    ours = repro_torch.summarize(graph, T=20, backend="resident",
                                 device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - tw
    launches = read_launches()
    for name in ("jaccard_topj", "bitset_fold"):
        if launches[name] <= 0:
            raise AssertionError(f"tooling: the resident summary never "
                                 f"launched {name}")
    if not ours.validate_lossless(graph):
        raise AssertionError("tooling: the resident summary does not "
                             "decompress to the input graph")
    return {"pool": pool, "future": future, "seconds": time.perf_counter()
            - t0, "graph": {"n": graph.n, "m": graph.m},
            "launches": launches,
            "slugger_resident": {"lossless": True,
                                 "relative_size": ours.relative_size(graph),
                                 "cost": ours.cost(), "seconds": secs}}


def finish_tooling_compactness(pending):
    """Tooling (a)'s end: wait for the baselines' worker, stop it, gate
    every summary lossless and print each method's relative size and
    seconds (the baselines' on one host core beside the card's phases)."""
    t0 = time.perf_counter()
    try:
        methods = {"slugger_resident": pending["slugger_resident"],
                   **pending["future"].result(timeout=600)}
    finally:
        pending["pool"].shutdown(wait=True, cancel_futures=True)
    for name, m in methods.items():
        if not m["lossless"]:
            raise AssertionError(f"tooling: the {name} summary does not "
                                 f"decompress to the input graph")
    emit("tooling", t0, part="a_compactness", card=card_line(),
         slugger_phase_seconds=pending["seconds"], graph=pending["graph"],
         launches=pending["launches"], methods=methods)


def phase_tooling_counts(lm):
    """Tooling (b): one bf16 prefill of qwen2.5-3b at full width, of a
    batch as `lm_serve` shapes it (``LM_SLOTS`` prompts of
    ``LM_PROMPT_LEN`` tokens, int32), on `lm_serve`'s weights, through the
    dry run's step (`launch.dryrun.step_of` on a one-rank world) on the
    card, counted by `launch.step_analysis.analyze_step`. Its FLOPs, bytes
    and flash work must equal, exactly, the dry run of the same (cfg,
    batch, length) on meta, and the count's flash launches the kernel's
    own counter. The step is then timed without the counter (median of 3
    after a warm-up), beside the roofline's terms of the count — bounds
    from the H100 data sheet, not measurements."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attn import kernel as KF
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dp_axes_of, make_host_mesh
    from repro_torch.launch.step_analysis import analyze_step

    t0 = time.perf_counter()
    RL = roofline()
    server = lm["server"]
    cfg, params = server.cfg, server.params
    shape = ShapeConfig("lm_serve_prefill", LM_PROMPT_LEN, LM_SLOTS,
                        "prefill")
    toks = torch.from_numpy(np.stack(lm["prompts"][:LM_SLOTS])).to(
        device="cuda", dtype=torch.int32)
    with dryrun.fake_world(1):
        mesh = make_host_mesh(1, 1)
        fn, args = dryrun.step_of(cfg, shape, mesh, dp_axes_of(mesh),
                                  device="cuda", params=params,
                                  inputs={"tokens": toks})
        before = KF.LAUNCHES
        with torch.no_grad():
            card = analyze_step(fn, *args)
        torch.cuda.synchronize()
        launched = KF.LAUNCHES - before
        times = []
        with torch.no_grad():
            for _ in range(4):
                tw = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - tw)
    del card["out"]
    meta = dryrun.count_one_rank(cfg, shape)
    flash = card["kernels"].get("flash_attention", {})
    for key in ("flops", "bytes", "kernels"):
        if card[key] != meta[key]:
            raise AssertionError(f"tooling: the card's prefill counts {key} "
                                 f"{card[key]}, the dry run on meta "
                                 f"{meta[key]}")
    if flash.get("launches") != launched or launched != cfg.n_layers:
        raise AssertionError(f"tooling: {launched} flash launches on the "
                             f"card, the count says {flash}, the model has "
                             f"{cfg.n_layers} layers")
    rl = RL.from_counts(LM_ARCH, shape.name, "one_card", 1, card, cfg, shape,
                        card["peak_bytes"])
    measured = statistics.median(times[1:])
    emit("tooling", t0, part="b_counts", card=card_line(), arch=LM_ARCH,
         batch=LM_SLOTS, seq=LM_PROMPT_LEN, flops=card["flops"],
         bytes=card["bytes"], flash=flash, equal_on_meta=True,
         ops_counted=sum(card["ops"].values()),
         measured_seconds=measured, measured_runs=times,
         bound_note="t_* and roofline_fraction: H100 data-sheet bounds "
                    "(roofline.py), not measurements",
         t_compute=rl.t_compute, t_memory=rl.t_memory,
         roofline_fraction=rl.roofline_fraction,
         model_flops=rl.model_flops, bound_over_measured=max(
             rl.t_compute, rl.t_memory) / measured,
         traced_peak_bytes=card["peak_bytes"],
         meta_step_seconds=meta["step_s"])


def tooling_memory(cfg, state):
    """Tooling (c), inside `train_whole` while its state lives:
    `memory_model.analytic_hbm` of qwen2.5-3b at `lm_train`'s shape on
    one card, the whole batch one microbatch as the step runs it; its
    ``params`` and ``opt_moments`` must equal the bytes of
    the real state's tensors exactly. ``grads_f32``, the total and the dry
    run's ``traced_peak_bytes`` (the same train step on meta on a one-rank
    world) are printed beside `torch.cuda.max_memory_allocated()`: a
    report, not a gate."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.memory_model import analytic_hbm

    t0 = time.perf_counter()
    shape = ShapeConfig("lm_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    hbm = analytic_hbm(cfg, shape, {"data": 1, "model": 1}, ("data",),
                       microbatch=TRAIN_BATCH)
    opt = state["opt"]
    real = {"params": sum(t.numel() * t.element_size()
                          for t in tensor_leaves(state["params"])),
            "opt_moments": sum(t.numel() * t.element_size()
                               for part in (opt["m"], opt["v"])
                               for t in tensor_leaves(part))}
    for key, got in real.items():
        if hbm[key] != got:
            raise AssertionError(f"tooling: analytic_hbm {key} {hbm[key]}, "
                                 f"the state's tensors hold {got} bytes")
    meta = dryrun.count_one_rank(cfg, shape)
    emit("tooling", t0, part="c_memory", card=card_line(), arch=LM_ARCH,
         analytic_hbm=hbm, state_bytes=real,
         traced_peak_bytes=meta["peak_bytes"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         meta_step_seconds=meta["step_s"])


# ------------------------------------------------------------------ examples
def load_example(name: str):
    """``examples/torch_<name>.py`` as a module, its ``main`` not run."""
    import importlib.util

    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, argv):
    """``mod.main(argv)`` with its standard output captured: (what it
    returned, what it printed)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = mod.main(argv)
    return result, out.getvalue()


def printed_lines(text: str) -> list:
    """An example's printed results: the engine's log lines dropped, the
    seconds masked."""
    import re

    return [re.sub(r"\d+\.\d+s\b", "<s>", ln) for ln in text.splitlines()
            if not ln.startswith("[repro")]


def graph_example_matches_cpu(name, mod, result, text):
    """Raises unless the graph script ``name``'s card run (``result``, and
    ``text``, what it printed) equals its run with ``--device cpu``: the
    same summary bit for bit, the same BFS order and PageRank, the same
    printed results. The MoE script's graph comes from its router on
    weights the card's generator drew (the CPU's draws others), so the
    card's summary of that graph is held to the CPU's summary of it, and
    to the graph itself. Returns the CPU's seconds."""
    import numpy as np

    from repro_torch.core import summarize

    t0 = time.perf_counter()
    if name == "moe_routing_graph":
        _, graph, card = result
        cpu = summarize(graph, T=10, seed=0, device="cpu")
        same = same_summary(card, cpu) and card.validate_lossless(graph)
    else:
        cpu, cpu_text = run_example(mod, ["--device", "cpu"])
        same = printed_lines(text) == printed_lines(cpu_text)
        if name == "quickstart":
            same = same and same_summary(result, cpu)
        else:
            (card, order, pr), (cpu, cpu_order, cpu_pr) = result, cpu
            same = (same and same_summary(card, cpu) and order == cpu_order
                    and np.array_equal(pr, cpu_pr))
    if not same:
        raise AssertionError(f"examples: torch_{name} on the card is not "
                             f"its run on the CPU")
    return time.perf_counter() - t0


def phase_examples():
    """Slice H: each of `EXAMPLE_SCRIPTS` through its ``main([])`` — the
    user's command line, on the card — with every kernel's count set to 0
    just before it and read just after; its output is captured and its
    last lines printed on the script's own line. Gates: each graph script
    equal to its CPU run (`graph_example_matches_cpu`), the quickstart
    and the query script through the intersection and histogram kernels;
    the serving script through flash, each call shape flash received
    held to the plain version on its recorded inputs (`flash_error`); the
    training script with no flash launch (it raises itself unless its
    loss fell)."""
    import torch

    t_phase = time.perf_counter()
    for name in EXAMPLE_SCRIPTS:
        mod = load_example(name)
        recorder = FlashRecorder() if name == "serve_lm" else None
        reset_launches(LAUNCH_COUNTERS)
        t0 = time.perf_counter()
        try:
            result, text = run_example(mod, [])
            torch.cuda.synchronize()
        finally:
            if recorder is not None:
                recorder.close()
        seconds = time.perf_counter() - t0
        launches = read_launches(LAUNCH_COUNTERS)
        checks = {}
        if name in ("quickstart", "summarize_and_query", "moe_routing_graph"):
            checks["cpu_seconds"] = graph_example_matches_cpu(
                name, mod, result, text)
            checks["equal_to_cpu"] = True
        if name in ("quickstart", "summarize_and_query"):
            for kernel in ("bitset_intersections", "segment_histogram"):
                if launches[kernel] <= 0:
                    raise AssertionError(f"examples: torch_{name} never "
                                         f"launched {kernel}")
        if name == "serve_lm":
            checks["requests"] = len(result)
            flash = launches["flash_attention"]
            if flash <= 0 or flash != sum(recorder.calls.values()):
                raise AssertionError(
                    f"examples: torch_serve_lm launched flash {flash} "
                    f"times, its wrapper saw {dict(recorder.calls)}")
            checks["flash_calls"] = [[*k, c]
                                     for k, c in recorder.calls.items()]
            checks["flash_max_abs_err"] = max(
                flash_error(*recorder.inputs[key], *key[-2:])
                for key in recorder.calls)
        if name == "train_lm":
            checks["loss_first_last"] = [result[0], result[-1]]
            if launches["flash_attention"]:
                raise AssertionError("examples: torch_train_lm launched "
                                     "flash attention in training")
        emit("examples", t0, script=f"examples/torch_{name}.py",
             run_seconds=seconds, launches=launches, checks=checks,
             printed=text.splitlines()[-3:])
    emit("examples", t_phase, part="total", card=card_line(),
         scripts=len(EXAMPLE_SCRIPTS))


def threading_name():
    import threading

    return threading.current_thread().name


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke.py: no src/repro_torch beside {ROOT}; run it from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card visible to torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.graphs import generators as GG

    t_all = time.perf_counter()
    rng = np.random.default_rng(0)
    dev, smi, rates = phase_device()
    phase_build()
    phase_kernels(rng, rates)
    t0 = time.perf_counter()
    graph = GG.caveman(20000, 11, 0.03, seed=0)
    emit("graph", t0, n=graph.n, m=graph.m)
    summary, launches, recorder, main_wall = phase_main(graph)
    rmat, rmat_batched = phase_parity(graph, summary)
    res_launches, res_recorder, res_stages = phase_resident(
        graph, summary, rmat, rmat_batched)
    phase_partitioned(graph, summary, res_stages)
    phase_faults(graph, summary, res_launches)
    ps, queries, serve_calls, serve_launches = phase_serve(
        graph, summary, "caveman_1.1M")
    rmat_ps, rmat_queries, rmat_calls, rmat_launches = phase_serve(
        rmat, rmat_batched, "rmat_14_8")
    shingles = phase_shingles(graph, rmat)
    compactness = phase_tooling_compactness()
    lm = phase_lm_serve()
    phase_tooling_counts(lm)
    finish_tooling_compactness(compactness)
    device_us = phase_trace(graph, "batched")
    device_us.update(phase_trace(graph, "resident", top=16))
    device_us.update(phase_trace_serving(
        [(ps, queries), (rmat_ps, rmat_queries)], shingles))
    lm["device_us"] = phase_trace_lm(lm)
    del lm["server"]  # qwen2.5-3b's 6.8 GB leave the card before deepseek's
    free_card()
    mla_moe = phase_lm_mla_moe()
    ssm_encdec = phase_lm_ssm_encdec()
    vlm = phase_lm_vlm()
    train = phase_lm_train()
    phase_multi_device(graph, summary, main_wall, launches, res_stages,
                       res_launches, train)
    phase_model_axis()
    phase_model_axis_train()
    phase_examples()
    t0 = time.perf_counter()
    record = kernel_record(recorder, launches, res_recorder, res_launches,
                           rng, device_us, rates)
    record += serving_kernel_record(serve_calls + rmat_calls,
                                    serve_launches + rmat_launches, shingles,
                                    device_us, rates)
    record += flash_record([lm, mla_moe, *ssm_encdec, vlm])
    emit("record", t0, total_seconds=time.perf_counter() - t_all)
    print(smi, flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
