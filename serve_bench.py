#!/usr/bin/env python3
"""Time one checkout's one-card LM serving at `chip_smoke.py`'s LM
phases' shapes, so that two checkouts can be compared in one call, on
one card, in turns:

    python3 serve_bench.py --src /path/to/parent/src --label parent
    python3 serve_bench.py --label change      # this checkout's src/

Each model at full width and depth in bf16 (random weights from
`torch.Generator(seed=0)`): qwen2.5-3b, deepseek-v2-lite-16b,
mamba2-130m, zamba2-7b, whisper-small (1,500 frame embeddings, 64-token
prompts) and internvl2-26b (1,024 patch embeddings before the text). 16
requests of 1,024 prompt tokens (whisper: 64) in batches of 8, each
batch one `api.prefill` and 31 greedy `api.decode_step`s, every step
ending in a synchronize (its first token read on the host), as the
phases' drains do. Each run builds that checkout's kernels (its own
`build/`), prints the card's name and power limit, then one JSON line a
model: prefill tokens/s, decode ms a step (mean and median over the
steps), and the decode steps' host share: the part of a step's wall
before the host starts to wait for its token (the rest is the card
finishing what the host queued). Each model's timed drain follows one
untimed prefill and decode step of its first batch (the kernels' build,
cuBLAS's set-up). Only the models' public API is called, so any
checkout of the port since these families were added can be timed.
Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "mamba2-130m", "zamba2-7b",
         "whisper-small", "internvl2-26b")
PROMPTS, SLOTS, PROMPT_LEN, GEN = 16, 8, 1024, 32
ENC_LEN, ENC_PROMPT_LEN = 1500, 64


def inputs(cfg, torch, gen):
    """(prompts (16, plen) on the card, the batch's other entries, the
    positions before the prompt)."""
    if cfg.encoder_layers:
        frames = torch.randn((PROMPTS, ENC_LEN, cfg.d_model), generator=gen,
                             device="cuda")
        toks = torch.randint(0, cfg.vocab, (PROMPTS, ENC_PROMPT_LEN),
                             generator=gen, device="cuda")
        return toks, {"frames": frames}, 0
    if cfg.n_patches:
        from repro_torch.data.pipeline import TokenStream, make_batch

        batch = make_batch(cfg, TokenStream(cfg.vocab, PROMPTS, PROMPT_LEN),
                           0, device="cuda")
        return (batch["tokens"][:, :PROMPT_LEN], {"embeds": batch["embeds"]},
                cfg.n_patches)
    toks = torch.randint(0, cfg.vocab, (PROMPTS, PROMPT_LEN), generator=gen,
                         device="cuda")
    return toks, {}, 0


def drain(api, cfg, params, toks, extra, offset, torch):
    """Batches of `SLOTS`: one prefill, ``GEN − 1`` greedy decode steps,
    after an untimed prefill and step. Returns (prefill walls, decode
    walls, decode host walls)."""
    from repro_torch.launch.serve import mask_pad_logits

    t, batch = toks[:SLOTS], {k: v[:SLOTS] for k, v in extra.items()}
    plen = offset + t.shape[1]
    _, cache = api.prefill(params, cfg, {**batch, "tokens": t},
                           cache_len=plen + GEN)
    api.decode_step(params, cfg, cache, t[:, :1], plen)
    del cache
    pre, dec, host = [], [], []
    for c0 in range(0, PROMPTS, SLOTS):
        t = toks[c0:c0 + SLOTS]
        batch = {k: v[c0:c0 + SLOTS] for k, v in extra.items()}
        plen = offset + t.shape[1]
        torch.cuda.synchronize()
        ts = time.perf_counter()
        logits, cache = api.prefill(params, cfg, {**batch, "tokens": t},
                                    cache_len=plen + GEN)
        cur = torch.argmax(mask_pad_logits(cfg, logits[:, -1]),
                           dim=-1)[:, None]
        cur.cpu()
        pre.append(time.perf_counter() - ts)
        for g in range(GEN - 1):
            ts = time.perf_counter()
            logits, cache = api.decode_step(params, cfg, cache, cur, plen + g)
            cur = torch.argmax(mask_pad_logits(cfg, logits[:, -1]),
                               dim=-1)[:, None]
            th = time.perf_counter()
            cur.cpu()
            te = time.perf_counter()
            dec.append(te - ts)
            host.append(th - ts)
    return pre, dec, host


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the `src` directory of the checkout to time")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"serve_bench.py: no repro_torch under {src}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("serve_bench.py: no CUDA card visible to torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_api

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    for arch in ARCHS:
        cfg = get_config(arch)
        api = get_api(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = api.init_params(cfg, gen, device="cuda")
        toks, extra, offset = inputs(cfg, torch, gen)
        with torch.no_grad():
            pre, dec, host = drain(api, cfg, params, toks, extra, offset,
                                   torch)
        print(json.dumps({
            "label": args.label, "src": str(src), "arch": arch,
            "layers": cfg.n_layers, "prompts": PROMPTS,
            "prompt_len": toks.shape[1], "gen": GEN,
            "prefill_tokens_per_s": PROMPTS * (offset + toks.shape[1])
            / sum(pre),
            "ttft_seconds": pre,
            "decode_ms_per_step": 1e3 * sum(dec) / len(dec),
            "decode_ms_median": 1e3 * statistics.median(dec),
            "decode_host_share": sum(host) / sum(dec),
            "decode_steps": len(dec)}), flush=True)
        del params, toks, extra
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
