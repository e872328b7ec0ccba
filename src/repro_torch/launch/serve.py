"""Batched LM serving driver: fixed-slot batches of prefill + greedy
decode, and the request-slot helpers shared with the summary-query server
(`launch/summary_serve.py`).

    python -m repro_torch.launch.serve --arch qwen2.5-3b [--smoke] [--device cpu]

runs on the CUDA card unless ``--device cpu`` is given; ``--arch`` takes
the decoder-only configurations: dense, MoE (``qwen3-moe-235b-a22b``, and
``deepseek-v2-lite-16b`` with MLA, which fits one H100 whole in bf16),
SSM (``mamba2-130m``) and hybrid (``zamba2-7b``). Prefill attends through
the CUDA flash kernel (``attn_impl="pallas_flash"``, the port's default;
MLA's at q/k width 192 and v width 128; zamba2's shared block at head dim
112), decode through the plain `_sdpa`. The server passes tokens only, as
the reference's does: an encoder-decoder (``whisper-small``) is driven
through ``get_api(cfg).prefill`` and ``decode_step`` with its frames, a
VLM (``internvl2-26b``) the same way with its patch embeddings
(``{"tokens", "embeds"}``, a cache of ``n_patches`` + prompt + generated
slots, decode from position ``n_patches`` + prompt).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models.api import get_api


def mask_pad_logits(cfg, logits):
    """Logits of the embedding table's padding columns set to ``-1e30``."""
    if cfg.padded_vocab != cfg.vocab:
        cols = torch.arange(cfg.padded_vocab, device=logits.device)
        return torch.where(cols < cfg.vocab, logits, -1e30)
    return logits


def pad_to_slots(chunk: list, slots: int) -> list:
    """Pad a request chunk to exactly ``slots`` entries by repeating the last
    one (fixed-slot batching needs a full batch; duplicates are discarded by
    the caller). Raises on an empty chunk — there is nothing to repeat."""
    if not chunk:
        raise ValueError("cannot pad an empty chunk")
    return list(chunk) + [chunk[-1]] * (slots - len(chunk))


class RequestError:
    """Per-request failure record returned IN PLACE of an answer.

    A malformed request (or one cut off by a batch timeout) must not kill
    the whole drain loop — the server answers everything else and marks the
    failed slot with one of these, keeping submission-order alignment."""

    __slots__ = ("request", "reason")

    def __init__(self, request, reason: str):
        self.request = request
        self.reason = str(reason)

    def __repr__(self):
        return f"RequestError({self.request!r}, {self.reason!r})"


class BatchServer:
    """Fixed-slot batching: requests fill ``batch_slots`` slots; each batch
    is one prefill and then one batched greedy decode step per generated
    token. ``device=None`` means the CUDA card, which must exist;
    ``params`` must live on the server's device."""

    def __init__(self, cfg, params, batch_slots=4, max_len=64, device=None):
        self.cfg, self.params = cfg, params
        self.device = resolve_device(device)
        self.api = get_api(cfg)
        self.B, self.S = batch_slots, max_len
        self.decode = (lambda p, c, t, pos:
                       self.api.decode_step(p, cfg, c, t, pos))

    def _invalid_reason(self, arr: np.ndarray, ref_len):
        if arr.ndim != 1 or arr.size == 0:
            return "prompt must be a non-empty 1-D token array"
        if arr.dtype.kind not in "iu":
            return f"prompt dtype {arr.dtype} is not integer"
        if int(arr.min()) < 0 or int(arr.max()) >= self.cfg.vocab:
            return f"token ids out of range [0, {self.cfg.vocab})"
        if ref_len is not None and arr.size != ref_len:
            return f"prompt length {arr.size} != batch length {ref_len}"
        return None

    def run(self, prompts: list, gen_tokens: int = 16, greedy=True, seed=0,
            timeout: float | None = None):
        """prompts: list of 1-D int arrays (equal length for simplicity).

        Answers (int32 arrays of ``gen_tokens`` greedy tokens) come back
        in submission order. A malformed prompt (wrong rank/dtype/length,
        out-of-vocab tokens) gets a `RequestError` in its slot instead of
        poisoning the whole drain loop. With ``timeout`` (wall-clock
        seconds) the loop stops starting new batches once the deadline
        passes — at least one batch always runs, finished answers are
        flushed, and the cut-off slots are marked with timeout
        `RequestError`\\ s."""
        if not prompts:  # nothing queued: don't pad (chunk[-1] of []) or decode
            return []
        with tracing.span("serve.run"):
            return self._run(prompts, gen_tokens, timeout)

    def _run(self, prompts, gen_tokens, timeout):
        cfg = self.cfg
        out: list = [None] * len(prompts)
        valid: list = []
        ref_len = None
        with tracing.span("serve.validate"):
            for i, p in enumerate(prompts):
                arr = np.asarray(p)
                reason = self._invalid_reason(arr, ref_len)
                if reason is not None:
                    out[i] = RequestError(p, reason)
                    continue
                ref_len = arr.size
                valid.append((i, arr))
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        started, slots = False, 0
        for c0 in range(0, len(valid), self.B):
            # the first batch always runs — a timeout bounds extra batches,
            # it never starves the queue of all progress
            if started and deadline is not None \
                    and time.perf_counter() >= deadline:
                break
            chunk = valid[c0 : c0 + self.B]
            with tracing.span("serve.upload"):
                toks = torch.from_numpy(np.stack(
                    [a for _, a in pad_to_slots(chunk, self.B)]).astype(
                        np.int64)).to(self.device)
            plen = toks.shape[1]
            with tracing.span("serve.prefill"):
                logits, cache = self.api.prefill(
                    self.params, cfg, {"tokens": toks},
                    cache_len=plen + gen_tokens)
            with tracing.span("serve.sample"):
                cur = torch.argmax(mask_pad_logits(cfg, logits[:, -1]),
                                   dim=-1)[:, None]
            gen = [cur]
            for g in range(gen_tokens - 1):
                with tracing.span("serve.decode"):
                    logits, cache = self.decode(self.params, cache, cur,
                                                plen + g)
                    lg = mask_pad_logits(
                        cfg, logits[:, -1] if logits.dim() == 3 else logits)
                    cur = torch.argmax(lg, dim=-1).reshape(-1, 1)
                gen.append(cur)
            with tracing.span("serve.readback"):
                seqs = torch.cat(gen, dim=1).to(torch.int32).cpu().numpy()
            for j, (i, _) in enumerate(chunk):
                out[i] = seqs[j]
            started, slots = True, slots + self.B
        tracing.add("requests", len(prompts))
        tracing.add("rejected", len(prompts) - len(valid))
        tracing.add("slots", slots)
        for i, p in enumerate(prompts):
            if out[i] is None:
                out[i] = RequestError(
                    p, f"batch timed out after {timeout:.3f}s; "
                       f"partial results flushed")
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    api = get_api(cfg)
    params = api.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    server = BatchServer(cfg, params, device=device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=args.prompt_len)
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = server.run(prompts, gen_tokens=args.gen)
    dt = time.perf_counter() - t0
    total = args.requests * args.gen
    print(f"[serve] {args.requests} requests × {args.gen} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s) on {device}")
    for i, o in enumerate(outs[:3]):
        print(f"  req{i}: {o.tolist()}")
    return outs


if __name__ == "__main__":
    main()
