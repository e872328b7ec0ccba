#!/usr/bin/env python3
"""Time one checkout's flash-attention kernel on one CUDA card at
`chip_smoke.py`'s fixed shapes (`FLASH_SHAPES`; a shape with v narrower
than q and k is skipped for a checkout whose kernel does not take it), so
that two checkouts can be compared in one call, on one card, in turns:

    python3 flash_bench.py --src /path/to/parent/src --label parent
    python3 flash_bench.py --label change      # this checkout's src/

Each run builds that checkout's kernels (its own `build/`), and prints
the card's name and power limit, then one JSON line per shape: the mean
milliseconds of `flash_attention_bhsd` over ``--reps`` calls by CUDA
events after a warm-up call, and SDPA's beside it. The inputs are drawn
as in `chip_smoke.py` (`numpy.random.default_rng(0)`). Only the public
wrapper is called, so any checkout of the port since the kernel was
added can be timed. Without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _takes_v_width(KF, q, k, v) -> bool:
    """Whether this checkout's wrapper takes v narrower than q and k."""
    try:
        KF.flash_attention_bhsd(q, k, v)
    except ValueError:
        return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the `src` directory of the checkout to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"flash_bench.py: no repro_torch under {src}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("flash_bench.py: no CUDA card visible to torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    import chip_smoke as CS
    from repro_torch.kernels.flash_attn import kernel as KF

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    rng = np.random.default_rng(0)
    for B, H, Hkv, Sq, Sk, D, Dv, dtype, causal, window in CS.FLASH_SHAPES:
        q, k, v = CS.flash_input(B, H, Hkv, Sq, Sk, D, Dv, dtype, rng)
        if Dv != D and not _takes_v_width(KF, q, k, v):
            continue  # a checkout from before v had its own width
        print(json.dumps({
            "label": args.label, "src": str(src),
            "shape": [B, H, Hkv, Sq, Sk, D, Dv], "dtype": dtype,
            "causal": causal, "window": window,
            "kernel_ms": CS.cuda_ms(lambda: KF.flash_attention_bhsd(
                q, k, v, causal=causal, window=window), args.reps),
            **CS.library_fields(q, k, v, causal, window, args.reps)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
