"""`flash_roofline` in the cells that report `ttft_p95_ms` and not
`prompt_tokens_per_s`: the same reading (and spans), moving the tail."""
from pathlib import Path

from chipbench.harness import reader

_base = reader(Path(__file__).resolve().parents[2], "flash_roofline")
read = _base.read
SPANS = getattr(_base, "SPANS", {})
