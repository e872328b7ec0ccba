"""Fixtures of the benchmark's CPU tests: a checkout-like root holding a
tiny cell of the ``mla_moe`` family (the real metric readers copied),
which `harness.run_cell` drives on the CPU with the kernels' plain
versions. The tests decide nothing about a card at import."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            kv_lora_rank=32, n_routed_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=32, n_shared_experts=1,
            num_hidden_layers=2, vocab_size=512)

TRAFFIC = {"slots": 4, "gen_tokens": 1,
           "lengths": [[16, 2], [32, 1], [64, 1]],
           "compare_cycles": 1}


def tiny_config(dtype: str = "bfloat16") -> dict:
    c = json.loads((HERE / "configs" / "dsv2lite.json").read_text())
    c.update(TINY)
    c["bench"] = dict(c["bench"], name="tiny", dtype=dtype)
    return c


def make_root(tmp: Path, limits: dict, dtype: str = "bfloat16",
              extra_metrics: tuple = ()) -> Path:
    """A root with ``BENCHMARK.json`` of one cell ``tiny.t``."""
    cb = tmp / "chipbench"
    for d in ("configs", "traffic", "limits"):
        (cb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", cb / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (cb / "configs" / "tiny.json").write_text(json.dumps(tiny_config(dtype)))
    (cb / "traffic" / "t.json").write_text(json.dumps(TRAFFIC))
    (cb / "limits" / "tiny.t.json").write_text(json.dumps(limits))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "chipbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny.t", "config": "tiny",
                           "traffic": "t", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    for name in extra_metrics:
        bench["end_to_end"].append({"name": name, "unit": "x",
                                    "better": "lower", "bound": 0.1,
                                    "source": "host_clock"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


# limits of the tiny cells: f32 runs agree with the reference to rounding
# (≈ 1e-6); the bf16 ones are held only by the numbers that the control
# separates at this size (program ≤ 0.014 and 0.0039 over six seeds,
# control ≥ 0.160 and 0.041); a served token is its own logits' best
# exactly
F32_LIMITS = {"tok_own": 0.0, "tok_gap": 1e-3, "logit_rel": 1e-3,
              "cache_rel": 1e-3}
BF16_LIMITS = {"tok_own": 0.0, "logit_rel_med": 0.05, "cache_rel0": 0.012}


@pytest.fixture
def f32_root(tmp_path):
    return make_root(tmp_path, F32_LIMITS, dtype="float32")


@pytest.fixture
def bf16_root(tmp_path):
    return make_root(tmp_path, BF16_LIMITS)
