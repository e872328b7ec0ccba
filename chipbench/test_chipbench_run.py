"""The harness on the CPU at a tiny size: the result line, files found by
name, the faults that `correct` has to catch, the control, and the exit
without a card."""
import json

import pytest
import torch

from chipbench import compare, harness
from chipbench.conftest import BF16_LIMITS


def run(root, seed=7):
    """One tiny run (the window holds at least the compared cycle)."""
    spec = harness.load_spec(root, "tiny.t")
    return harness.run_cell(spec, seed, 0.2, False, device="cpu")


def test_result_line_schema(f32_root):
    r = run(f32_root)
    line = json.loads(json.dumps(r))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % 4 == 0 and line["attempted"] >= 16
    assert set(line["metrics"]) == {"prompt_tokens_per_s", "ttft_p95_ms",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["device"]["platform"] == "cpu"   # never named a device metric
    for name, (value, limit) in line["checks"].items():
        assert value <= limit, name


def test_files_found_by_name(tmp_path):
    from chipbench.conftest import F32_LIMITS, make_root

    root = make_root(tmp_path, F32_LIMITS, dtype="float32",
                     extra_metrics=("batches_run",))
    (root / "chipbench" / "metrics" / "batches_run.py").write_text(
        "def read(ctx):\n    return len(ctx.batches)\n")
    r = run(root)
    assert r["metrics"]["batches_run"]["value"] == r["info"]["batches"]
    assert r["metrics"]["batches_run"]["unit"] == "x"


@pytest.mark.parametrize("fault", ["token_altered", "half_batch",
                                   "state_unchanged"])
def test_faults_make_correct_false(f32_root, monkeypatch, fault):
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    if fault == "token_altered":
        orig = serve.mask_pad_logits
        monkeypatch.setattr(serve, "mask_pad_logits",
                            lambda cfg, lg: orig(cfg, lg).roll(1, -1))
    elif fault == "half_batch":
        orig = T.prefill

        def half(params, cfg, tokens, **kw):
            h = tokens.shape[0] // 2
            logits, cache = orig(params, cfg, tokens[:h], **kw)

            def twice(t):
                return ({k: twice(v) for k, v in t.items()}
                        if isinstance(t, dict) else torch.cat([t, t], dim=1))
            return torch.cat([logits, logits]), twice(cache)
        monkeypatch.setattr(T, "prefill", half)
    else:
        monkeypatch.setattr(T, "fill_cache", lambda out, caches, specs: out)
    r = run(f32_root)
    assert r["info"]["numbers"] is not None
    assert r["correct"] is False
    assert any(v > lim for v, lim in r["checks"].values())


@pytest.mark.parametrize("fault", ["one_token", "one_slot_cache"])
def test_one_slot_faults_make_correct_false(bf16_root, monkeypatch, fault):
    """A fault in one slot of one batch fails a bf16 cell too: the served
    token against the program's own logits, the cache slot by slot."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    if fault == "one_token":
        orig = serve.BatchServer.run

        def altered(self, prompts, **kw):
            out = orig(self, prompts, **kw)
            out[-1] = (out[-1] + 1) % 512
            return out
        monkeypatch.setattr(serve.BatchServer, "run", altered)
        name = "tok_own"
    else:
        orig = T.prefill

        def off(params, cfg, tokens, **kw):
            logits, cache = orig(params, cfg, tokens, **kw)
            ckv = cache["attn"]["ckv"]
            ckv[:, -1] = ckv[:, -1] * 1.5
            return logits, cache
        monkeypatch.setattr(T, "prefill", off)
        name = "cache_rel0"
    r = run(bf16_root)
    assert r["correct"] is False
    value, limit = r["checks"][name]
    assert value > limit


def test_control_is_not_correct(bf16_root):
    """The program in bf16 passes the tiny cell's limits; the reference in
    fp8 in its place does not."""
    from chipbench import calibrate

    spec = harness.load_spec(bf16_root, "tiny.t")
    run_ = harness.measure(spec, 7, 0.0, False, device="cpu")
    own = harness.own_gaps(spec, run_)
    prog, ctl, ctl_own = [], [], []
    for tokens, ref, r in harness.compared(spec, run_):
        prog.append(r)
        c, g = calibrate.control_reading(spec, run_.weights, tokens, ref)
        ctl.append(c)
        ctl_own += g
    ok, checks = compare.verdict(compare.numbers(prog, own), BF16_LIMITS)
    assert ok, checks
    ok, checks = compare.verdict(compare.numbers(ctl, ctl_own), BF16_LIMITS)
    assert not ok, checks


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "dsv2lite.chat", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
