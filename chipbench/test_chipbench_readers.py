"""The per-layer readers and the trace arithmetic on a made-up traced
window: busy time is a union, not a sum; a reader with nothing to read
returns nothing."""
import json
from pathlib import Path

from chipbench import harness, trace, work
from chipbench.conftest import tiny_config
from chipbench.reference import mla_moe as R

HERE = Path(__file__).resolve().parent


def ctx(events, spans=None, launches=None):
    c = tiny_config()
    batches = [harness.Batch(16, 4, 4, 0.0, 0.5),
               harness.Batch(32, 4, 4, 0.5, 1.0)]
    busy = trace.union(events)
    x = harness.Ctx(c, R, 3.0, batches, 1.0, traced=batches, traced_s=1.0,
                    events=events,
                    busy_s=sum(e - s for s, e, _ in busy) * 1e-6,
                    spans=spans or {}, counters={"flash_launches": launches})
    return x


def read(name, x):
    return harness.reader(HERE.parent, name).read(x)


def test_union_counts_overlaps_once():
    ev = [("a", 0.0, 100.0), ("b", 50.0, 150.0), ("Memcpy HtoD", 300.0,
                                                  400.0)]
    busy = trace.union(ev)
    assert [(s, e) for s, e, _ in busy] == [(0.0, 150.0), (300.0, 400.0)]
    x = ctx(ev)
    assert abs(read("device_idle_share", x) - 100 * (1 - 250e-6)) < 1e-9
    b = trace.breakdown(ev, busy)
    assert [n for n, _ in b["idle_gaps"]] == ["before Memcpy HtoD"]
    assert abs(b["idle_gaps"][0][1] - 150e-6) < 1e-12
    assert b["device_ops"][0][0] == "a"
    assert abs(b["device_ops"][0][1] - 100e-6) < 1e-12


def test_flash_roofline_needs_one_kernel_a_call():
    c = tiny_config()
    calls = R.flash_calls(c, 4, 16) + R.flash_calls(c, 4, 32)
    ev = [("flash_attention_tc_kernel<24>", 10.0 * i, 10.0 * i + 5.0)
          for i in range(len(calls))]
    x = ctx(ev, launches=len(calls))
    want = 100 * sum(work.flash_bound_s(k) for k in calls) \
        / (5e-6 * len(calls))
    assert abs(read("flash_roofline", x) - want) < 1e-9
    assert read("flash_roofline", ctx(ev[:-1], launches=len(calls))) is None
    assert read("flash_roofline", ctx(ev, launches=0)) is None


def test_spans_and_mfu():
    x = ctx([("k", 0.0, 1.0)], spans={"moe_ffn": 0.3, "prefill": 0.6})
    assert read("moe_time_share", x) == 50.0
    assert read("moe_time_share", ctx([("k", 0.0, 1.0)])) is None
    c = x.config
    flops = R.prefill_flops(c, 4, 16) + R.prefill_flops(c, 4, 32)
    assert read("prefill_mfu", x) == 100 * flops / 1.0 / work.BF16_FLOPS


def test_split_reader_reads_and_spans_as_its_base():
    x = ctx([("k", 0.0, 1.0)], spans={"moe_ffn": 0.3, "prefill": 0.6})
    split = harness.reader(HERE.parent, "moe_time_share.ttft")
    assert split.read(x) == read("moe_time_share", x)
    assert split.SPANS == harness.reader(HERE.parent, "moe_time_share").SPANS


def test_every_per_layer_metric_has_a_reader_that_runs():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    x = ctx([("flash_attention_tc_kernel<24>", 0.0, 1.0)],
            spans={"moe_ffn": 0.1, "prefill": 0.2}, launches=4)
    for m in bench["per_layer"] + bench["end_to_end"]:
        mod = harness.reader(HERE.parent, m["name"])
        assert callable(mod.read)
        if m in bench["per_layer"]:
            mod.read(x)
