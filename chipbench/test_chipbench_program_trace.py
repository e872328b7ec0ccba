"""`chipbench/program_trace.py` on a made-up timeline (idle charged to
spans, the two shares, the clock check, the result line's fields), and
the program's per-prefill counts against the reference's on the CPU."""
import torch

from chipbench import harness, program_trace as P, trace, weights
from chipbench.conftest import tiny_config
from chipbench.reference import mla_moe as R

M = P.Mapped


def timeline():
    """Two batches on the profiler's µs. Batch 1 runs 0–1000 µs, batch 2
    1200–2000 µs; the host sits outside `serve.run` between them."""
    spans = [
        M(0, None, "serve.run", 0, 0.0, 1000.0, 9e-4, {}),
        M(1, 0, "serve.upload", 0, 10.0, 20.0, 1e-5, {}),
        M(2, 0, "serve.prefill", 0, 20.0, 900.0, 8e-4, {}),
        M(3, 2, "prefill.forward", 0, 25.0, 850.0, 7e-4, {}),
        M(4, 3, "moe.route", 0, 100.0, 200.0, 1e-4, {"dropped_pairs": 3}),
        M(5, 3, "moe.dispatch", 0, 200.0, 300.0, 1e-4, {}),
        M(6, 3, "moe.experts", 0, 300.0, 600.0, 3e-4, {}),
        M(7, 3, "moe.combine", 0, 600.0, 700.0, 1e-4, {}),
        M(8, 0, "serve.readback", 0, 900.0, 990.0, 1e-5, {}),
        M(9, None, "serve.run", 9, 1200.0, 2000.0, 5e-4, {}),
        M(10, 9, "serve.upload", 9, 1210.0, 1220.0, 1e-5, {}),
        M(11, 9, "serve.prefill", 9, 1220.0, 1900.0, 4e-4, {}),
        M(12, 11, "moe.route", 9, 1300.0, 1400.0, 1e-4, {}),
        M(13, 9, "serve.readback", 9, 1900.0, 1995.0, 1e-5, {}),
    ]
    events = [("Memcpy HtoD", 30.0, 40.0), ("k", 40.0, 400.0),
              ("k", 450.0, 980.0), ("Memcpy HtoD", 1250.0, 1260.0),
              ("k", 1255.0, 1990.0)]
    return spans, events, trace.union(events)


def test_idle_is_charged_to_the_innermost_open_span():
    spans, _, busy = timeline()
    # gaps: 0–30 (serve.run), 400–450 (moe.experts), 980–1250 (opens in
    # serve.readback), 1990–2000 (serve.readback)
    assert P.gaps(busy, 0.0, 2000.0) == [(0.0, 30.0), (400.0, 450.0),
                                         (980.0, 1250.0), (1990.0, 2000.0)]
    got = P.idle_by_span(spans, busy, 0.0, 2000.0)
    want = {"serve.readback": 280e-6, "moe.experts": 50e-6,
            "serve.run": 30e-6}
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) < 1e-12, k
    # a gap that opens with no serve.run open is outside
    late = P.idle_by_span(spans, busy[:2] + [[1000.0, 1100.0, "k"]],
                          0.0, 2000.0)
    assert abs(late["outside"] - 900e-6) < 1e-12
    assert abs(sum(late.values()) - 1000e-6) < 1e-12


def test_serve_idle_and_dispatch_shares():
    spans, _, busy = timeline()
    # idle inside the runs: 30 + 50 + 20 (980–1000), then 50 (1200–1250)
    # + 10 (1990–2000), over 1000 + 800 µs
    assert abs(P.serve_idle_share(spans, busy) - 100 * 160 / 1800) < 1e-9
    assert P.serve_idle_share(spans, []) is None
    assert P.serve_idle_share([s for s in spans
                               if s.name != "serve.run"], busy) is None
    # route + dispatch + combine: 3e-4 and 1e-4, over 8e-4 + 4e-4
    assert abs(P.moe_dispatch_share(spans) - 100 * 4e-4 / 12e-4) < 1e-9
    no_moe = [s for s in spans if not s.name.startswith("moe.")]
    assert P.moe_dispatch_share(no_moe) is None
    untimed = [s._replace(device_s=None) for s in spans]
    assert P.moe_dispatch_share(untimed) is None


def test_clock_check_reads_each_batch_margin():
    spans, events, _ = timeline()
    got = P.clock_check(spans, events)
    assert got["batches"] == 2
    assert got["upload_to_first_us"] == [20.0, 40.0]
    assert got["last_to_readback_us"] == [10.0, 5.0]
    assert got["min_upload_margin_us"] == 20.0
    assert got["min_readback_margin_us"] == 5.0
    # a device clock 50 µs late shows as a negative readback margin
    late = [(n, s + 50.0, e + 50.0) for n, s, e in events]
    assert P.clock_check(spans, late)["min_readback_margin_us"] < 0


def test_device_events_move_onto_the_host_clock():
    """A device clock running 1% fast from 100 µs ahead: each batch's copies
    land at the ends of the runtime calls that issued them, the rest
    between them linearly; without a batch's copy nothing moves."""
    spans, _, _ = timeline()
    host = [("Memcpy HtoD", 15.0, 18.0), ("k", 18.0, 600.0),
            ("Memcpy DtoH", 600.0, 985.0), ("Memcpy HtoD", 1215.0, 1216.0),
            ("k", 1216.0, 1900.0), ("Memcpy DtoH", 1900.0, 1990.0)]
    calls = [("cudaMemcpyAsync", 12.0, 15.0), ("cudaMemcpyAsync", 905.0,
                                                985.0),
             ("cudaMemcpyAsync", 1212.0, 1215.0),
             ("cudaMemcpyAsync", 1905.0, 1990.0)]
    dev = [(n, 100.0 + 1.01 * s, 100.0 + 1.01 * e) for n, s, e in host]
    moved, offsets = P.on_host_clock(spans, dev, calls)
    for (n, s, e), (m, s2, e2) in zip(host, moved):
        assert n == m and abs(s - s2) < 1e-9 and abs(e - e2) < 1e-9
    assert [round(a, 6) for a, _ in offsets] == [100.15, 112.15]
    raw = P.clock_check(spans, dev)
    assert raw["min_readback_margin_us"] < 0
    fixed = P.clock_check(spans, moved)
    assert fixed["upload_to_first_us"] == [5.0, 5.0]
    assert fixed["last_to_readback_us"] == [5.0, 5.0]
    assert P.on_host_clock(spans, dev[:2] + dev[3:], calls) == (
        dev[:2] + dev[3:], None)
    assert P.on_host_clock(spans, dev, calls[1:]) == (dev, None)


def test_add_to_line_fills_the_result_line():
    spans, events, busy = timeline()
    ctx = harness.Ctx({}, None, 1.0, [], 1.0, traced_s=0.003, busy_s=0.002)
    prog = {"spans": spans, "events": events, "busy": busy,
            "raw_events": events, "offsets": None,
            "window_us": (0.0, 2000.0), "wall_s": 2e-3, "idle_s": 360e-6,
            "table": {"serve.run": [2, 1.8e-3, 1.4e-3, 0.0]},
            "counts": {"moe.route.dropped_pairs": 3}}
    for e2e, tail in (("ttft_p95_ms", ".ttft"),
                      ("prompt_tokens_per_s", "")):
        spec = harness.Spec("x", 1, {}, {}, {}, [{"name": e2e}], [], None)
        result = {"metrics": {}, "info": {}}
        P.add_to_line(result, spec, ctx, prog)
        assert set(result["metrics"]) == {"serve_idle_share" + tail,
                                          "moe_dispatch_share" + tail}
        second = result["info"]["tracer_cycle"]["second"]
        assert abs(second["idle_by_span_sum_s"] - second["idle_s"]) < 1e-9
        assert result["info"]["tracer_cycle"]["first"]["idle_s"] == 0.001
        assert result["info"]["program_counts"] == prog["counts"]
        check = result["info"]["clock_check"]
        assert check["device_clock"]["batches"] == 2
        assert check["on_host_clock"] is None
        assert "outside" not in result["breakdown"]["idle_by_span"]


def test_per_prefill_counts_equal_the_reference():
    """The program's `dropped_pairs` and `pairs` of each prefill (its
    `moe.route` spans under `serve.prefill`) equal the reference's counts
    on the same ids and weights, in float32."""
    from chipbench.adapters import mla_moe as A
    from repro_torch import tracing
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import api as API

    c = tiny_config("float32")
    cfg = A.port_config(c)
    g = torch.Generator().manual_seed(3)
    W = weights.make(API.abstract_params(cfg), c["bench"]["init"], g, "cpu")
    server = BatchServer(cfg, W, batch_slots=3, max_len=41, device="cpu")
    batches = [torch.randint(0, c["vocab_size"], (3, n), generator=g)
               for n in (40, 24)]
    with tracing.recording() as rec:
        for tokens in batches:
            server.run(list(tokens.numpy()), gen_tokens=1)
    drops = rec.sums_within("serve.prefill", "moe.route", "dropped_pairs")
    pairs = rec.sums_within("serve.prefill", "moe.route", "pairs")
    ref = [R.forward(W, c, tokens) for tokens in batches]
    assert drops == [r["dropped"] for r in ref] and drops[0] > 0
    assert pairs == [r["pairs"] for r in ref]
