"""The port's tracer (`repro_torch.tracing`) on the CPU: off it records
nothing and changes nothing, on it gives the serving path's span tree,
traces only its own thread, and its host times land on the profiler's
timeline. The models are the port's smoke configurations (the tiny
MLA-MoE of deepseek-v2-lite, and zamba2's hybrid for the SSM spans)."""
import threading

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import BatchServer
from repro_torch.models import transformer as T

SLOTS, LEN, GEN = 4, 16, 2
SERVE_CHILDREN = {"serve.validate", "serve.upload", "serve.prefill",
                  "serve.sample", "serve.decode", "serve.readback"}
MOE = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine",
       "moe.shared", "moe.aux"}


@pytest.fixture(scope="module")
def model():
    """arch -> (cfg, params), built once."""
    cache = {}

    def get(arch="deepseek-v2-lite-16b"):
        if arch not in cache:
            cfg = get_config(arch, smoke=True)
            cache[arch] = cfg, T.init_params(
                cfg, torch.Generator().manual_seed(0), device="cpu")
        return cache[arch]
    return get


def _prompts(cfg, n=SLOTS, length=LEN, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, length) for _ in range(n)]


def _serve(cfg, params, prompts, gen=GEN):
    server = BatchServer(cfg, params, batch_slots=SLOTS, max_len=LEN + GEN,
                         device="cpu")
    return server.run(prompts, gen_tokens=gen)


def test_off_returns_the_shared_no_op_and_records_nothing(model, monkeypatch):
    cfg, params = model()
    assert tracing.span("serve.run") is tracing.span("moe.route") \
        is tracing.OFF
    tracing.add("pairs", 3)

    def made(*a, **k):
        raise AssertionError("a span was made with the tracer off")

    monkeypatch.setattr(tracing, "Span", made)
    out = _serve(cfg, params, _prompts(cfg))
    assert len(out) == SLOTS and tracing._active is None


def test_on_and_off_serve_and_prefill_bit_equal(model):
    cfg, params = model()
    prompts = _prompts(cfg, n=6)
    toks = torch.from_numpy(np.stack(prompts[:SLOTS]))
    off = _serve(cfg, params, prompts), T.prefill(params, cfg, toks,
                                                  cache_len=LEN + 1)
    with tracing.recording() as rec:
        on = _serve(cfg, params, prompts), T.prefill(params, cfg, toks,
                                                     cache_len=LEN + 1)
    assert rec.spans
    for a, b in zip(off[0], on[0]):
        assert np.array_equal(a, b)
    assert torch.equal(off[1][0], on[1][0])
    for kind, leaves in off[1][1].items():
        for name, t in leaves.items():
            assert torch.equal(t, on[1][1][kind][name]), (kind, name)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-7b"])
def test_one_batch_gives_the_span_tree(model, arch):
    cfg, params = model(arch)
    prompts = _prompts(cfg, n=SLOTS - 1) + [np.array([-1, 2])]
    with tracing.recording() as rec:
        _serve(cfg, params, prompts)
    spans = rec.spans
    by = {s.id: s for s in spans}
    top = spans[0]
    assert top.name == "serve.run" and top.parent is None
    assert {s.batch for s in spans} == {top.id}
    assert {s.name for s in spans if s.parent == top.id} == SERVE_CHILDREN
    for s in spans[1:]:
        p = by[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, s.name
        assert (s.device_s is None) == (not torch.cuda.is_available())
    names = rec.table()
    assert names["serve.decode"][0] == GEN - 1
    assert {by[s.parent].name for s in spans
            if s.name.startswith("prefill.")} == {"serve.prefill"}
    assert rec.counts[("serve.run", "requests")] == SLOTS
    assert rec.counts[("serve.run", "rejected")] == 1
    assert rec.counts[("serve.run", "slots")] == SLOTS
    if cfg.moe is not None:
        assert names["layer.attn"][0] == names["layer.ffn"][0] == cfg.n_layers
        under_ffn = {s.name for s in spans if s.parent is not None
                     and by[s.parent].name == "layer.ffn"}
        assert under_ffn == MOE
        # decode steps route too, straight under serve.decode
        assert names["moe.route"][0] == cfg.n_layers * GEN
        pairs = rec.sums_within("serve.prefill", "moe.route", "pairs")
        assert pairs == [cfg.n_layers * SLOTS * LEN * cfg.moe.top_k]
    else:
        assert names["layer.ssm"][0] == names["ssm.scan"][0] == cfg.n_layers
        assert {by[s.parent].name for s in spans if s.name == "ssm.scan"} \
            == {"layer.ssm"}
        assert names["layer.attn"][0] == len(T._hybrid_groups(cfg))


def test_counts_sum_ints_and_device_tensors():
    with tracing.recording() as rec:
        with tracing.span("a"):
            tracing.add("n", 2)
            tracing.add("n", torch.tensor(5))
            with tracing.span("b"):
                tracing.add("n", torch.tensor(7))
        with tracing.span("a"):
            tracing.add("n", 1)
        tracing.add("lost", 1)   # no span open: dropped
    assert rec.counts == {("a", "n"): 8, ("b", "n"): 7}
    assert [s.counts for s in rec.spans] == [{"n": 7}, {"n": 7}, {"n": 1}]
    assert rec.sums_within("a", "b", "n") == [7, 0]
    assert tracing._active is None


def test_one_recording_at_a_time():
    with tracing.recording():
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
    with pytest.raises(ValueError):
        with tracing.recording():
            raise ValueError
    assert tracing._active is None


def test_spans_of_another_thread_are_ignored(model):
    cfg, params = model()
    toks = torch.from_numpy(np.stack(_prompts(cfg)))
    seen = []

    def other():
        seen.append(tracing.span("x") is tracing.OFF)
        T.prefill(params, cfg, toks)

    with tracing.recording() as rec:
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with tracing.span("mine"):
            pass
    assert seen == [True]
    assert [s.name for s in rec.spans] == ["mine"]


def test_span_times_land_on_the_profilers_clock():
    """A `record_function` range opened inside a span falls inside that
    span's host interval once both are on the profiler's timeline (µs
    after its ``trace_start_ns``), within 100 µs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            for _ in range(3):
                with tracing.span("outer"):
                    torch.ones(64).sum()
                    with record_function("probe"):
                        torch.ones(256, 256).sum()
    start = prof.profiler.kineto_results.trace_start_ns()
    probes = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name == "probe")
    assert len(probes) == 3
    for s, (p0, p1) in zip(rec.spans, probes):
        lo, hi = (s.start_ns - start) * 1e-3, (s.end_ns - start) * 1e-3
        assert lo - 100 <= p0 <= p1 <= hi + 100, (lo, hi, p0, p1)
