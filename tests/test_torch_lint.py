"""Tests for the port's invariant linter (`repro_torch.analysis`).

Per-rule fixtures in PyTorch's idiom (each rule firing, staying quiet on
conforming code, honoring a justified suppression), the baseline
machinery, KERNEL-TRIPLE's four legs on a fake checkout, parity with the
reference linter (`repro.analysis`) on `tests/test_lint.py`'s fixture
sources, disjoint scopes, and the gate over the whole port — the same
invocation as ``python -m repro_torch.analysis.lint``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import baseline as ref_baseline
from repro.analysis import core as ref_core
from repro.analysis import rules as ref_rules
from repro_torch.analysis import baseline as port_baseline
from repro_torch.analysis import core as port_core
from repro_torch.analysis import rules as port_rules
from repro_torch.analysis.baseline import apply_baseline, load_baseline
from repro_torch.analysis.core import lint_paths, lint_source
from repro_torch.analysis.lint import DEFAULT_PATHS
from repro_torch.analysis.rules import (ATOMIC_WRITE, HOST_SYNC_IN_LOOP,
                                        INT_RANK_ONLY, ITER_REUPLOAD,
                                        JIT_CACHE_BOUND, KERNEL_TRIPLE,
                                        NO_RECURSION_LIMIT, NONDET_ITER,
                                        RULES, SEED_DISCIPLINE,
                                        TIME_MONOTONIC, TOOLS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run(src: str, relpath: str, rule):
    return lint_source(textwrap.dedent(src), relpath, [rule])


def rules_hit(src: str, relpath: str, rule):
    return [f.rule for f in run(src, relpath, rule).findings]


def suppressed_once(src: str, relpath: str, rule):
    res = lint_source(src, relpath, [rule])
    return res.findings == [] and len(res.suppressed) == 1


# ---------------------------------------------------------------- registry
def test_registry_has_ten_port_rules_with_docs():
    assert len(RULES) == 10
    names = port_rules.rules_by_name()
    assert len(names) == len(RULES)
    assert set(names) == set(ref_rules.rules_by_name()) - {"DTYPE-WIDTH"}
    for r in RULES:
        assert r.name and r.summary and r.contract
        assert r.scope, f"{r.name} has no scope: it would run everywhere"
        for prefix in r.scope + r.exclude:
            assert prefix.startswith("src/repro_torch/") or prefix in TOOLS


PORT_PATHS = ("src/repro_torch/core/merging.py",
              "src/repro_torch/core/distributed.py",
              "src/repro_torch/core/resident.py",
              "src/repro_torch/kernels/bitset_fold/rounds.py",
              "src/repro_torch/launch/serve.py", "chip_smoke.py",
              "serve_bench.py")
REF_PATHS = ("src/repro/core/merging.py", "src/repro/core/distributed.py",
             "src/repro/core/resident.py",
             "src/repro/kernels/bitset_fold/ops.py",
             "src/repro/launch/serve.py", "benchmarks/run.py",
             "tests/test_lint.py", "examples/quickstart.py")


def test_scopes_are_disjoint_from_the_reference():
    """No port rule applies to the reference's files, no reference rule
    to the port's, and on the real tree neither linter finds anything in
    the other's package."""
    for rule in RULES:
        assert not any(rule.applies(p) for p in REF_PATHS), rule.name
    for rule in ref_rules.RULES:
        if isinstance(rule, ref_core.TreeRule):
            continue
        assert not any(rule.applies(p) for p in PORT_PATHS), rule.name
    assert lint_paths(REPO, ["src/repro", "benchmarks"],
                      RULES).findings == []
    assert ref_core.lint_paths(REPO, ["src/repro_torch", *TOOLS],
                               ref_rules.RULES).findings == []


# ---------------------------------------------------------------- SEED
def test_seed_discipline_fires_on_torch_global_rng():
    src = """
        import numpy as np
        import torch
        def f(x, w, seed, t, dev):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(1)
            torch.seed()
            a = torch.randn(3, 4)
            b = torch.randint(0, 9, (4,), device=dev)
            c = torch.rand_like(x)
            w.normal_(0.0, 0.02)
            torch.nn.init.uniform_(w)
            g = torch.Generator(device=dev).manual_seed(seed * 7919 + t)
            rng = np.random.default_rng(seed + t)
            return a, b, c, g, rng
    """
    assert rules_hit(src, "src/repro_torch/models/x.py",
                     SEED_DISCIPLINE()) == ["SEED-DISCIPLINE"] * 10


def test_seed_discipline_quiet_on_seeded_generators():
    src = """
        import numpy as np
        import torch
        def f(x, w, seed, t, dev, n):
            g = torch.Generator(device=dev).manual_seed(seed)
            a = torch.randn(3, generator=g, device=dev)
            w.normal_(0.0, 0.02, generator=g)
            p = torch.randperm(n, generator=g)
            rng = np.random.default_rng(np.random.SeedSequence((seed, t)))
            kids = np.random.SeedSequence(seed).spawn(4)
            return a, p, rng.normal(size=3), rng.random(4), kids
    """
    assert rules_hit(src, "src/repro_torch/models/x.py",
                     SEED_DISCIPLINE()) == []


def test_seed_discipline_scope_and_suppression():
    src = "import torch\ntorch.manual_seed(0)\n"
    assert rules_hit(src, "chip_smoke.py", SEED_DISCIPLINE()) == []
    assert rules_hit(src, "src/repro_torch/analysis/x.py",
                     SEED_DISCIPLINE()) == []
    assert suppressed_once(
        "import torch\ntorch.manual_seed(0)  # lint: disable=SEED-DISCIPLINE"
        " -- fixture noise, not a determinism surface\n",
        "src/repro_torch/x.py", SEED_DISCIPLINE())


def test_suppression_without_reason_does_not_suppress():
    src = "import torch\nx = torch.randn(3)  # lint: disable=SEED-DISCIPLINE\n"
    res = lint_source(src, "src/repro_torch/x.py", [SEED_DISCIPLINE()])
    assert len(res.findings) == 1 and res.suppressed == []
    assert "justification is mandatory" in res.findings[0].message


def test_suppression_names_the_rule_on_its_line_or_the_one_before():
    src = ("import torch\n"
           "# lint: disable=TIME-MONOTONIC -- another rule's directive\n"
           "x = torch.randn(3)\n")
    res = lint_source(src, "src/repro_torch/x.py", [SEED_DISCIPLINE()])
    assert [f.line for f in res.findings] == [3]
    src = ("import torch\n"
           "# lint: disable=SEED-DISCIPLINE -- two lines above: too far\n"
           "\n"
           "x = torch.randn(3)\n")
    res = lint_source(src, "src/repro_torch/x.py", [SEED_DISCIPLINE()])
    assert [f.line for f in res.findings] == [4]


# ---------------------------------------------------------------- CACHE
def test_jit_cache_bound_fires_on_bare_dicts():
    src = """
        from collections import OrderedDict
        _GRAPH_CACHE = {}
        _DECODE_CACHE: dict = dict()
        _PLAN_CACHE = OrderedDict()
    """
    found = run(src, "src/repro_torch/models/x.py", JIT_CACHE_BOUND())
    assert [f.rule for f in found.findings] == ["JIT-CACHE-BOUND"] * 3
    assert all("lru_cache(maxsize=N)" in f.message for f in found.findings)


def test_jit_cache_bound_quiet_on_lru_and_locals():
    src = """
        import functools
        _CACHE_ENV = "REPRO_DATA_DIR"
        @functools.lru_cache(maxsize=16)
        def _graph_for(shape):
            return shape
        def f():
            local_cache = {}  # function-local: bounded by the call
            return local_cache
    """
    assert rules_hit(src, "src/repro_torch/models/x.py",
                     JIT_CACHE_BOUND()) == []


# ---------------------------------------------------------------- INT RANK
def test_int_rank_only_fires_on_torch_division_and_float_compare():
    src = """
        import torch
        def f(inter, union, key):
            j = inter / union.clamp(min=1)
            return torch.where(key >= 0.5, j, 0)
    """
    for path in ("src/repro_torch/kernels/bitset_fold/rounds.py",
                 "src/repro_torch/core/merging.py"):
        assert rules_hit(src, path, INT_RANK_ONLY()) == ["INT-RANK-ONLY"] * 2


def test_int_rank_only_quiet_on_integer_ops_and_other_modules():
    src = """
        import torch
        def f(inter, union):
            a = torch.div(inter << 15, union.clamp(min=1),
                          rounding_mode="floor")
            return a, (inter << 15) // union.clamp(min=1)
    """
    assert rules_hit(src, "src/repro_torch/kernels/bitset_fold/ops.py",
                     INT_RANK_ONLY()) == []
    assert rules_hit("x = 1 / 3\n", "src/repro_torch/core/summary_ir.py",
                     INT_RANK_ONLY()) == []


# ---------------------------------------------------------------- NONDET
def test_nondet_iter_fires_on_sets_behind_torch_materializers():
    src = """
        import torch
        def f(xs, d):
            touched = set(xs)
            for w in touched:
                d[w] = True
            a = torch.tensor(list({x + 1 for x in xs}))
            return a, torch.as_tensor(touched)
    """
    assert rules_hit(src, "src/repro_torch/core/pruning.py",
                     NONDET_ITER()) == ["NONDET-ITER"] * 3


def test_nondet_iter_quiet_on_sorted_and_out_of_scope():
    src = """
        import torch
        def f(xs, d):
            for k, v in d.items():  # dicts iterate in insertion order
                pass
            return torch.tensor(sorted(set(xs)))
    """
    assert rules_hit(src, "src/repro_torch/core/pruning.py",
                     NONDET_ITER()) == []
    assert rules_hit("def f(xs):\n    return list(set(xs))\n",
                     "src/repro_torch/launch/serve.py", NONDET_ITER()) == []


# ---------------------------------------------------------------- RECURSION
def test_no_recursion_limit_fires_in_scope_and_suppresses():
    src = "import sys\nsys.setrecursionlimit(100000)\n"
    for path in ("src/repro_torch/core/x.py", "multi_rank_smoke.py"):
        assert rules_hit(src, path, NO_RECURSION_LIMIT()) == [
            "NO-RECURSION-LIMIT"]
    for path in ("tests/test_x.py", "examples/torch_quickstart.py"):
        assert rules_hit(src, path, NO_RECURSION_LIMIT()) == []
    assert suppressed_once(
        "import sys\n"
        "# lint: disable=NO-RECURSION-LIMIT -- scoped reference-emitter "
        "bump, restored in finally\n"
        "sys.setrecursionlimit(100000)\n",
        "src/repro_torch/core/x.py", NO_RECURSION_LIMIT())


# ---------------------------------------------------------------- HOST SYNC
def test_host_sync_in_loop_fires_on_torch_syncs():
    src = """
        import numpy as np
        import torch
        class A:
            def run(self, rounds):
                for _ in range(rounds):
                    n = self._verdicts.sum().item()
                    ids = self._ids.tolist()
                    host = self._bits.cpu().numpy()
                    moved = self._cnt.to("cpu")
                    kept = self._cnt.to(device=torch.device("cpu"))
                    torch.cuda.synchronize()
                    v = np.asarray(self._verdicts)
                return n, ids, host, moved, kept, v
    """
    found = rules_hit(src, "src/repro_torch/core/resident.py",
                      HOST_SYNC_IN_LOOP())
    assert found == ["HOST-SYNC-IN-LOOP"] * 8


def test_host_sync_in_loop_quiet_when_accounted_or_not_a_sync():
    accounted = """
        class A:
            def run(self, rounds, counter):
                for _ in range(rounds):
                    v = self._verdicts.cpu().numpy()
                    counter.add_d2h(v.nbytes)
                return v
    """
    assert rules_hit(accounted, "src/repro_torch/core/resident.py",
                     HOST_SYNC_IN_LOOP()) == []
    not_syncs = """
        import numpy as np
        import torch
        def pack(groups, dev, verdicts):
            out = []
            for grp in groups:
                out.append(np.asarray(grp, dtype=np.int64))
                t = torch.from_numpy(out[-1]).to(dev).to(torch.int8)
                t = t.to("cuda")
            return out, verdicts.item()   # outside the loop: one sync
    """
    assert rules_hit(not_syncs, "src/repro_torch/kernels/bitset_fold/ops.py",
                     HOST_SYNC_IN_LOOP()) == []
    loop = "def f(xs):\n    for x in xs:\n        x.item()\n"
    assert rules_hit(loop, "src/repro_torch/core/summary.py",
                     HOST_SYNC_IN_LOOP()) == []


# ---------------------------------------------------------------- REUPLOAD
@pytest.mark.parametrize("upload", [
    "torch.as_tensor(bits, device=device)",
    "torch.tensor(bits, device='cuda')",
    "torch.from_numpy(bits).to(device)",
    "torch.from_numpy(bits.view(np.int32)).to(self.device)",
    "np.ascontiguousarray(bits).astype(np.int32).contiguous().cuda()",
    "torch.from_numpy(bits).to(device=dev, non_blocking=True)",
    "bits.cuda()",
    "bits[0].to('cuda:0')",
    "_put(bits, self.device)",
    "self._put(bits, dev)",
], ids=["as_tensor", "tensor", "to_device", "view_to", "cast_chain",
        "to_kw", "cuda", "subscript", "put", "method_put"])
def test_iter_reupload_fires_on_loop_invariant_upload(upload):
    src = f"""
        import numpy as np
        import torch
        class A:
            def run(self, bits, iters, device, dev):
                for t in range(iters):
                    up = {upload}
                return up
    """
    assert rules_hit(src, "src/repro_torch/core/resident.py",
                     ITER_REUPLOAD()) == ["ITER-REUPLOAD"]


def test_iter_reupload_quiet_on_slabs_casts_and_one_time_uploads():
    # the intersection dispatch's pattern (`kernels/bitset_jaccard/ops.py`)
    src = """
        import numpy as np
        import torch
        def dispatch(bits, B, G, Wp, device, dtype, TILE_B=8):
            for t0 in range(0, B, TILE_B):
                nb = min(TILE_B, B - t0)
                batch = np.zeros((TILE_B, G, Wp), dtype=np.uint32)
                batch[:nb] = bits[t0:t0 + nb]
                inter = torch.from_numpy(batch.view(np.int32)).to(device)
                cast = torch.from_numpy(bits).to(torch.int8)
                same = torch.from_numpy(bits).to(dtype)
                host = torch.as_tensor(bits)
                kept = torch.as_tensor(bits, device="cpu")
                rows = [torch.from_numpy(b).to(device) for b in batch]
            final = torch.from_numpy(bits).to(device)
            return inter, cast, same, host, kept, rows, final
    """
    assert rules_hit(src, "src/repro_torch/kernels/bitset_jaccard/ops.py",
                     ITER_REUPLOAD()) == []
    arena = """
        class Arena:
            def run(self, rounds):
                for r in rounds:
                    slab = self.pack(r)
                    t = _put(slab, self.device).to(torch.int64)
                    self.state = self._bits.to(self.device)  # an attribute
                    fresh = self.pack(r).to(self.device)  # computed afresh
                    also = pack_rows(rounds, r).cuda()
                return t
    """
    assert rules_hit(arena, "src/repro_torch/core/resident.py",
                     ITER_REUPLOAD()) == []


def test_iter_reupload_out_of_scope_and_suppressed():
    src = """
        import torch
        def f(bits, iters, device):
            for _ in range(iters):
                dev = torch.from_numpy(bits).to(device)
            return dev
    """
    assert rules_hit(src, "src/repro_torch/core/merging.py",
                     ITER_REUPLOAD()) == []
    assert rules_hit(src, "src/repro_torch/core/engine.py",
                     ITER_REUPLOAD()) == ["ITER-REUPLOAD"]
    assert suppressed_once(
        "import torch\n"
        "def f(bits, iters, device):\n"
        "    for _ in range(iters):\n"
        "        dev = torch.from_numpy(bits).to(device)  # lint: disable="
        "ITER-REUPLOAD -- convergence probe re-reads a host-mutated buffer\n"
        "    return dev\n",
        "src/repro_torch/core/resident.py", ITER_REUPLOAD())


# ---------------------------------------------------------------- TRIPLE
BUILD_PY = '''
import ctypes
import torch
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
LAUNCHERS = {
    "good_launch": (_P, _I64, _P),
    "bad_arity_launch": (_P, _P),
    "missing_def_launch": (_P,),
    "good_smem_bytes": (_I64,),
}
'''
GOOD_KERNEL = '''
from repro_torch.kernels import _build
def run(x):
    _build.launch("good_launch", 0, x.data_ptr(), 4)
    lib = _build.load_library()
    return lib.good_smem_bytes(8)
'''
BAD_KERNEL = '''
from repro_torch.kernels import _build
def run(x):
    _build.launch("typo_launch", 0, x.data_ptr())
    return _build.load_library().other_launch(x.data_ptr(), None)
'''
GOOD_CU = '''
#include <cstdint>
// extern "C" int commented_launch(void* stream) { return 0; }
/* extern "C" int block_commented_launch(void* s) { return 0; } */
extern "C" int good_launch(const void* x, int64_t n,
                           void* stream) {
  return 0;
}
extern "C" int good_smem_bytes(int64_t D) { return 0; }
extern "C" int bad_arity_launch(void* a, void* b, void* stream) {
  return 0;
}
extern "C" int orphan_launch(void* stream) { return 0; }
'''
ERRORS_CU = '''
extern "C" const char* repro_torch_error_string(int code) { return ""; }
'''


def _fake_checkout(root, bad_kernel=True):
    kdir = root / "src" / "repro_torch" / "kernels"
    (kdir / "goodk").mkdir(parents=True)
    (kdir / "_build.py").write_text(BUILD_PY)
    for leg in ("ops.py", "ref.py"):
        (kdir / "goodk" / leg).write_text("x = 1\n")
    (kdir / "goodk" / "kernel.py").write_text(GOOD_KERNEL)
    if bad_kernel:
        (kdir / "badk").mkdir()
        (kdir / "badk" / "ops.py").write_text("x = 1\n")  # ref.py missing
        (kdir / "badk" / "kernel.py").write_text(BAD_KERNEL)
    csrc = root / "src" / "repro_torch" / "csrc"
    csrc.mkdir()
    (csrc / "good.cu").write_text(GOOD_CU)
    (csrc / "errors.cu").write_text(ERRORS_CU)
    # a header carries no launcher: not read for bindings
    (csrc / "tile.cuh").write_text(
        'extern "C" int header_launch(void* s) { return 0; }\n')
    tdir = root / "tests"
    tdir.mkdir()
    (tdir / "test_torch_k.py").write_text(
        "from repro_torch.kernels.goodk import ops\n")
    # the reference's tests do not count: `kernels.badk` would match
    (tdir / "test_k.py").write_text("from repro.kernels.badk import ops\n")


def test_kernel_triple_fires_on_each_leg(tmp_path):
    _fake_checkout(tmp_path)
    res = lint_paths(str(tmp_path), ["src"], [KERNEL_TRIPLE()])
    got = sorted((f.path, f.line, f.symbol, f.snippet, f.message)
                 for f in res.findings)
    assert len(got) == 7, got
    base = "src/repro_torch/kernels/"
    # (a) a missing leg, (b) a kernel no port test reaches
    msgs = [f[4] for f in got if f[0] == base + "badk"]
    assert len(msgs) == 2
    assert any("missing `ref.py`" in m for m in msgs)
    assert any("not referenced by any tests/test_torch_*.py" in m
               for m in msgs)
    # (c) launchers a kernel.py names but LAUNCHERS lacks
    unknown = sorted(f[4].split("`")[1] for f in got
                     if f[0] == base + "badk/kernel.py")
    assert unknown == ["other_launch", "typo_launch"]
    assert all(f[0] != base + "goodk/kernel.py" for f in got)
    # (d) arity, a key with no definition, a definition with no key
    build = [f for f in got if f[0] == base + "_build.py"]
    assert len(build) == 2
    assert any("bad_arity_launch" in f[4] and "has 2 argtypes" in f[4]
               and "takes 3 parameters" in f[4] for f in build)
    assert any("missing_def_launch" in f[4] and "no `extern \"C\"`" in f[4]
               for f in build)
    orphan = [f for f in got if f[0] == "src/repro_torch/csrc/good.cu"]
    assert [(f[1], f[2]) for f in orphan] == [(13, "orphan_launch")]
    assert "not bound" in orphan[0][4]


def test_kernel_triple_quiet_on_a_complete_kernel(tmp_path):
    _fake_checkout(tmp_path, bad_kernel=False)
    build = tmp_path / "src" / "repro_torch" / "kernels" / "_build.py"
    build.write_text(BUILD_PY.replace('"bad_arity_launch": (_P, _P)',
                                      '"bad_arity_launch": (_P, _P, _P)')
                     .replace('    "missing_def_launch": (_P,),\n', "")
                     .replace('"good_smem_bytes": (_I64,),',
                              '"good_smem_bytes": (_I64,),\n'
                              '    "orphan_launch": (_P,),'))
    assert lint_paths(str(tmp_path), ["src"], [KERNEL_TRIPLE()]).findings == []


def test_extern_c_parser_reads_definitions_only():
    defs = port_rules.extern_c_definitions(GOOD_CU + ERRORS_CU +
                                           'extern "C" int decl_launch(int);\n')
    assert defs == {"good_launch": (5, 3), "good_smem_bytes": (9, 1),
                    "bad_arity_launch": (10, 3), "orphan_launch": (13, 1),
                    "repro_torch_error_string": (15, 1)}


def test_every_real_launcher_is_defined_at_its_arity():
    """The port's own ctypes boundary: `_build.LAUNCHERS` (read by AST,
    and as imported) against the ``extern "C"`` definitions in
    `csrc/*.cu`, and every launcher each `kernel.py` names."""
    from repro_torch.kernels import _build

    with open(os.path.join(REPO, "src/repro_torch/kernels/_build.py")) as fh:
        table = port_rules.launcher_table(fh.read(), "_build.py")
    assert {k: n for k, (_, n) in table.items()} == {
        k: len(v) for k, v in _build.LAUNCHERS.items()}
    defined = {}
    csrc = os.path.join(REPO, "src", "repro_torch", "csrc")
    for fn in sorted(os.listdir(csrc)):
        if fn.endswith(".cu"):
            with open(os.path.join(csrc, fn)) as fh:
                defined.update(port_rules.extern_c_definitions(fh.read()))
    for name, argtypes in _build.LAUNCHERS.items():
        assert defined[name][1] == len(argtypes), name
    assert {n for n in defined if n.endswith("_launch")} <= set(table)
    named = set()
    kdir = os.path.join(REPO, "src", "repro_torch", "kernels")
    for name in sorted(os.listdir(kdir)):
        kpath = os.path.join(kdir, name, "kernel.py")
        if os.path.isfile(kpath):
            with open(kpath) as fh:
                ctx = port_core.ModuleContext(kpath, fh.read())
            named.update(n for _, n in port_rules.launcher_uses(ctx))
    assert named <= set(table)
    assert len(named) >= 8  # every kernel's launcher is named somewhere
    assert lint_paths(REPO, [], [KERNEL_TRIPLE()]).findings == []


# ---------------------------------------------------------------- TIME
def test_time_monotonic_fires_in_scope_only():
    src = "import time\nt0 = time.time()\n"
    for path in ("src/repro_torch/launch/x.py", "chip_smoke.py",
                 "serve_bench.py", "multi_rank_smoke.py"):
        assert rules_hit(src, path, TIME_MONOTONIC()) == ["TIME-MONOTONIC"]
    assert rules_hit(src, "src/repro_torch/core/x.py", TIME_MONOTONIC()) == []
    ok = "import time\nt0 = time.perf_counter()\n"
    assert rules_hit(ok, "chip_smoke.py", TIME_MONOTONIC()) == []
    assert suppressed_once(
        "import time\nstamp = time.time()  # lint: disable=TIME-MONOTONIC "
        "-- artifact metadata timestamp, not a duration\n",
        "chip_smoke.py", TIME_MONOTONIC())


# ---------------------------------------------------------------- ATOMIC
def test_atomic_write_fires_on_torch_save_in_place():
    src = """
        import os
        import torch
        def save(state, ckpt_dir, step):
            torch.save(state, os.path.join(ckpt_dir, f"step_{step}.pt"))
        def save_kw(state, checkpoint_path):
            torch.save(state, f=checkpoint_path)
    """
    assert rules_hit(src, "src/repro_torch/train/checkpoint.py",
                     ATOMIC_WRITE()) == ["ATOMIC-WRITE"] * 2
    tool = """
        import json
        def report(build_dir, out):
            with open(build_dir + "/cache.json", "w") as fh:
                json.dump(out, fh)
    """
    assert rules_hit(tool, "chip_smoke.py", ATOMIC_WRITE()) == [
        "ATOMIC-WRITE"]


def test_atomic_write_quiet_with_replace_commit_and_on_plain_paths():
    src = """
        import os
        import torch
        def save(state, ckpt_dir):
            path = os.path.join(ckpt_dir, "state.pt")
            tmp = path + ".part"
            torch.save(state, tmp)
            os.replace(tmp, path)
        def dump(state, out_path, obj):
            torch.save(obj, out_path)  # no durable-artifact word
            buf = torch.load(os.path.join(out_path, "ckpt.pt"))
            return buf
    """
    assert rules_hit(src, "src/repro_torch/train/checkpoint.py",
                     ATOMIC_WRITE()) == []
    assert rules_hit("import torch\ntorch.save(1, 'ckpt.pt')\n",
                     "src/repro_torch/analysis/x.py", ATOMIC_WRITE()) == []


# ---------------------------------------------------------------- baseline
def _finding(src: str, relpath: str, rule):
    res = lint_source(textwrap.dedent(src), relpath, [rule])
    assert len(res.findings) == 1
    return res.findings[0]


TIMED = """
    import time
    def main():
        t0 = time.time()
"""


def _entry(f, justification="fixture"):
    return {"rule": f.rule, "path": f.path, "symbol": f.symbol,
            "snippet": f.snippet, "justification": justification}


def test_baseline_matches_on_symbol_and_snippet_not_line():
    f = _finding(TIMED, "chip_smoke.py", TIME_MONOTONIC())
    moved = _finding("\n\n# an unrelated edit above" + textwrap.dedent(TIMED),
                     "chip_smoke.py", TIME_MONOTONIC())
    assert moved.line == f.line + 2
    m = apply_baseline([moved], [_entry(f)])
    assert m.new == [] and len(m.matched) == 1 and m.stale == []
    renamed = _finding(TIMED.replace("main", "run"), "chip_smoke.py",
                       TIME_MONOTONIC())
    m = apply_baseline([renamed], [_entry(f)])
    assert m.new == [renamed] and len(m.stale) == 1


def test_baseline_entry_without_justification_rejected():
    f = _finding(TIMED, "chip_smoke.py", TIME_MONOTONIC())
    m = apply_baseline([f], [_entry(f, "  ")])
    assert len(m.unjustified) == 1 and len(m.new) == 1  # no silent pass


def test_baseline_stale_entry_detected():
    entry = {"rule": "TIME-MONOTONIC", "path": "serve_bench.py",
             "symbol": "main", "snippet": "t0 = time.time()",
             "justification": "code this excused was deleted"}
    m = apply_baseline([], [entry])
    assert len(m.stale) == 1 and m.size == 1


def test_baseline_is_a_multiset():
    f = _finding(TIMED, "chip_smoke.py", TIME_MONOTONIC())
    m = apply_baseline([f, f], [_entry(f)])  # one entry cannot cover two
    assert len(m.matched) == 1 and len(m.new) == 1
    m = apply_baseline([f, f], [_entry(f), _entry(f)])
    assert len(m.matched) == 2 and m.new == []


# ------------------------------------------------------- parity with repro
# `tests/test_lint.py`'s fixture sources for the rules both packages hold,
# each run through both engines at the reference's path and at the port's.
PARITY = [
    ("SEED-DISCIPLINE", "src/repro/x.py", """
        import numpy as np
        def f():
            return np.random.rand(3)
    """),
    ("SEED-DISCIPLINE", "src/repro/x.py", """
        import numpy as np
        def f(seed, t):
            return np.random.default_rng(seed * 7919 + t)
    """),
    ("SEED-DISCIPLINE", "src/repro/x.py", """
        import random
        def f():
            return random.randint(0, 10)
    """),
    ("SEED-DISCIPLINE", "src/repro/x.py", """
        import numpy as np
        def f(seed, t):
            rng = np.random.default_rng(np.random.SeedSequence((seed, t)))
            kids = np.random.SeedSequence(seed).spawn(4)
            return rng, kids
    """),
    ("SEED-DISCIPLINE", "benchmarks/x.py",
     "import numpy as np\nx = np.random.rand(3)\n"),
    ("SEED-DISCIPLINE", "src/repro/x.py",
     "import numpy as np\n"
     "x = np.random.rand(3)  # lint: disable=SEED-DISCIPLINE -- "
     "fixture noise, not a determinism surface\n"),
    ("SEED-DISCIPLINE", "src/repro/x.py",
     "import numpy as np\n"
     "x = np.random.rand(3)  # lint: disable=SEED-DISCIPLINE\n"),
    ("JIT-CACHE-BOUND", "src/repro/kernels/x/ops.py", """
        _JIT_CACHE: dict = {}
        _MESH_CACHE = dict()
    """),
    ("JIT-CACHE-BOUND", "src/repro/kernels/x/ops.py", """
        from repro.kernels.common import LruCache
        _JIT_CACHE = LruCache(16)
        def f():
            local_cache = {}  # function-local: bounded by the call
            return local_cache
    """),
    ("INT-RANK-ONLY", "src/repro/core/merging.py", """
        def f(inter, union, s):
            j = inter / union
            return j if s >= 0.5 else None
    """),
    ("INT-RANK-ONLY", "src/repro/core/merging.py", """
        def f(inter, union):
            return (inter << 15) // max(union, 1)
    """),
    ("INT-RANK-ONLY", "src/repro/core/summary_ir.py", "x = 1 / 3\n"),
    ("NONDET-ITER", "src/repro/core/pruning.py", """
        def f(xs, d):
            touched = set(xs)
            for w in touched:
                d[w] = True
            return [k for k in d.keys()]
    """),
    ("NONDET-ITER", "src/repro/core/pruning.py", """
        def f(xs):
            return list({x + 1 for x in xs})
    """),
    ("NONDET-ITER", "src/repro/core/pruning.py", """
        def f(xs, d):
            for w in sorted(set(xs)):
                d[w] = True
            for k, v in d.items():  # dicts iterate in insertion order
                pass
    """),
    ("NO-RECURSION-LIMIT", "src/repro/core/x.py",
     "import sys\nsys.setrecursionlimit(100000)\n"),
    ("NO-RECURSION-LIMIT", "src/repro/core/x.py",
     "import sys\n"
     "# lint: disable=NO-RECURSION-LIMIT -- scoped reference-emitter "
     "bump, restored in finally\n"
     "sys.setrecursionlimit(100000)\n"),
    ("TIME-MONOTONIC", "benchmarks/run.py",
     "import time\nt0 = time.time()\n"),
    ("TIME-MONOTONIC", "src/repro/launch/x.py",
     "import time\nt0 = time.time()\n"),
    ("TIME-MONOTONIC", "src/repro/core/x.py",
     "import time\nt0 = time.time()\n"),
    ("TIME-MONOTONIC", "benchmarks/run.py",
     "import time\nt0 = time.perf_counter()\n"),
    ("TIME-MONOTONIC", "benchmarks/run.py", """
        import time
        def main():
            t0 = time.time()
    """),
    ("ATOMIC-WRITE", "src/repro/x.py", """
        import json, os
        def save(payload, ckpt_dir):
            with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
                json.dump(payload, f)
    """),
    ("ATOMIC-WRITE", "src/repro/x.py", """
        import numpy as np
        def cut(sel, spill_dir):
            np.save(spill_dir + "/run-0.npy", sel)
    """),
    ("ATOMIC-WRITE", "src/repro/x.py", """
        import json, os
        def save(payload, ckpt_dir):
            path = os.path.join(ckpt_dir, "manifest.json")
            tmp = path + ".part"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
    """),
    ("ATOMIC-WRITE", "src/repro/x.py", """
        import json
        def load(ckpt_path, scratch):
            with open(ckpt_path) as f:          # read: fine
                payload = json.load(f)
            with open(scratch + "/log.txt", "w") as f:  # not durable
                f.write("hi")
            return payload
    """),
    ("ATOMIC-WRITE", "src/repro/x.py", """
        import json, os
        def committer(tmp, path):
            os.replace(tmp, path)
        def save(payload, ckpt_dir):
            with open(ckpt_dir + "/manifest.json", "w") as f:
                json.dump(payload, f)
    """),
    ("ATOMIC-WRITE", "src/repro/x.py",
     "import json\n"
     "def save(payload, cache_dir):\n"
     "    f = open(cache_dir + '/x.json', 'w')  "
     "# lint: disable=ATOMIC-WRITE -- "
     "append-only debug log, torn tail is acceptable\n"
     "    json.dump(payload, f)\n"),
]


def port_path(ref_path: str) -> str:
    """The reference's path mapped to the port's: the package prefix, and
    `benchmarks/` to the measuring tools at the root."""
    if ref_path.startswith("src/repro/"):
        return "src/repro_torch/" + ref_path[len("src/repro/"):]
    return {"benchmarks/run.py": "chip_smoke.py",
            "benchmarks/x.py": "flash_bench.py"}[ref_path]


def _fields(f, message=True):
    d = dataclasses.asdict(f)
    d.pop("path")
    if not message:
        d.pop("message")
    return d


@pytest.mark.parametrize("rule,path,src", PARITY,
                         ids=[f"{r}-{i}" for i, (r, _, _) in
                              enumerate(PARITY)])
def test_shared_rules_match_the_reference(rule, path, src):
    """Equal findings (all but the path, which maps by prefix), equal
    suppressions with their reasons, on the reference's own fixtures.
    JIT-CACHE-BOUND's message names the port's remedy, not the
    reference's `LruCache`."""
    src = textwrap.dedent(src)
    ref = ref_core.lint_source(src, path, [ref_rules.rules_by_name()[rule]])
    got = port_core.lint_source(src, port_path(path),
                                [port_rules.rules_by_name()[rule]])
    message = rule != "JIT-CACHE-BOUND"
    assert [_fields(f, message) for f in got.findings] == [
        _fields(f, message) for f in ref.findings]
    assert all(f.path == port_path(path) for f in got.findings)
    assert [(_fields(f), r) for f, r in got.suppressed] == [
        (_fields(f), r) for f, r in ref.suppressed]
    assert got.errors == ref.errors and got.files_scanned == 1


def test_parity_fixtures_cover_each_shared_rule_firing():
    fired = set()
    for rule, path, src in PARITY:
        res = port_core.lint_source(textwrap.dedent(src), port_path(path),
                                    [port_rules.rules_by_name()[rule]])
        if res.findings:
            fired.add(rule)
    assert fired == {"SEED-DISCIPLINE", "JIT-CACHE-BOUND", "INT-RANK-ONLY",
                     "NONDET-ITER", "NO-RECURSION-LIMIT", "TIME-MONOTONIC",
                     "ATOMIC-WRITE"}


def test_unparsable_source_is_an_error_in_both_engines():
    src = "def f(:\n"
    ref = ref_core.lint_source(src, "src/repro/x.py", ref_rules.RULES)
    got = port_core.lint_source(src, "src/repro/x.py", RULES)
    assert got.errors == ref.errors and len(got.errors) == 1


def test_both_engines_apply_baselines_alike():
    def finding(mod, **kw):
        base = dict(rule="TIME-MONOTONIC", path="chip_smoke.py", line=3,
                    col=9, symbol="main", message="m",
                    snippet="t0 = time.time()")
        return mod.Finding(**{**base, **kw})

    specs = [{}, {}, {"symbol": "other"}, {"rule": "ATOMIC-WRITE"}]
    entries = [
        {"rule": "TIME-MONOTONIC", "path": "chip_smoke.py",
         "symbol": "main", "snippet": "t0 = time.time()",
         "justification": "timestamp"},
        {"rule": "TIME-MONOTONIC", "path": "chip_smoke.py",
         "symbol": "gone", "snippet": "t0 = time.time()",
         "justification": "stale"},
        {"rule": "ATOMIC-WRITE", "path": "chip_smoke.py",
         "symbol": "main", "snippet": "t0 = time.time()",
         "justification": ""},
    ]

    def outcome(core, baseline):
        m = baseline.apply_baseline([finding(core, **s) for s in specs],
                                    entries)
        return ([_fields(f) for f in m.new],
                [(_fields(f), j) for f, j in m.matched], m.stale,
                m.unjustified, m.size)

    assert outcome(port_core, port_baseline) == outcome(ref_core,
                                                        ref_baseline)
    assert port_baseline.entry_key(entries[0]) == ref_baseline.entry_key(
        entries[0])


# ---------------------------------------------------------------- meta
def test_full_tree_is_lint_clean():
    """The gate, as a tier-1 test: no new findings, no stale or
    unjustified baseline entries, over the port, the tests and the
    measuring tools (the CLI's default paths)."""
    result = lint_paths(REPO, list(DEFAULT_PATHS), RULES)
    assert result.errors == []
    assert result.files_scanned > 100
    match = apply_baseline(result.findings, load_baseline())
    assert [f.render() for f in match.new] == []
    assert match.stale == []
    assert match.unjustified == []
    assert all(reason.strip() for _, reason in result.suppressed)


def test_checked_in_baseline_holds_the_reference_counterparts():
    """Exactly the two intentional exemptions of the approximate engine,
    the counterparts of the reference's two entries, each justified."""
    entries = load_baseline()
    ref_entries = ref_baseline.load_baseline()
    assert [(e["rule"], e["path"], e["symbol"]) for e in entries] == [
        (e["rule"], port_path(e["path"]), e["symbol"]) for e in ref_entries]
    for e in entries:
        assert len(e.get("justification", "").strip()) > 20


def test_no_port_module_inlines_the_float_saving_view():
    """The approximate engine reads `GroupWorkspace.savings`; the float
    view of the Saving terms lives only in `core/merging.py`'s two views,
    each under its inline suppression."""
    result = lint_paths(REPO, ["src/repro_torch"], [INT_RANK_ONLY()])
    views = sorted((f.path, f.symbol) for f, _ in result.suppressed)
    assert views == [
        ("src/repro_torch/core/merging.py",
         "BatchedGroupWorkspace.savings_rows"),
        ("src/repro_torch/core/merging.py", "GroupWorkspace.savings")]
    assert {(f.path, f.symbol) for f in result.findings} == {
        ("src/repro_torch/core/distributed.py", "group_jaccard_scores"),
        ("src/repro_torch/core/distributed.py", "summarize_jax")}


def test_cli_stats_report(tmp_path):
    from repro_torch.analysis.lint import main

    out = tmp_path / "report.json"
    code = main(["--root", REPO, "--stats", "--stats-out", str(out)])
    assert code == 0
    stats = json.loads(out.read_text())
    assert stats["rules_active"] == 10
    assert stats["new_findings"] == 0
    assert stats["baseline_size"] == 2
    assert stats["files_scanned"] > 100
    assert stats["per_rule"]["INT-RANK-ONLY"] == {
        "new": 0, "baselined": 2, "suppressed": 2}
    assert set(stats["per_rule"]) == {r.name for r in RULES}


def test_cli_exit_codes(tmp_path):
    from repro_torch.analysis.lint import main

    mod = tmp_path / "src" / "repro_torch" / "launch"
    mod.mkdir(parents=True)
    (mod / "x.py").write_text("import time\nt0 = time.time()\n")
    empty = tmp_path / "empty.json"
    empty.write_text('{"entries": []}')
    assert main(["src", "--root", str(tmp_path), "--baseline",
                 str(empty)]) == 1
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"entries": [
        {"rule": "TIME-MONOTONIC", "path": "src/repro_torch/launch/y.py",
         "symbol": "<module>", "snippet": "t0 = time.time()",
         "justification": "the code it excused is gone"}]}))
    (mod / "x.py").write_text("import time\nt0 = time.perf_counter()\n")
    assert main(["src", "--root", str(tmp_path), "--baseline",
                 str(stale)]) == 2
    assert main(["src", "--root", str(tmp_path), "--baseline",
                 str(empty)]) == 0


def _fresh(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


HEAVY = "('torch', 'numpy', 'jax', 'jaxlib', 'repro')"


def test_cli_runs_without_torch_numpy_jax_or_repro_loaded():
    out = _fresh(
        "import runpy, sys\n"
        "sys.argv = ['lint', '--list-rules']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.analysis.lint', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {HEAVY})\n"
        "print('LOADED', bad)\n")
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    assert out.stdout.count("    scope: ") == 10
    scopes = [ln for ln in out.stdout.splitlines() if "scope:" in ln]
    assert all("src/repro/" not in ln and "benchmarks/" not in ln
               for ln in scopes)


def test_package_import_stays_light_and_summarize_resolves_on_use():
    out = _fresh(
        "import sys\n"
        "import repro_torch\n"
        f"light = sorted(m for m in sys.modules if m.split('.')[0] in {HEAVY})\n"
        "from repro_torch import summarize, SluggerState\n"
        "import repro_torch.core.slugger as S\n"
        "assert summarize is S.summarize is repro_torch.summarize\n"
        "assert SluggerState is S.SluggerState\n"
        "assert repro_torch.Summary.__name__ == 'Summary'\n"
        "assert repro_torch.SummarizerEngine.__name__ == 'SummarizerEngine'\n"
        "assert set(repro_torch.__all__) <= set(dir(repro_torch))\n"
        "try:\n"
        "    repro_torch.not_an_entry_point\n"
        "except AttributeError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('no AttributeError')\n"
        "print('LIGHT', light)\n")
    assert out.returncode == 0, out.stderr
    assert "LIGHT []" in out.stdout
