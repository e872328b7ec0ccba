"""The port's invariant catalog: one `Rule` per contract of `repro.analysis`
that the port shares, in PyTorch's idiom and scoped to `src/repro_torch/`
and the measuring tools at the root of the checkout (``TOOLS``).

Every rule keeps its reference name, its contract (naming the port's
modules) and the incident that motivated it. Suppress a deliberate
exception inline with

    # lint: disable=RULE -- why this site is exempt

or grandfather it in ``baseline.json`` with a written justification.

Ten rules. The reference's DTYPE-WIDTH has no counterpart: it guards jax
with x64 disabled, where ``jnp.int64`` and an int64 upload silently become
int32. torch keeps int64 on the card, so that truncation cannot happen
here; the port's width hazard is on the CPU (torch ``uint32`` has no
``+``, no ``>>`` and no ``amin``), and the kernels' plain-version tests
hold it.

Scopes are disjoint from the reference's: no rule here applies under
`src/repro/` or `benchmarks/`, and no reference rule applies under
`src/repro_torch/`.
"""
from __future__ import annotations

import ast
import os
import re

from repro_torch.analysis.core import Finding, ModuleContext, Rule, TreeRule

PKG = "src/repro_torch/"
# the port's measuring tools at the repo root (the reference's benchmarks/)
TOOLS = ("chip_smoke.py", "flash_bench.py", "popc_bench.py",
         "rank_count_bench.py", "serve_bench.py", "multi_rank_smoke.py")


def dotted(node) -> str:
    """Dotted name of an expression ('torch.cuda.manual_seed'), or ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _walk_calls(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _has_kw(call, name: str) -> bool:
    return any(k.arg == name for k in call.keywords)


# ---------------------------------------------------------------------------
# SEED-DISCIPLINE
# ---------------------------------------------------------------------------
class SEED_DISCIPLINE(Rule):
    name = "SEED-DISCIPLINE"
    summary = ("RNG must flow through SeedSequence.spawn or a seeded "
               "torch.Generator — no global-state RNG (numpy, stdlib or "
               "torch), no hand-rolled seed arithmetic")
    contract = (
        "Determinism across partitions/backends/thread schedules rests on "
        "every RNG stream being a SeedSequence child or a torch.Generator "
        "seeded from one. Arithmetic on raw seeds aliases: the reference's "
        "early `seed * 7919 + t` collided (seed=0, t=7919 ≡ seed=1, t=0) "
        "and silently correlated iterations. Global-state RNG "
        "(`np.random.rand`, stdlib `random.*`, `torch.manual_seed`, a "
        "`torch.randn` or `.normal_()` with no `generator=`) is "
        "order-dependent and thread-hostile: one draw anywhere shifts "
        "every later one. Flags: legacy `np.random.<fn>()` draws, stdlib "
        "`random.<fn>()` draws, `torch.manual_seed`/`torch.cuda.manual_"
        "seed(_all)`/`torch.seed`, torch draws and in-place draws without "
        "a `generator=` keyword, and `default_rng`/`SeedSequence`/"
        "`Generator(...).manual_seed` whose seed is an arithmetic "
        "expression. Derive streams with `SeedSequence(seed).spawn(n)` or "
        "entropy tuples `SeedSequence((seed, tag))`, and draw on the card "
        "from `torch.Generator(device=...).manual_seed(seed)` "
        "(core/engine.py, models/api.py).")
    scope = (PKG,)
    exclude = (PKG + "analysis/",)

    _LEGACY_NP = {
        "seed", "rand", "randn", "randint", "random", "random_sample",
        "choice", "shuffle", "permutation", "normal", "uniform", "zipf",
        "poisson", "binomial", "exponential", "bytes",
    }
    _STDLIB = {
        "seed", "random", "randint", "randrange", "choice", "choices",
        "shuffle", "sample", "uniform", "gauss", "getrandbits",
    }
    _SEEDED = ("default_rng", "SeedSequence")
    _TORCH_GLOBAL = {"torch.manual_seed", "torch.seed",
                     "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                     "torch.cuda.seed", "torch.cuda.seed_all",
                     "torch.random.manual_seed", "torch.random.seed"}
    _TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                    "bernoulli", "multinomial", "poisson", "rand_like",
                    "randn_like", "randint_like"}
    _INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_",
                      "exponential_", "cauchy_", "geometric_",
                      "log_normal_"}

    def check(self, ctx):
        has_stdlib_random = any(
            isinstance(n, ast.Import)
            and any(a.name == "random" for a in n.names)
            for n in ast.walk(ctx.tree))
        for call in _walk_calls(ctx.tree):
            fn = dotted(call.func)
            parts = fn.split(".")
            method = (call.func.attr if isinstance(call.func, ast.Attribute)
                      else "")
            if (len(parts) == 3 and parts[0] in ("np", "numpy")
                    and parts[1] == "random"
                    and parts[2] in self._LEGACY_NP):
                yield ctx.finding(self, call,
                                  f"legacy global-state RNG `{fn}()`; draw "
                                  f"from a `SeedSequence`-derived Generator")
            elif (has_stdlib_random and len(parts) == 2
                  and parts[0] == "random" and parts[1] in self._STDLIB):
                yield ctx.finding(self, call,
                                  f"stdlib `{fn}()` is global-state RNG; "
                                  f"use a `SeedSequence`-derived Generator")
            elif fn in self._TORCH_GLOBAL:
                yield ctx.finding(self, call,
                                  f"`{fn}()` seeds torch's global generator; "
                                  f"pass a seeded `torch.Generator` instead")
            elif ((len(parts) == 2 and parts[0] == "torch"
                   and parts[1] in self._TORCH_DRAWS
                   or method in self._INPLACE_DRAWS)
                  and not _has_kw(call, "generator")):
                what = fn or f".{method}"
                yield ctx.finding(self, call,
                                  f"`{what}()` without `generator=` draws "
                                  f"from torch's global generator; pass a "
                                  f"seeded `torch.Generator`")
            elif ((parts[-1] in self._SEEDED or method == "manual_seed")
                  and call.args
                  and isinstance(call.args[0], (ast.BinOp, ast.UnaryOp))):
                what = parts[-1] or method
                yield ctx.finding(
                    self, call,
                    f"hand-rolled seed arithmetic in `{what}(...)` can "
                    f"alias streams; spawn a child stream or pass an "
                    f"entropy tuple `SeedSequence((seed, tag))`")


# ---------------------------------------------------------------------------
# JIT-CACHE-BOUND
# ---------------------------------------------------------------------------
class JIT_CACHE_BOUND(Rule):
    name = "JIT-CACHE-BOUND"
    summary = ("module-level per-shape caches must be bounded "
               "(`functools.lru_cache(maxsize=N)`), never a bare dict")
    contract = (
        "A module-level dict keyed on padded shapes grows for the life of "
        "the process as batch shapes drift: the reference's early leak "
        "held one compiled executable a shape, forever, with its device "
        "buffers. The port has no such cache today; the rule guards the "
        "per-shape caches later work adds (CUDA graphs of decode, "
        "captured per batch and length, hold their memory pools). Any "
        "module-level assignment of a `{}`/`dict()`/`OrderedDict()` to a "
        "name containing 'CACHE' must be a bounded cache instead, such as "
        "a function under `functools.lru_cache(maxsize=N)`.")
    scope = (PKG,)
    exclude = (PKG + "analysis/",)

    def check(self, ctx):
        for node in ctx.tree.body:  # module level only
            targets = []
            value = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            for t in targets:
                if not (isinstance(t, ast.Name) and "CACHE" in t.id.upper()):
                    continue
                bare = isinstance(value, ast.Dict) or (
                    isinstance(value, ast.Call)
                    and dotted(value.func).split(".")[-1] in ("dict",
                                                              "OrderedDict"))
                if bare:
                    yield ctx.finding(
                        self, node,
                        f"module-level cache `{t.id}` is an unbounded dict; "
                        f"it grows a shape at a time — bound it "
                        f"(`functools.lru_cache(maxsize=N)`)")


# ---------------------------------------------------------------------------
# INT-RANK-ONLY
# ---------------------------------------------------------------------------
class INT_RANK_ONLY(Rule):
    name = "INT-RANK-ONLY"
    summary = ("no float division or float-literal comparison in the "
               "merge decision paths (rank/Saving/θ)")
    contract = (
        "Ranking and Saving acceptance run on integer-only keys "
        "(`rank_keys`, cross-product rational compares, quantized θ̂) so "
        "numpy, the CUDA kernels and the reference order candidates "
        "bit-identically — float division rounds differently across "
        "substrates and silently splits backends. "
        "In the decision-path modules (core/merging.py, "
        "core/distributed.py, kernels/bitset_fold/, its `rounds.py` "
        "included) true division `/` and float-literal comparisons are "
        "banned; float similarity VIEWS for diagnostics are fine but must "
        "be baselined or suppressed with a justification saying no "
        "decision reads them (DESIGN.md §9).")
    scope = (PKG + "core/merging.py", PKG + "core/distributed.py",
             PKG + "kernels/bitset_fold/")

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                yield ctx.finding(
                    self, node,
                    "float (true) division in a decision-path module; use "
                    "integer keys (`rank_keys`) / exact rational compares, "
                    "or justify the float view")
            elif isinstance(node, ast.Compare):
                operands = [node.left] + list(node.comparators)
                if any(isinstance(o, ast.Constant)
                       and isinstance(o.value, float) for o in operands):
                    yield ctx.finding(
                        self, node,
                        "comparison against a float literal in a "
                        "decision-path module; quantize to the integer "
                        "contract (theta_to_p / rank_keys)")


# ---------------------------------------------------------------------------
# NONDET-ITER
# ---------------------------------------------------------------------------
class NONDET_ITER(Rule):
    name = "NONDET-ITER"
    summary = ("no iteration over sets (or .keys()) in canonical-order "
               "paths without an explicit sorted(...)")
    contract = (
        "Merge replay, emission and pruning promise canonical order: "
        "summaries are bit-identical for any partition count, backend or "
        "thread schedule, and equal to the reference's, which every "
        "parity test leans on. Iterating a set (or materializing one via "
        "list()/np.asarray()/torch.tensor()) exposes hash-table order — "
        "stable only by accident of insertion history. In the "
        "canonical-order modules, wrap set iteration in `sorted(...)` "
        "(insertion-ordered dict iteration is allowed; the determinism "
        "argument covers it). Motivated by the exchange replay contract "
        "(DESIGN.md §8).")
    scope = (PKG + "core/slugger.py", PKG + "core/engine.py",
             PKG + "core/merging.py", PKG + "core/encode_batched.py",
             PKG + "core/encode_dp.py", PKG + "core/pruning.py",
             PKG + "core/summary.py", PKG + "core/summary_ir.py",
             PKG + "core/minhash.py", PKG + "graphs/partitioned.py",
             PKG + "graphs/csr.py")

    _MATERIALIZERS = ("list", "tuple", "np.asarray", "np.array",
                      "numpy.asarray", "numpy.array", "np.fromiter",
                      "enumerate", "torch.tensor", "torch.as_tensor")

    def _set_names(self, func_node):
        """Local names bound to an obvious set expression in this scope."""
        names = set()
        for node in ast.walk(func_node):
            if isinstance(node, ast.Assign) and self._is_set_expr(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        return names

    @staticmethod
    def _is_set_expr(node) -> bool:
        return (isinstance(node, (ast.Set, ast.SetComp))
                or (isinstance(node, ast.Call)
                    and dotted(node.func) in ("set", "frozenset")))

    def _is_set_valued(self, node, set_names) -> bool:
        if self._is_set_expr(node):
            return True
        if isinstance(node, ast.Name) and node.id in set_names:
            return True
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "keys"):
            return True
        return False

    def check(self, ctx):
        funcs = [n for n in ast.walk(ctx.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        scopes = [(f, self._set_names(f)) for f in funcs] or [(ctx.tree,
                                                               set())]
        seen = set()
        for func, set_names in scopes:
            for node in ast.walk(func):
                iters = []
                if isinstance(node, ast.For):
                    iters.append(node.iter)
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp, ast.DictComp)):
                    iters.extend(g.iter for g in node.generators)
                elif (isinstance(node, ast.Call)
                      and dotted(node.func) in self._MATERIALIZERS
                      and node.args):
                    iters.append(node.args[0])
                for it in iters:
                    if (self._is_set_valued(it, set_names)
                            and id(it) not in seen):
                        seen.add(id(it))
                        yield ctx.finding(
                            self, it,
                            "iteration over a set exposes hash order in a "
                            "canonical-order path; wrap in `sorted(...)`")


# ---------------------------------------------------------------------------
# NO-RECURSION-LIMIT
# ---------------------------------------------------------------------------
class NO_RECURSION_LIMIT(Rule):
    name = "NO-RECURSION-LIMIT"
    summary = "`sys.setrecursionlimit` is banned"
    contract = (
        "Raising the interpreter recursion limit is how the reference's "
        "seed emitter masked an O(height) recursive DP until deep forests "
        "overflowed the C stack anyway; the flat IR replaced the production "
        "emitter with level-synchronous array passes (the port's "
        "core/encode_batched.py). New code must be iterative. The one "
        "sanctioned exception (the reference emitter kept for "
        "cross-checking, scoped and restored in a finally) carries an "
        "inline suppression (core/slugger.py).")
    scope = (PKG,) + TOOLS

    def check(self, ctx):
        for call in _walk_calls(ctx.tree):
            if dotted(call.func).split(".")[-1] == "setrecursionlimit":
                yield ctx.finding(
                    self, call,
                    "`sys.setrecursionlimit` call; restructure to "
                    "iteration (flat IR / explicit stack)")


# ---------------------------------------------------------------------------
# HOST-SYNC-IN-LOOP
# ---------------------------------------------------------------------------
class HOST_SYNC_IN_LOOP(Rule):
    name = "HOST-SYNC-IN-LOOP"
    summary = ("device→host syncs inside round/carry loops must be "
               "transfer-accounted (TransferCounter)")
    contract = (
        "The resident backend's byte ledger (steady-state upload 0 B, "
        "bytes a round and an iteration, `chip_smoke.py`'s resident "
        "phase) assumes EVERY host↔device crossing reports to "
        "`core.transfer`. A stray `.item()`/`.tolist()`/`.cpu()`/"
        "`.numpy()`/`.to(\"cpu\")`/`torch.cuda.synchronize()` (or "
        "`np.asarray` of a call or device-state attribute) inside a "
        "merge-round or carry loop is an unaccounted blocking sync: it "
        "corrupts the ledger and serializes the card's stream. In the "
        "residency modules, any such sync lexically inside a for/while "
        "whose enclosing function never calls "
        "`add_d2h`/`add_h2d` (core/transfer.py) is flagged "
        "(DESIGN.md §9).")
    scope = (PKG + "core/resident.py", PKG + "core/merging.py",
             PKG + "core/engine.py", PKG + "kernels/bitset_fold/")

    _SYNC_FNS = {"np.asarray", "numpy.asarray"}
    _SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

    @staticmethod
    def _is_cpu(node) -> bool:
        if isinstance(node, ast.Constant):
            return node.value == "cpu"
        return (isinstance(node, ast.Call)
                and dotted(node.func) == "torch.device" and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "cpu")

    def _is_sync(self, call) -> bool:
        fn = dotted(call.func)
        if fn in self._SYNC_FNS:
            # only flag materialization of a call result or device-state
            # attribute (`self._bits`-style) — host-array reshuffles with a
            # plain name argument are not syncs
            arg = call.args[0] if call.args else None
            return isinstance(arg, ast.Call) or (
                isinstance(arg, ast.Attribute) and arg.attr.startswith("_"))
        if fn == "torch.cuda.synchronize":
            return True
        if not isinstance(call.func, ast.Attribute):
            return False
        if call.func.attr in self._SYNC_METHODS:
            return not call.args
        if call.func.attr == "to":
            dev = [k.value for k in call.keywords if k.arg == "device"]
            return any(self._is_cpu(a) for a in call.args[:1] + dev)
        return False

    def check(self, ctx):
        funcs = [n for n in ast.walk(ctx.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for func in funcs:
            accounted = any(
                isinstance(c.func, ast.Attribute)
                and c.func.attr in ("add_d2h", "add_h2d")
                for c in _walk_calls(func))
            if accounted:
                continue
            for loop in ast.walk(func):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                for call in _walk_calls(loop):
                    if self._is_sync(call):
                        yield ctx.finding(
                            self, call,
                            "device sync inside a loop with no transfer "
                            "accounting in scope; route it through "
                            "`TransferCounter.add_d2h/add_h2d`")


# ---------------------------------------------------------------------------
# ITER-REUPLOAD
# ---------------------------------------------------------------------------
class ITER_REUPLOAD(Rule):
    name = "ITER-REUPLOAD"
    summary = ("no host→device upload of a loop-invariant tensor inside "
               "an iteration loop")
    contract = (
        "The adjacency bank (`ResidentAdjacencyBank`, core/resident.py) "
        "exists because re-shipping unchanged state every iteration was "
        "the dominant cost (in the reference, 79MB/iteration of "
        "`phase=upload` at 220k edges). The bug class: an upload — "
        "`torch.as_tensor(x, device=...)`, `torch.tensor(x, device=...)`, "
        "`x.to(<device>)`, `x.cuda()` or the arena's `_put(x, device)` — "
        "inside a for/while, of a tensor whose root name (through "
        "`torch.from_numpy(...)`, `.view(...)` and the like) is NEVER "
        "assigned in that loop's body: an iteration-invariant tensor "
        "uploaded once per iteration instead of once per run. Hoist the "
        "upload out of the loop, or carry the state on the card across "
        "iterations (DESIGN.md §9). Slabs built inside the loop (assigned "
        "in its body) are per-iteration payloads and stay legal; a "
        "`.to(dtype)` cast is not an upload.")
    scope = (PKG + "core/resident.py", PKG + "core/engine.py",
             PKG + "kernels/")

    _FACTORIES = {"torch.as_tensor", "torch.tensor"}

    @staticmethod
    def _assigned_names(loop) -> set:
        names = set()
        for node in ast.walk(loop):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                 ast.NamedExpr)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name):
                            names.add(leaf.id)
            elif isinstance(node, (ast.For, ast.comprehension)):
                for leaf in ast.walk(node.target):
                    if isinstance(leaf, ast.Name):
                        names.add(leaf.id)
        return names

    @staticmethod
    def _is_device(node) -> bool:
        """A device expression: a string ('cuda', 'cuda:0'), a
        `torch.device(...)` call, or a name whose last part names a
        device (`device`, `self.device`, `x.device`, `dev`)."""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, str)
        if isinstance(node, ast.Call):
            return dotted(node.func) == "torch.device"
        last = dotted(node).split(".")[-1].lower()
        return "device" in last or last in ("dev", "cuda")

    # calls that wrap their first argument's data, and methods that view
    # or cast their receiver's: the upload still carries that data
    _WRAPPERS = {"torch.from_numpy", "torch.as_tensor", "torch.tensor",
                 "np.asarray", "np.ascontiguousarray", "np.array",
                 "numpy.asarray", "numpy.ascontiguousarray", "numpy.array"}
    _VIEWS = {"view", "reshape", "contiguous", "astype", "to", "flatten",
              "ravel", "squeeze", "unsqueeze", "pin_memory", "long", "int",
              "float", "bool"}

    def _root_name(self, node):
        """The host name a tensor expression is built from, through
        subscripts, wrapping calls (`torch.from_numpy(x)`) and view or cast
        methods (`.view(...)`, `.contiguous()`); None for an attribute or
        any other call, whose result the loop may compute afresh."""
        while True:
            if isinstance(node, ast.Name):
                return node.id
            if isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Call) and node.args and (
                    dotted(node.func) in self._WRAPPERS):
                node = node.args[0]
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in self._VIEWS):
                node = node.func.value
            else:
                return None

    def _uploaded(self, call):
        """The uploaded expression if ``call`` is an upload, else None."""
        fn = dotted(call.func)
        if fn in self._FACTORIES:
            dev = [k.value for k in call.keywords if k.arg == "device"]
            if call.args and dev and not (
                    isinstance(dev[0], ast.Constant)
                    and dev[0].value in (None, "cpu")):
                return call.args[0]
            return None
        if fn.split(".")[-1] == "_put":
            return call.args[0] if call.args else None
        if not isinstance(call.func, ast.Attribute):
            return None
        if call.func.attr == "cuda":
            return call.func.value
        if call.func.attr == "to":
            dev = [k.value for k in call.keywords if k.arg == "device"]
            target = dev[0] if dev else (call.args[0] if call.args else None)
            if target is not None and self._is_device(target) and not (
                    isinstance(target, ast.Constant)
                    and target.value == "cpu"):
                return call.func.value
        return None

    def check(self, ctx):
        calls: list = []

        def visit(node, loop):
            if isinstance(node, (ast.For, ast.While)):
                loop = node
            elif isinstance(node, ast.Call) and loop is not None:
                calls.append((node, loop))
            for child in ast.iter_child_nodes(node):
                visit(child, loop)

        visit(ctx.tree, None)
        assigned: dict = {}
        for call, loop in calls:
            expr = self._uploaded(call)
            name = None if expr is None else self._root_name(expr)
            if name is None:
                continue
            key = id(loop)
            if key not in assigned:
                assigned[key] = self._assigned_names(loop)
            if name in assigned[key]:
                continue
            yield ctx.finding(
                self, call,
                f"host→device upload of loop-invariant `{name}` inside an "
                f"iteration loop; hoist it out of the loop or carry it on "
                f"the card across iterations")


# ---------------------------------------------------------------------------
# KERNEL-TRIPLE
# ---------------------------------------------------------------------------
_EXTERN_C = re.compile(r'extern\s+"C"\s+[^;{}()]*?\b(\w+)\s*\(([^)]*)\)\s*\{')
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def _blank(match) -> str:
    """A comment blanked to its newlines, so offsets keep their lines."""
    return re.sub(r"[^\n]", " ", match.group(0))


def extern_c_definitions(source: str) -> dict:
    """``{name: (line, parameter count)}`` of every ``extern "C"``
    function DEFINED in a CUDA source (comments ignored)."""
    text = _COMMENT.sub(_blank, source)
    out = {}
    for m in _EXTERN_C.finditer(text):
        params = m.group(2).strip()
        count = 0 if params in ("", "void") else params.count(",") + 1
        out[m.group(1)] = (text.count("\n", 0, m.start(1)) + 1, count)
    return out


def launcher_table(source: str, relpath: str) -> dict:
    """``{name: (line, argtypes count)}`` of the module-level ``LAUNCHERS``
    dict of `kernels/_build.py`, read by AST (the module imports torch)."""
    out = {}
    for node in ast.parse(source, filename=relpath).body:
        value = None
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "LAUNCHERS"
                for t in node.targets):
            value = node.value
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)
              and node.target.id == "LAUNCHERS"):
            value = node.value
        if not isinstance(value, ast.Dict):
            continue
        for k, v in zip(value.keys, value.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                n = len(v.elts) if isinstance(v, (ast.Tuple, ast.List)) else -1
                out[k.value] = (k.lineno, n)
    return out


def launcher_uses(ctx: ModuleContext):
    """``(node, name)`` of every launcher a module names: the first
    argument of `_build.launch(...)`, and attributes looked up on
    `load_library()` (directly or through a name bound to it)."""
    lib_names = set()
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and dotted(node.value.func).split(".")[-1] == "load_library"):
            lib_names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call)
                and dotted(node.func) in ("_build.launch", "launch")
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            yield node, node.args[0].value
        elif isinstance(node, ast.Attribute) and (
                isinstance(node.value, ast.Name)
                and node.value.id in lib_names
                or isinstance(node.value, ast.Call)
                and dotted(node.value.func).split(".")[-1] == "load_library"):
            yield node, node.attr


class KERNEL_TRIPLE(TreeRule):
    name = "KERNEL-TRIPLE"
    summary = ("every kernels/<name>/ ships kernel.py + ops.py + ref.py, is "
               "referenced by a port test, and names only bound launchers "
               "that csrc/ defines at their arity")
    contract = (
        "The kernel contract: `kernel.py` (the wrapper that launches the "
        "hand-written CUDA kernel, or its plain version for a CPU "
        "tensor), `ops.py` (dispatch), `ref.py` (the plain PyTorch twin "
        "the parity tests pin the kernel to). A kernel directory missing "
        "a leg — or not referenced by a `tests/test_torch_*.py` — has no "
        "enforced parity and WILL drift from the reference. The Python ↔ "
        "CUDA boundary is ctypes by name (`kernels/_build.py`): a "
        "launcher a `kernel.py` names must be a key of `_build.LAUNCHERS`; "
        "every key must be defined `extern \"C\"` in a `csrc/*.cu` with as "
        "many parameters as its argtypes tuple; every `*_launch` a "
        "`csrc/*.cu` defines must be bound there. A misspelled name or a "
        "wrong argument count otherwise fails only on the card "
        "(DESIGN.md §3/§9).")
    scope = (PKG + "kernels/",)

    _REQUIRED = ("kernel.py", "ops.py", "ref.py")

    def check_tree(self, root, relpaths):
        kdir = os.path.join(root, "src", "repro_torch", "kernels")
        if not os.path.isdir(kdir):
            return
        test_blob = ""
        tdir = os.path.join(root, "tests")
        if os.path.isdir(tdir):
            for fn in sorted(os.listdir(tdir)):
                if fn.startswith("test_torch_") and fn.endswith(".py"):
                    with open(os.path.join(tdir, fn),
                              encoding="utf-8") as fh:
                        test_blob += fh.read()
        build_rel = PKG + "kernels/_build.py"
        build_src = ""
        if os.path.isfile(os.path.join(root, build_rel)):
            with open(os.path.join(root, build_rel), encoding="utf-8") as fh:
                build_src = fh.read()
        launchers = launcher_table(build_src, build_rel)
        for name in sorted(os.listdir(kdir)):
            sub = os.path.join(kdir, name)
            if not os.path.isdir(sub) or name == "__pycache__":
                continue
            relsub = f"{PKG}kernels/{name}"
            for req in self._REQUIRED:
                if not os.path.isfile(os.path.join(sub, req)):
                    yield Finding(
                        rule=self.name, path=relsub, line=1, col=0,
                        symbol="<package>", snippet=name,
                        message=(f"kernel package `{name}` is missing "
                                 f"`{req}` (kernel/ops/ref triple)"))
            if not re.search(rf"repro_torch[./]kernels[./]{re.escape(name)}",
                             test_blob):
                yield Finding(
                    rule=self.name, path=relsub, line=1, col=0,
                    symbol="<package>", snippet=name,
                    message=(f"kernel package `{name}` is not referenced "
                             f"by any tests/test_torch_*.py — no parity "
                             f"enforcement"))
            kpath = os.path.join(sub, "kernel.py")
            if not os.path.isfile(kpath):
                continue
            with open(kpath, encoding="utf-8") as fh:
                ctx = ModuleContext(f"{relsub}/kernel.py", fh.read())
            for node, launcher in launcher_uses(ctx):
                if launcher not in launchers:
                    yield ctx.finding(
                        self, node,
                        f"launcher `{launcher}` is not a key of "
                        f"`_build.LAUNCHERS`; it fails only on the card")
        yield from self._check_csrc(root, build_rel, build_src, launchers)

    def _check_csrc(self, root, build_rel, build_src, launchers):
        csrc = os.path.join(root, "src", "repro_torch", "csrc")
        defined = {}  # name -> (relpath, line, parameter count)
        if os.path.isdir(csrc):
            for fn in sorted(os.listdir(csrc)):
                if not fn.endswith(".cu"):
                    continue
                with open(os.path.join(csrc, fn), encoding="utf-8") as fh:
                    defs = extern_c_definitions(fh.read())
                for name, (line, count) in defs.items():
                    defined[name] = (f"{PKG}csrc/{fn}", line, count)
        build_lines = build_src.splitlines()
        for name, (line, count) in launchers.items():
            snippet = build_lines[line - 1].strip()
            if name not in defined:
                yield Finding(
                    rule=self.name, path=build_rel, line=line, col=0,
                    symbol="<module>", snippet=snippet,
                    message=(f"`LAUNCHERS[{name!r}]` has no `extern \"C\"` "
                             f"definition in csrc/*.cu"))
            elif defined[name][2] != count:
                yield Finding(
                    rule=self.name, path=build_rel, line=line, col=0,
                    symbol="<module>", snippet=snippet,
                    message=(f"`LAUNCHERS[{name!r}]` has {count} argtypes, "
                             f"its definition in {defined[name][0]} takes "
                             f"{defined[name][2]} parameters"))
        for name, (rel, line, _) in sorted(defined.items()):
            if name.endswith("_launch") and name not in launchers:
                yield Finding(
                    rule=self.name, path=rel, line=line, col=0,
                    symbol=name, snippet=name,
                    message=(f"`{name}` is defined but not bound in "
                             f"`_build.LAUNCHERS`; no wrapper can launch "
                             f"it"))


# ---------------------------------------------------------------------------
# TIME-MONOTONIC
# ---------------------------------------------------------------------------
class TIME_MONOTONIC(Rule):
    name = "TIME-MONOTONIC"
    summary = ("duration measurement uses time.perf_counter(), never "
               "time.time()")
    contract = (
        "`time.time()` is wall-clock: NTP steps/slews move it mid-"
        "measurement, which corrupts the durations the port's tools "
        "report and compare (a one-second step during a 3-second phase "
        "flips a 1.6x ratio). All duration measurement in launch/ and the "
        "measuring tools at the root (`chip_smoke.py`, `*_bench.py`, "
        "`multi_rank_smoke.py`) uses the monotonic "
        "`time.perf_counter()` (or CUDA events on the card); a genuine "
        "wall-clock timestamp (artifact metadata) takes an inline "
        "suppression.")
    scope = (PKG + "launch/",) + TOOLS

    def check(self, ctx):
        for call in _walk_calls(ctx.tree):
            if dotted(call.func) == "time.time":
                yield ctx.finding(
                    self, call,
                    "`time.time()` is not monotonic; use "
                    "`time.perf_counter()` for durations")


# ---------------------------------------------------------------------------
# ATOMIC-WRITE
# ---------------------------------------------------------------------------
class ATOMIC_WRITE(Rule):
    name = "ATOMIC-WRITE"
    summary = ("durable artifacts (checkpoints, caches, spill runs, "
               "manifests) are written temp-then-rename, never in place")
    contract = (
        "A kill mid-write leaves an in-place-written artifact truncated, "
        "and every consumer then trusts a half file: a torn checkpoint "
        "manifest resumes from garbage, a torn spill run merges partial "
        "edges into a LATER ingestion. The protocol (core/checkpoint.py, "
        "train/checkpoint.py, graphs/partitioned.py, kernels/_build.py's "
        "library) is write to a sibling temp path, then commit with the "
        "atomic `os.replace`/`os.rename`. Flags: `open(path, 'w'/'wb')`, "
        "`np.save`/`np.savez*` or `torch.save` whose path expression "
        "mentions a durable-artifact word (ckpt/checkpoint/artifact/cache/"
        "spill/sidecar/manifest) in a scope with no `os.replace`/"
        "`os.rename` commit.")
    scope = (PKG,) + TOOLS
    exclude = (PKG + "analysis/",)

    _KEYWORD = re.compile(
        r"ckpt|checkpoint|artifact|cache|spill|sidecar|manifest", re.I)
    _NP_SAVERS = {"np.save", "numpy.save", "np.savez", "numpy.savez",
                  "np.savez_compressed", "numpy.savez_compressed"}

    def _arg_text(self, node) -> str:
        """All identifiers + string literals in an expression subtree —
        the haystack the durable-artifact keywords are matched against."""
        parts = []
        for leaf in ast.walk(node):
            if isinstance(leaf, ast.Name):
                parts.append(leaf.id)
            elif isinstance(leaf, ast.Attribute):
                parts.append(leaf.attr)
            elif isinstance(leaf, ast.Constant) and isinstance(leaf.value, str):
                parts.append(leaf.value)
        return " ".join(parts)

    def _write_target(self, call):
        """The path expression of a durable write call, or None."""
        fn = dotted(call.func)
        if fn == "open":
            mode = None
            if len(call.args) >= 2:
                mode = call.args[1]
            for kw in call.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
                    and "w" in mode.value and call.args):
                return call.args[0]
            return None
        if fn in self._NP_SAVERS and call.args:
            return call.args[0]
        if fn == "torch.save":  # torch.save(obj, f)
            if len(call.args) >= 2:
                return call.args[1]
            return next((k.value for k in call.keywords if k.arg == "f"),
                        None)
        return None

    def check(self, ctx):
        # group calls by enclosing function scope: the quiet condition is
        # "this scope also commits with os.replace/os.rename"
        scopes: dict = {}

        def visit(node, scope):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = node
            elif isinstance(node, ast.Call):
                scopes.setdefault(id(scope), [[], False])
                entry = scopes[id(scope)]
                fn = dotted(node.func)
                if fn in ("os.replace", "os.rename"):
                    entry[1] = True
                else:
                    target = self._write_target(node)
                    if (target is not None
                            and self._KEYWORD.search(self._arg_text(target))):
                        entry[0].append(node)
            for child in ast.iter_child_nodes(node):
                visit(child, scope)

        visit(ctx.tree, ctx.tree)
        for writes, has_commit in scopes.values():
            if has_commit:
                continue
            for call in writes:
                yield ctx.finding(
                    self, call,
                    "in-place write of a durable artifact; write to a "
                    "sibling temp path and commit with `os.replace` so a "
                    "kill mid-write never leaves a torn file")


RULES = (SEED_DISCIPLINE(), JIT_CACHE_BOUND(), INT_RANK_ONLY(),
         NONDET_ITER(), NO_RECURSION_LIMIT(), HOST_SYNC_IN_LOOP(),
         ITER_REUPLOAD(), KERNEL_TRIPLE(), TIME_MONOTONIC(), ATOMIC_WRITE())


def rules_by_name():
    return {r.name: r for r in RULES}
