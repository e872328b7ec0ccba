"""Rule engine of the port's invariant linter (stdlib `ast`, no hard deps).

The engine of `repro.analysis.core`, kept as the port's own copy so that
`repro_torch.analysis` imports nothing of the JAX package: on the same
source and path both engines give equal `Finding`s.

A `Rule` inspects one parsed module at a time (`check(ctx)`) and yields
`Finding`s; a `TreeRule` additionally sees the whole checkout once
(`check_tree(root, relpaths)`) for cross-file contracts like the kernel
directory triple. `ModuleContext` carries the parsed tree, the raw source
lines, and a node → enclosing-qualname map so findings name the function
or class they live in (baseline matching keys on that symbol, not on line
numbers, so entries survive unrelated edits).

Suppression protocol: a finding on line L is silenced iff line L or L-1
carries ``# lint: disable=RULE[,RULE...] -- reason`` naming the rule. The
``-- reason`` part is MANDATORY — a suppression without a written
justification does not suppress (the finding stays, with a note), which
is what keeps inline exemptions as accountable as baseline entries.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=([A-Za-z0-9_,-]+)\s*(?:--\s*(\S.*))?")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int           # 0-based
    symbol: str        # enclosing qualname ("<module>" at top level)
    message: str
    snippet: str       # stripped source line — baseline identity component

    def key(self):
        """Line-number-free identity used for baseline matching."""
        return (self.rule, self.path, self.symbol, self.snippet)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.symbol}] {self.message}")


class Rule:
    """One named invariant. Subclasses set `name`/`summary`/`contract` and
    implement `check`; `scope` is a tuple of repo-relative posix path
    prefixes the rule applies to (empty = everywhere)."""

    name: str = ""
    summary: str = ""       # one line, shown by --list-rules
    contract: str = ""      # the full contract + motivating PR/bug
    scope: tuple = ()
    exclude: tuple = ()

    def applies(self, relpath: str) -> bool:
        if any(relpath.startswith(p) for p in self.exclude):
            return False
        return (not self.scope
                or any(relpath.startswith(p) for p in self.scope))

    def check(self, ctx: "ModuleContext"):
        return ()


class TreeRule(Rule):
    """A rule over the whole checkout (runs once, not per module)."""

    def check_tree(self, root: str, relpaths: list):
        return ()


class ModuleContext:
    """Parsed view of one module handed to every applicable rule."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self._qualname: dict = {}
        self._assign_qualnames(self.tree, "<module>")

    def _assign_qualnames(self, node, qual):
        for child in ast.iter_child_nodes(node):
            child_qual = qual
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                child_qual = (child.name if qual == "<module>"
                              else f"{qual}.{child.name}")
            self._qualname[child] = child_qual
            self._assign_qualnames(child, child_qual)

    def symbol_of(self, node) -> str:
        return self._qualname.get(node, "<module>")

    def snippet_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: Rule, node, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=rule.name, path=self.relpath, line=line,
                       col=getattr(node, "col_offset", 0),
                       symbol=self.symbol_of(node), message=message,
                       snippet=self.snippet_at(line))

    # ---------------------------------------------------------- suppression
    def suppression_for(self, finding: Finding):
        """Return the (rules, reason) suppression covering `finding`, or a
        (rules, None) malformed one, or None when no directive is present."""
        for line in (finding.line, finding.line - 1):
            if not (1 <= line <= len(self.lines)):
                continue
            m = _SUPPRESS_RE.search(self.lines[line - 1])
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(","))
                if finding.rule in rules:
                    return rules, m.group(2)
        return None


@dataclass
class LintResult:
    """Everything one linter pass learned, pre-baseline."""

    findings: list = field(default_factory=list)    # live (unsuppressed)
    suppressed: list = field(default_factory=list)  # (finding, reason)
    errors: list = field(default_factory=list)      # unparsable files
    files_scanned: int = 0


def _apply_suppressions(ctx: ModuleContext, findings, result: LintResult):
    for f in findings:
        sup = ctx.suppression_for(f)
        if sup is None:
            result.findings.append(f)
        elif sup[1] is None:
            result.findings.append(Finding(
                rule=f.rule, path=f.path, line=f.line, col=f.col,
                symbol=f.symbol, snippet=f.snippet,
                message=(f.message + " (suppression present but has no "
                         "'-- reason'; a justification is mandatory)")))
        else:
            result.suppressed.append((f, sup[1]))


def lint_source(source: str, relpath: str, rules) -> LintResult:
    """Lint one in-memory module — the test/fixture entry point."""
    result = LintResult(files_scanned=1)
    try:
        ctx = ModuleContext(relpath, source)
    except SyntaxError as e:
        result.errors.append(f"{relpath}: {e}")
        return result
    for rule in rules:
        if isinstance(rule, TreeRule) or not rule.applies(relpath):
            continue
        _apply_suppressions(ctx, list(rule.check(ctx)), result)
    return result


def collect_files(root: str, paths) -> list:
    """All .py files under `paths` (files or dirs, relative to `root`),
    as sorted repo-relative posix paths — the walk order is part of the
    deterministic-output contract."""
    out = []
    for p in paths:
        ap = os.path.join(root, p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            out.append(os.path.relpath(ap, root).replace(os.sep, "/"))
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = sorted(d for d in dirnames
                                 if not d.startswith(".")
                                 and d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    out.append(rel.replace(os.sep, "/"))
    return sorted(set(out))


def lint_paths(root: str, paths, rules) -> LintResult:
    """Lint every module under `paths`, then run the tree rules once."""
    result = LintResult()
    relpaths = collect_files(root, paths)
    for relpath in relpaths:
        with open(os.path.join(root, relpath), encoding="utf-8") as fh:
            source = fh.read()
        try:
            ctx = ModuleContext(relpath, source)
        except SyntaxError as e:
            result.errors.append(f"{relpath}: {e}")
            continue
        result.files_scanned += 1
        for rule in rules:
            if isinstance(rule, TreeRule) or not rule.applies(relpath):
                continue
            _apply_suppressions(ctx, list(rule.check(ctx)), result)
    for rule in rules:
        if isinstance(rule, TreeRule):
            result.findings.extend(rule.check_tree(root, relpaths))
    return result
