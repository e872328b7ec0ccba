"""CLI for the port's invariant linter.

    python -m repro_torch.analysis.lint [paths...]   # default: DEFAULT_PATHS
    python -m repro_torch.analysis.lint --list-rules
    python -m repro_torch.analysis.lint --stats      # also writes artifacts/lint_report_torch.json

Exit codes: 0 clean (every finding suppressed or baselined), 1 new
findings, 2 baseline problems (stale or unjustified entries, or
unparsable files). Stdlib-only and <10s cold — it runs as the first CI
gate, before any heavy import.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.baseline import (DEFAULT_BASELINE,
                                           apply_baseline, entry_key,
                                           load_baseline)
from repro_torch.analysis.core import lint_paths
from repro_torch.analysis.rules import RULES, TOOLS

# the port, every test (KERNEL-TRIPLE reads which kernels they reach) and
# the measuring tools at the root
DEFAULT_PATHS = ("src/repro_torch", "tests") + TOOLS


def find_repo_root(start: str) -> str:
    """Nearest ancestor holding a .git dir (fallback: cwd)."""
    d = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(d, ".git")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start)
        d = parent


def build_stats(result, match) -> dict:
    per_rule: dict = {r.name: {"new": 0, "baselined": 0, "suppressed": 0}
                      for r in RULES}
    for f in match.new:
        per_rule.setdefault(f.rule, {"new": 0, "baselined": 0,
                                     "suppressed": 0})["new"] += 1
    for f, _ in match.matched:
        per_rule[f.rule]["baselined"] += 1
    for f, _ in result.suppressed:
        per_rule[f.rule]["suppressed"] += 1
    return {
        "files_scanned": result.files_scanned,
        "rules_active": len(RULES),
        "baseline_size": match.size,
        "stale_baseline_entries": len(match.stale),
        "unjustified_baseline_entries": len(match.unjustified),
        "new_findings": len(match.new),
        "suppressed_findings": len(result.suppressed),
        "parse_errors": len(result.errors),
        "per_rule": per_rule,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The port's invariant linter: determinism, seeding, "
                    "device-residency and kernel-binding contracts as "
                    "named, static rules.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs relative to the repo root "
                         "(default: " + " ".join(DEFAULT_PATHS) + ")")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON (default: the checked-in one)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: nearest .git ancestor)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--stats", action="store_true",
                    help="emit a JSON findings summary")
    ap.add_argument("--stats-out", default="artifacts/lint_report_torch.json",
                    help="where --stats writes its JSON "
                         "(repo-root-relative)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in RULES:
            print(f"{rule.name}: {rule.summary}")
            scope = ", ".join(rule.scope) or "everywhere"
            print(f"    scope: {scope}")
        return 0

    root = args.root or find_repo_root(os.getcwd())
    paths = args.paths or list(DEFAULT_PATHS)
    result = lint_paths(root, paths, RULES)
    entries = load_baseline(args.baseline)
    # only entries whose path was actually scanned can be declared stale
    scanned_prefixes = tuple(p.rstrip("/") for p in paths)

    def _in_scan(entry):
        p = entry.get("path", "")
        return any(p == s or p.startswith(s + "/") for s in scanned_prefixes)

    match = apply_baseline(result.findings,
                           [e for e in entries if _in_scan(e)])
    match.size = len(entries)

    for err in result.errors:
        print(f"error: cannot parse {err}", file=sys.stderr)
    for f in sorted(match.new, key=lambda f: (f.path, f.line, f.rule)):
        print(f.render())
    for e in match.stale:
        print(f"stale baseline entry (code changed; delete it): "
              f"{entry_key(e)}", file=sys.stderr)
    for e in match.unjustified:
        print(f"baseline entry without justification (mandatory): "
              f"{entry_key(e)}", file=sys.stderr)

    if args.stats:
        stats = build_stats(result, match)
        out = os.path.join(root, args.stats_out)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w", encoding="utf-8") as fh:
            json.dump(stats, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(json.dumps(stats, indent=2, sort_keys=True))

    if match.new:
        print(f"\n{len(match.new)} new finding(s) across "
              f"{result.files_scanned} files "
              f"({len(result.suppressed)} suppressed, "
              f"{len(match.matched)} baselined).", file=sys.stderr)
        return 1
    if match.stale or match.unjustified or result.errors:
        return 2
    print(f"clean: {result.files_scanned} files, {len(RULES)} rules, "
          f"{len(result.suppressed)} suppressed, "
          f"{len(match.matched)} baselined.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
