"""Grandfather list for the port's invariant linter (the machinery of
`repro.analysis.baseline`, with its own ``baseline.json``).

``baseline.json`` holds findings that are INTENTIONAL — each entry keys a
finding by its line-number-free identity `(rule, path, symbol, snippet)`
and carries a mandatory written justification. The CLI subtracts matched
entries from the live findings; anything left is NEW and fails the gate.

Staleness cuts the other way: a baseline entry no longer matched by any
live finding means the code it excused has changed — the entry must be
deleted (exit 2), so the list only ever shrinks by conscious edits and
the grandfathered debt is always real.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


@dataclass
class BaselineMatch:
    """Outcome of subtracting the baseline from one linter pass."""

    new: list = field(default_factory=list)        # findings not baselined
    matched: list = field(default_factory=list)    # (finding, justification)
    stale: list = field(default_factory=list)      # unmatched baseline entries
    unjustified: list = field(default_factory=list)  # entries w/o reason
    size: int = 0                                  # total baseline entries


def load_baseline(path: str = DEFAULT_BASELINE) -> list:
    """The checked-in entry list (possibly empty if the file is absent)."""
    if not os.path.isfile(path):
        return []
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return list(data.get("entries", []))


def entry_key(entry: dict):
    return (entry.get("rule", ""), entry.get("path", ""),
            entry.get("symbol", ""), entry.get("snippet", ""))


def apply_baseline(findings, entries) -> BaselineMatch:
    """Subtract `entries` from `findings` as a multiset keyed on
    Finding.key() — two identical snippets in one symbol need two
    entries, so baselining one occurrence never hides a second."""
    result = BaselineMatch(size=len(entries))
    budget: dict = {}
    for e in entries:
        just = (e.get("justification") or "").strip()
        if not just:
            result.unjustified.append(e)
            continue
        budget.setdefault(entry_key(e), []).append(e)
    for f in findings:
        bucket = budget.get(f.key())
        if bucket:
            entry = bucket.pop(0)
            result.matched.append((f, entry["justification"]))
        else:
            result.new.append(f)
    for bucket in budget.values():
        result.stale.extend(bucket)
    return result
