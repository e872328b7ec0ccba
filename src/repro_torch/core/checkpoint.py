"""Plan-log checkpointing for the summarizer engine (DESIGN.md §11).

The record-mode replay contract (DESIGN.md §8) makes the whole merge forest
a pure function of ``(graph, engine config, plan log)``: every iteration's
`MergePlan` list replays in one canonical order via `merging.apply_plans`,
and the per-iteration RNG streams are respawned from the engine seed. So a
crash-safe checkpoint does not need the O(n) summarizer state at all — it
is just the tiny plan log plus enough identity to refuse a mismatched
resume:

    <dir>/it_<t>/            committed atomically (write tmp, rename)
        manifest.json        {version, t, fingerprint, config, counts}
        plans.npz            plan log for iterations 1..t, COLUMNAR: each
                             iteration's thousands of small per-plan arrays
                             are flattened into six int64 arrays
                             (members/rounds/pairs + their lengths)

Checkpoints are self-contained (each holds the FULL log so far — plans are
KBs, not GBs), which keeps GC trivial: retain the last ``keep`` dirs, and
resume only ever reads the newest. The commit protocol is
write-temp-then-``os.rename``: a kill mid-save leaves only a ``.tmp`` dir,
which the next writer (or `load_latest`) sweeps away.

The columnar form keeps a commit cheap: a per-plan pickle would walk ~10⁴
python objects per commit. Packing is C-level
``np.concatenate``/``np.split``, and the checkpointer caches each
iteration's packed columns after the first commit touching it, so commit
``t`` does O(iteration t) conversion work plus one sequential ``np.savez``
write — not O(t) re-serialization.

The directory layout, manifest keys, version, column names and fingerprint
are the JAX package's (`repro.core.checkpoint`), so a checkpoint written by
either package resumes in the other.

``fingerprint`` is a sha256 over the canonical CSR arrays; resuming against
a different graph, or with decision-relevant config changed (T, seed,
max_group, top_j, height_bound), raises `CheckpointMismatch`. Backend and
partition count are recorded but NOT enforced — replay determinism makes a
checkpoint written by ``numpy/partitions=1`` resumable under
``resident/partitions=4`` with a bit-identical summary.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

from repro_torch.core.merging import MergePlan

_I64 = np.int64
_FIELDS = ("m0", "m0_len", "n_rounds", "pair_len", "a", "z")


def _cat(parts):
    return (np.concatenate(parts).astype(_I64, copy=False) if parts
            else np.zeros(0, dtype=_I64))


def _splits(flat, lens):
    if lens.size == 0:
        return []
    return np.split(flat, np.cumsum(lens)[:-1])


def pack_plans(plans: list) -> dict:
    """One iteration's `MergePlan` list → six flat int64 columns.

    ``m0``/``m0_len`` flatten the per-plan ``members0``; ``n_rounds`` is
    rounds per plan; ``a``/``z``/``pair_len`` flatten every round's pair
    arrays in (plan, round) order. Pure reshaping — `unpack_plans` is the
    exact inverse (plan/row order preserved, which replay depends on)."""
    pairs = [r for p in plans for r in p.rounds]
    return {
        "m0": _cat([p.members0 for p in plans]),
        "m0_len": np.array([p.members0.size for p in plans], dtype=_I64),
        "n_rounds": np.array([len(p.rounds) for p in plans], dtype=_I64),
        "pair_len": np.array([a.size for a, _ in pairs], dtype=_I64),
        "a": _cat([a for a, _ in pairs]),
        "z": _cat([z for _, z in pairs]),
    }


def unpack_plans(cols: dict) -> list:
    m0s = _splits(cols["m0"], cols["m0_len"])
    a_parts = _splits(cols["a"], cols["pair_len"])
    z_parts = _splits(cols["z"], cols["pair_len"])
    plans, k = [], 0
    for i, nr in enumerate(cols["n_rounds"]):
        plan = MergePlan(m0s[i])
        for _ in range(int(nr)):
            plan.rounds.append((a_parts[k], z_parts[k]))
            k += 1
        plans.append(plan)
    return plans

CKPT_VERSION = 1
# config keys that change merge decisions; a mismatch makes the logged
# plans meaningless for the requested run, so resume refuses
DECISION_KEYS = ("T", "seed", "max_group", "top_j", "height_bound")

_PREFIX = "it_"


class CheckpointMismatch(RuntimeError):
    """The checkpoint on disk belongs to a different graph or config."""


def graph_fingerprint(g) -> str:
    """sha256 of the canonical CSR arrays — the resume identity check."""
    h = hashlib.sha256()
    h.update(np.int64(g.n).tobytes())
    h.update(np.ascontiguousarray(g.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(g.indices, dtype=np.int32).tobytes())
    return h.hexdigest()


def _iter_dirs(ckpt_dir: str) -> list:
    """Committed iteration numbers, ascending; ``.tmp`` leftovers excluded."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d[len(_PREFIX):]) for d in os.listdir(ckpt_dir)
                  if d.startswith(_PREFIX) and not d.endswith(".tmp"))


def _sweep_tmp(ckpt_dir: str) -> None:
    """Remove half-written ``.tmp`` dirs left by a kill mid-save."""
    if not os.path.isdir(ckpt_dir):
        return
    for d in os.listdir(ckpt_dir):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


class PlanCheckpointer:
    """Atomic plan-log checkpoint writer/reader for one engine run."""

    def __init__(self, ckpt_dir: str, keep: int = 2):
        self.ckpt_dir = ckpt_dir
        self.keep = max(1, int(keep))
        self._packed: dict = {}  # iteration (1-based) -> packed columns
        os.makedirs(ckpt_dir, exist_ok=True)
        _sweep_tmp(ckpt_dir)

    # ------------------------------------------------------------------ save
    def save(self, t: int, plan_log: list, fingerprint: str,
             config: dict) -> str:
        """Commit the plan log for iterations ``1..t`` (``plan_log[i]`` is
        iteration ``i+1``). Atomic: the final dir appears only after
        manifest and plans are fully on disk. Iterations already packed by
        an earlier commit (or by `load_latest`) reuse their cached columns."""
        final = os.path.join(self.ckpt_dir, f"{_PREFIX}{t:06d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {}
        for i, plans in enumerate(plan_log, start=1):
            if i not in self._packed:
                self._packed[i] = pack_plans(plans)
            for field, arr in self._packed[i].items():
                arrays[f"i{i:06d}_{field}"] = arr
        with open(os.path.join(tmp, "plans.npz"), "wb") as f:
            np.savez(f, **arrays)
        manifest = {
            "version": CKPT_VERSION,
            "t": int(t),
            "fingerprint": fingerprint,
            "config": config,
            "plan_counts": [len(plans) for plans in plan_log],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        for t in _iter_dirs(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"{_PREFIX}{t:06d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------ load
    def load_latest(self, fingerprint: str, config: dict):
        """Newest committed checkpoint as ``(t, plan_log)``, or ``None``.

        Verifies the graph fingerprint and the decision-relevant config
        keys; raises `CheckpointMismatch` on any disagreement rather than
        silently producing a summary the logged plans don't describe.
        """
        its = _iter_dirs(self.ckpt_dir)
        if not its:
            return None
        d = os.path.join(self.ckpt_dir, f"{_PREFIX}{its[-1]:06d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("version") != CKPT_VERSION:
            raise CheckpointMismatch(
                f"checkpoint version {manifest.get('version')} != "
                f"{CKPT_VERSION}")
        if manifest.get("fingerprint") != fingerprint:
            raise CheckpointMismatch(
                "graph fingerprint mismatch: checkpoint "
                f"{manifest.get('fingerprint')!r} vs run {fingerprint!r}")
        saved_cfg = manifest.get("config", {})
        for key in DECISION_KEYS:
            if saved_cfg.get(key) != config.get(key):
                raise CheckpointMismatch(
                    f"config mismatch on {key!r}: checkpoint "
                    f"{saved_cfg.get(key)!r} vs run {config.get(key)!r}")
        t_done = int(manifest["t"])
        plan_log = []
        with np.load(os.path.join(d, "plans.npz")) as npz:
            for i in range(1, t_done + 1):
                cols = {field: npz[f"i{i:06d}_{field}"]
                        for field in _FIELDS}
                self._packed[i] = cols
                plan_log.append(unpack_plans(cols))
        return t_done, plan_log
