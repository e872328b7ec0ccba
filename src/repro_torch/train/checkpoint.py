"""Train-state checkpoints with atomic commit and an async saver (the JAX
package's `train/checkpoint.py`, in its on-disk format).

Layout: ``<dir>/step_<N>/{manifest.json, arr_<i>.npy ...}``, written to a
``.tmp`` directory and committed by one rename, so a killed run never
leaves half a checkpoint. The manifest names each leaf by its path of
dict keys (``params/layers/attn/wq``, ``opt/m/...``, ``opt/step``), in the
reference's flatten order (sorted keys), with its dtype name and shape. A
bfloat16 leaf, which ``.npy`` cannot hold, is stored as its raw bytes
(``"raw_bytes": true``) and read back as 16-bit patterns viewed as
bfloat16, so neither package needs the other's dtype library. A
checkpoint written by either package restores in the other.

Under a mesh (ZeRO-1, `train/train_step.py`) a state's moments are this
rank's slices: `save` all-gathers them along the dim where a moment's
shape differs from its parameter's and rank 0 of the data group writes
the whole state, in the same format; ``restore(..., mesh=)`` reads whole
leaves and gives each rank its slice of those its state holds sliced. So
a state saved under n ranks restores under any other count, or none.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import dp_group
from repro_torch.optim.adamw import leaves, tree_map, unflatten


def _paths_of(tree, prefix=""):
    """[(path, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths_of(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _to_numpy(leaf):
    """(array to write, dtype name, shape, raw bytes?) of one leaf."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype), list(arr.shape), False
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        raw = t.contiguous().view(torch.int16).numpy().view(np.uint8)
        return raw.reshape(-1), "bfloat16", list(t.shape), True
    arr = t.numpy()
    return arr, str(arr.dtype), list(arr.shape), False


def _sliced_dim(part: tuple, whole: tuple):
    """The one dim along which a slice of shape ``part`` was cut from
    ``whole``, or None when the shapes are equal."""
    dims = [i for i, (a, b) in enumerate(zip(part, whole)) if a != b]
    if len(part) != len(whole) or len(dims) > 1:
        raise ValueError(f"a slice of shape {part} cannot come from {whole}")
    return dims[0] if dims else None


def gather_zero1(state, group):
    """``state`` with every ZeRO-1 moment slice all-gathered over
    ``group`` into the whole moment (in rank order, along the dim where
    its shape differs from its parameter's); other leaves as they are.
    Every rank of ``group`` must call it."""
    if "opt" not in state or "params" not in state:
        return state
    n = dist.get_world_size(group)
    whole = [tuple(p.shape) for p in leaves(state["params"])]

    def gathered(tree):
        out = []
        for t, shape in zip(leaves(tree), whole):
            dim = _sliced_dim(tuple(t.shape), shape)
            if dim is None:
                out.append(t)
                continue
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            out.append(torch.cat(parts, dim=dim))
        return unflatten(tree, out)

    opt = dict(state["opt"])
    opt["m"], opt["v"] = gathered(opt["m"]), gathered(opt["v"])
    return {**state, "opt": opt}


def save(state, step: int, ckpt_dir: str, mesh=None) -> str:
    """Write ``state`` (a nested dict of tensors or arrays) as checkpoint
    ``step`` under ``ckpt_dir``; returns its directory. Under ``mesh``
    every rank of the data group calls it: the ZeRO-1 slices are gathered
    (`gather_zero1`), rank 0 writes, and all return once it has."""
    if mesh is not None:
        group = dp_group(mesh)
        state = gather_zero1(state, group)
        try:
            if dist.get_rank(group) == 0:
                return save(state, step, ckpt_dir)
            return os.path.join(ckpt_dir, f"step_{step:08d}")
        finally:
            dist.barrier(group=group)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "arrays": []}
    for i, (key, leaf) in enumerate(_paths_of(state)):
        arr, dtype, shape, raw = _to_numpy(leaf)
        entry = {"key": key, "file": f"arr_{i}.npy", "dtype": dtype,
                 "shape": shape}
        if raw:
            entry["raw_bytes"] = True
        np.save(os.path.join(tmp, entry["file"]), arr)
        manifest["arrays"].append(entry)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # the atomic commit
    return final


def latest_step(ckpt_dir: str):
    """The newest committed step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load(d: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(d, entry["file"]))
    if entry.get("raw_bytes"):
        if entry["dtype"] != "bfloat16":
            raise ValueError(f"{entry['key']}: raw bytes of dtype "
                             f"{entry['dtype']!r} cannot be read")
        bits = arr.view(np.uint16).view(np.int16).reshape(entry["shape"])
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(entry["dtype"])))


def restore(state_like, ckpt_dir: str, step: int = None, mesh=None):
    """Checkpoint ``step`` (default: the latest) read into the tree of
    ``state_like``, each leaf on the device of ``state_like``'s. Returns
    ``(state, step)``, or ``(None, None)`` when there is none. Under
    ``mesh`` a leaf that ``state_like`` holds as a ZeRO-1 slice (one dim
    1/n of the checkpoint's, n the data group's size) gets this rank's
    slice. Raises when a leaf is missing or its shape or dtype is not
    ``state_like``'s."""
    rank = n = None
    if mesh is not None:
        group = dp_group(mesh)
        rank, n = dist.get_rank(group), dist.get_world_size(group)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        by_key = {a["key"]: a for a in json.load(f)["arrays"]}

    def read(node, prefix):
        if isinstance(node, dict):
            return {k: read(v, f"{prefix}{k}/") for k, v in node.items()}
        key = prefix[:-1]
        if key not in by_key:
            raise KeyError(f"checkpoint {d} has no leaf {key!r}")
        t = _load(d, by_key[key])
        if n is not None and tuple(t.shape) != tuple(node.shape):
            dim = _sliced_dim(tuple(node.shape), tuple(t.shape))
            if node.shape[dim] * n == t.shape[dim]:
                t = t.narrow(dim, rank * node.shape[dim],
                             node.shape[dim]).clone()
        if tuple(t.shape) != tuple(node.shape) or t.dtype != node.dtype:
            raise ValueError(f"{key}: checkpoint holds {t.dtype} "
                             f"{tuple(t.shape)}, the state {node.dtype} "
                             f"{tuple(node.shape)}")
        return t.to(node.device)

    return read(state_like, ""), step


class AsyncCheckpointer:
    """Background-thread saver with a queue of one: `submit` blocks while
    a save is still in flight (backpressure instead of memory growth), and
    never drops one. Under ``mesh`` every rank of the data group calls
    `submit`, `wait` and `close` at the same points: `submit` gathers the
    ZeRO-1 slices (`gather_zero1`) and only rank 0 writes; `wait` and
    `close` return on every rank once rank 0's saves are on disk."""

    def __init__(self, ckpt_dir: str, keep: int = 3, mesh=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.group = dp_group(mesh) if mesh is not None else None
        self.writer = self.group is None or dist.get_rank(self.group) == 0
        self.q: "queue.Queue" = queue.Queue(maxsize=1)
        self.errors: list = []
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            state, step = item
            try:
                save(state, step, self.ckpt_dir)
                self._gc()
            except Exception as e:  # kept for the caller to read
                self.errors.append(e)
            finally:
                self.q.task_done()

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def submit(self, state, step: int):
        """Queue ``state`` for saving as ``step``. A complete host copy is
        taken before this returns (a blocking copy from the card, a clone
        on the host), so the caller may update the state in place at
        once."""
        def host(t):
            if isinstance(t, torch.Tensor):
                return t.detach().to("cpu", copy=True)
            return np.array(t)

        if self.group is not None:
            state = gather_zero1(state, self.group)
        if self.writer:
            self.q.put((tree_map(host, state), step))

    def _sync(self):
        if self.group is not None:
            dist.barrier(group=self.group)

    def wait(self):
        self.q.join()
        self._sync()

    def close(self):
        self.q.join()
        self.q.put(None)
        self._t.join()
        self._sync()
