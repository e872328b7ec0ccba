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

Under a mesh (`train/train_step.py`) a state is this rank's part of it:
the ZeRO-1 slices of its moments, and under a model axis its blocks of
the parameters too. The caller names that layout by ``specs``
(`train_step.state_specs`): `save` gathers every leaf whole over the axes
its spec names (`sharding.gather_blocks`) and rank 0 of the mesh writes,
in the same format; ``restore(..., mesh=, specs=)`` cuts each whole leaf
to the rank's block (`sharding.local_block`). So a state saved on one
mesh restores on any other shape, or on none.
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

from repro_torch.launch.mesh import axes_group
from repro_torch.models import sharding as SH
from repro_torch.optim.adamw import tree_map


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


def _need_specs(specs):
    if specs is None:
        raise ValueError("under a mesh a state is the rank's part of it: "
                         "pass specs= (train_step.state_specs)")


def _gathered(state, mesh, specs):
    """(the whole state on the host, the group whose rank 0 writes it):
    every leaf of the rank's ``state`` gathered over ``mesh`` by its spec
    in ``specs``."""
    _need_specs(specs)
    return (SH.gather_blocks(state, specs, mesh, "cpu"),
            axes_group(mesh, mesh.mesh_dim_names))


def save(state, step: int, ckpt_dir: str, mesh=None, specs=None) -> str:
    """Write ``state`` (a nested dict of tensors or arrays) as checkpoint
    ``step`` under ``ckpt_dir``; returns its directory. Under ``mesh``
    every rank of it calls it with the state's ``specs``: the state is
    gathered whole, rank 0 of the mesh writes, and all return once it
    has."""
    if mesh is not None:
        state, group = _gathered(state, mesh, specs)
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


def restore(state_like, ckpt_dir: str, step: int = None, mesh=None,
            specs=None):
    """Checkpoint ``step`` (default: the latest) read into the tree of
    ``state_like``, each leaf on the device of ``state_like``'s. Returns
    ``(state, step)``, or ``(None, None)`` when there is none. Under
    ``mesh`` each leaf is cut to this rank's block under its spec in
    ``specs``. Raises when a leaf is missing or its shape or dtype is not
    ``state_like``'s."""
    if mesh is not None:
        _need_specs(specs)
        sizes, coords = SH.mesh_sizes(mesh), SH.mesh_coords(mesh)
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
        if mesh is not None:
            t = t[SH.local_block(tuple(t.shape), SH.at(specs, key.split(
                "/")), sizes, coords)].clone()
        if tuple(t.shape) != tuple(node.shape) or t.dtype != node.dtype:
            raise ValueError(f"{key}: checkpoint holds {t.dtype} "
                             f"{tuple(t.shape)}, the state {node.dtype} "
                             f"{tuple(node.shape)}")
        return t.to(node.device)

    return read(state_like, ""), step


class AsyncCheckpointer:
    """Background-thread saver with a queue of one: `submit` blocks while
    a save is still in flight (backpressure instead of memory growth), and
    never drops one. Under ``mesh`` (with the state's ``specs``) every
    rank of it calls `submit`, `wait` and `close` at the same points:
    `submit` gathers the state whole and only rank 0 of the mesh writes;
    `wait` and `close` return on every rank once rank 0's saves are on
    disk."""

    def __init__(self, ckpt_dir: str, keep: int = 3, mesh=None, specs=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.mesh, self.specs = mesh, specs
        self.group = None
        if mesh is not None:
            _need_specs(specs)
            self.group = axes_group(mesh, mesh.mesh_dim_names)
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

        if self.mesh is not None:
            state = _gathered(state, self.mesh, self.specs)[0]
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
