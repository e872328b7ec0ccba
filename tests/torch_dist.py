"""Multi-rank runs of the port on the CPU for the tests: `spawn` starts
``world`` processes (``torch.multiprocessing``'s spawn context), each
joins one gloo process group through a `FileStore` in a temp directory
(no fixed port: the test workers run files side by side) and calls a
case function of `tests/torch_dist_cases.py` as ``fn(rank, world, *args)``.
Each rank's result (plain Python or numpy, picklable) comes back in rank
order. A rank that raises fails the spawn with its traceback.

Imports only torch and the port: the ranks never load jax.
"""
from __future__ import annotations

import os
import queue as queue_mod
import time
import traceback

import torch.multiprocessing as mp

TIMEOUT_S = 300


def _child(rank, world, store_path, fn_name, args, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        import torch_dist_cases as cases

        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        try:
            res = getattr(cases, fn_name)(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn(world: int, fn_name: str, tmp_dir, *args, timeout=TIMEOUT_S):
    """``[fn(0, world, *args), …, fn(world − 1, world, *args)]``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_dir), f"store-{fn_name}-{world}")
    procs = [ctx.Process(target=_child,
                         args=(r, world, store, fn_name, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world and not errors:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                if dead:
                    errors.append(f"a rank died with exit code {dead[0]}")
                elif time.monotonic() > deadline:
                    errors.append(f"no result within {timeout} s")
                continue
            if ok:
                results[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else timeout)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]
