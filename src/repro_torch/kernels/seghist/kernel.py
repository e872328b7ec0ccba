"""Wrapper of the CUDA kernel `csrc/segment_histogram.cu`: histogram of
per-subedge state ids for the batched emission DP.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (a failed launch raises), a CPU tensor takes the plain
version in `ref.py`. ``LAUNCHES`` counts kernel launches only. The emission
DP calls it once a tree level, so the launch path is `_build.launch`
(launcher looked up once, raw stream, no device switch on the current
device, the SM count read once) and the zeroed output comes from
`new_zeros`.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.seghist import ref

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()  # wrappers also run on worker threads


def segment_histogram(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """ids ``(E,)`` int32 → ``(num_segments,)`` int32 counts of each id in
    ``[0, num_segments)``; -1 padding counts nowhere."""
    global LAUNCHES
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be an (E,) int32 tensor, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    S = int(num_segments)
    if S < 0 or S >= 2**31:
        raise ValueError(f"num_segments {S} outside the int32 id range")
    if ids.device.type == "cpu":
        return ref.segment_histogram(ids, S)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    out = ids.new_zeros(S)
    if ids.numel() == 0 or S == 0:
        return out
    index = ids.device.index
    _build.launch("segment_histogram_launch", index, ids.data_ptr(),
                  out.data_ptr(), ids.numel(), S, _build.sm_count(index))
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out
