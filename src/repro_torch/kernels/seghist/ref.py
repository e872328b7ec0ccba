"""Plain PyTorch version of the segment-histogram kernel (exact on any
device)."""
from __future__ import annotations

import torch


def segment_histogram(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """ids ``(E,)`` int32 → ``(num_segments,)`` int32 counts of each id in
    ``[0, num_segments)``; -1 padding (and any id outside) counts nowhere."""
    S = int(num_segments)
    ids = ids.to(torch.int64)
    keep = ids[(ids >= 0) & (ids < S)]
    return torch.bincount(keep, minlength=S).to(torch.int32)
