"""Request-slot helpers shared by the serving drivers.

Only the pieces the summary-query server (`launch/summary_serve.py`) needs
are here so far: fixed-slot padding and the per-request error record.
"""
from __future__ import annotations


def pad_to_slots(chunk: list, slots: int) -> list:
    """Pad a request chunk to exactly ``slots`` entries by repeating the last
    one (fixed-slot batching needs a full batch; duplicates are discarded by
    the caller). Raises on an empty chunk — there is nothing to repeat."""
    if not chunk:
        raise ValueError("cannot pad an empty chunk")
    return list(chunk) + [chunk[-1]] * (slots - len(chunk))


class RequestError:
    """Per-request failure record returned IN PLACE of an answer.

    A malformed request (or one cut off by a batch timeout) must not kill
    the whole drain loop — the server answers everything else and marks the
    failed slot with one of these, keeping submission-order alignment."""

    __slots__ = ("request", "reason")

    def __init__(self, request, reason: str):
        self.request = request
        self.reason = str(reason)

    def __repr__(self):
        return f"RequestError({self.request!r}, {self.reason!r})"
