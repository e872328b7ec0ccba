"""Prompt tokens of every request answered in the window, over the time
from the window's start to the last answer (the batch in flight at the
nominal end runs out and counts)."""


def read(ctx):
    return sum(b.length * b.served for b in ctx.batches) / ctx.window_s
