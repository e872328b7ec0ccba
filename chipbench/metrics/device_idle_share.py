"""The share of the traced cycle (host clock, first hand-off to last
answer) in which no kernel, copy or set ran on the device: one minus the
union of the profiler's device intervals over the cycle. The profiler's
own cost on the host counts in it."""


def read(ctx):
    if not ctx.events:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.traced_s)
