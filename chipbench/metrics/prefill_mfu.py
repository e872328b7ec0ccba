"""The window's model FLOPs (the configuration's reference counts them:
`prefill_flops`) over its host-clock seconds, as a share of the H100's
bf16 peak. Read in a traced run from the untraced window before the
traced cycle, so the profiler's cost is not in it."""
from chipbench.work import BF16_FLOPS


def read(ctx):
    flops = sum(ctx.family.prefill_flops(ctx.config, b.served, b.length)
                for b in ctx.batches)
    return 100.0 * flops / ctx.window_s / BF16_FLOPS
