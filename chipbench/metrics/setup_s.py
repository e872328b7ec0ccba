"""Set-up seconds: process start to the first timed batch (imports, the
kernels' build or load, weights, server, one untimed batch a length)."""


def read(ctx):
    return ctx.setup_s
