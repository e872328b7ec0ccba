"""The flash kernel's share of its roofline in the traced cycle: the sum
over its calls of max(operations / bf16 peak, bytes / HBM peak)
(`work.flash_work`, the calls from the configuration's reference), over
the flash kernels' summed device time. Nothing where the trace holds no
flash kernel, or not one per counted call."""
from chipbench.work import flash_bound_s

KERNEL = "flash_attention"


def read(ctx):
    calls = [call for b in ctx.traced
             for call in ctx.family.flash_calls(ctx.config, b.slots, b.length)]
    ran = [(e - s) * 1e-6 for n, s, e in ctx.events if KERNEL in n]
    if not calls or len(ran) != len(calls) \
            or ctx.counters.get("flash_launches") != len(calls):
        return None
    return 100.0 * sum(flash_bound_s(c) for c in calls) / sum(ran)
