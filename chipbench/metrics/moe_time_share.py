"""The MoE FFN's device span (CUDA events around every
`repro_torch.models.moe.moe_ffn` call) as a share of the prefills' device
span (around every `api.prefill`), in the traced window."""

SPANS = {"moe_ffn": "repro_torch.models.moe:moe_ffn"}


def read(ctx):
    moe, prefill = ctx.spans.get("moe_ffn"), ctx.spans.get("prefill")
    if not moe or not prefill:
        return None
    return 100.0 * moe / prefill
