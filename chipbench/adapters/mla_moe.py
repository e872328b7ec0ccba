"""The port's `ModelConfig` for a configuration file of the ``mla_moe``
family, and the checks that the port runs what the file states."""
from __future__ import annotations

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.models import moe as MOE

from chipbench.reference import mla_moe as R


def port_config(c: dict) -> ModelConfig:
    b = c["bench"]
    f, ns = c["moe_intermediate_size"], c["n_shared_experts"]
    return ModelConfig(
        name=b["name"], family="moe",
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=f,
        vocab=c["vocab_size"], head_dim=c["v_head_dim"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        moe=MoEConfig(n_experts=c["n_routed_experts"],
                      top_k=c["num_experts_per_tok"], d_expert=f,
                      n_shared=ns, d_shared=ns * f,
                      capacity_factor=b["capacity_factor"]),
        mla=MLAConfig(kv_lora_rank=c["kv_lora_rank"],
                      qk_nope_head_dim=c["qk_nope_head_dim"],
                      qk_rope_head_dim=c["qk_rope_head_dim"],
                      v_head_dim=c["v_head_dim"],
                      q_lora_rank=c["q_lora_rank"] or 0),
        dtype=b["dtype"], vocab_pad=b["vocab_pad"])


def check(c: dict, cfg: ModelConfig, lengths) -> None:
    """Raise where the port cannot run what the file states: every layer
    routed (no leading dense layer), renormalised top-k weights, plain
    RoPE, and the file's capacity rule at every prompt length."""
    if c["first_k_dense_replace"] != 0 or not c["norm_topk_prob"] \
            or not R.plain_rope(c) or c["attention_bias"]:
        raise ValueError("the port's MLA/MoE decoder routes every layer, "
                         "renormalises top-k, applies plain RoPE and has "
                         "no attention bias")
    for s in lengths:
        if MOE._capacity(cfg.moe, s) != R.capacity(c, s):
            raise ValueError(f"capacity at {s} tokens: the port gives "
                             f"{MOE._capacity(cfg.moe, s)}, the file "
                             f"{R.capacity(c, s)}")


def cache_views(cache: dict) -> dict:
    """The reference's cache entries in the port's cache tree: ``(L, b,
    S, ·)`` each."""
    return {"ckv": cache["attn"]["ckv"], "krope": cache["attn"]["krope"]}
