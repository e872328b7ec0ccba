"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3]: 94L, d=4096, 64 heads (GQA kv=4),
128 experts top-8 with d_expert=1536, vocab=151936. FSDP sharding on top of
EP/TP (235B params don't fit TP-16 alone on v5e)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151936, head_dim=128, rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
    fsdp=True,
    train_microbatch=16,
)
