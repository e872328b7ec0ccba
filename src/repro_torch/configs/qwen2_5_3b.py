"""Qwen2.5-3B [hf:Qwen/Qwen2.5]: 36L, d=2048, 16 heads (GQA kv=2),
d_ff=11008, vocab=151936, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab=151936, head_dim=128, qkv_bias=True, rope_theta=1_000_000.0,
    train_microbatch=64,
)
