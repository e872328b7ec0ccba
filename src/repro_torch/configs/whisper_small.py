"""Whisper-small [arXiv:2212.04356]: enc-dec, 12+12L, d=768, 12 heads,
d_ff=3072, vocab=51865. Conv audio frontend is a stub (frame embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, encoder_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    train_microbatch=64,
)
