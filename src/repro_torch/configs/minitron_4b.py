"""Minitron-4B [arXiv:2407.14679]: pruned Nemotron. 32L, d=3072,
24 heads (GQA kv=8), d_ff=9216, vocab=256000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216,
    vocab=256000, head_dim=128,
    train_microbatch=64,
)
