"""Zamba2-7B [arXiv:2411.15242]: 81 Mamba2 layers + ONE shared attention
block applied every 6 layers (shared-parameter hybrid). d=3584, 32 heads,
d_ff=14336 (shared block FFN), vocab=32000, ssm_state=64."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, head_dim=112, attn_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4, n_groups=1, chunk=256),
    subquadratic=True,
    train_microbatch=16,
)
