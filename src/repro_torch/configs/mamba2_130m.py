"""Mamba2-130M [arXiv:2405.21060]: attention-free SSD. 24L, d=768,
vocab=50280, ssm_state=128."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, head_dim=64, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4, n_groups=1, chunk=256),
    subquadratic=True,
)
