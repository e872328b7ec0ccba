"""InternVL2-26B [arXiv:2404.16821]: InternViT frontend (stub) + InternLM2
backbone. 48L, d=6144, 48 heads (GQA kv=8), d_ff=16384, vocab=92553.
The ViT is a modality stub per the assignment: input_specs() provides
precomputed patch embeddings prepended to the token sequence."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92553, head_dim=128, n_patches=1024, rope_theta=1_000_000.0,
    fsdp=True,
    train_microbatch=16,
)
