"""DeepSeek-V2-Lite-16B [arXiv:2405.04434]: MLA (kv_lora=512) + MoE with
2 shared + 64 routed experts, top-6, d_expert=1408. 27L, d=2048, 16 heads."""
from repro_torch.configs.base import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2, d_shared=2816),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, q_lora_rank=0),
    train_microbatch=64,
)
