"""H2O-Danube-1.8B [arXiv:2401.16818]: llama+mistral mix with sliding-window
attention. 24L, d=2560, 32 heads (GQA kv=8), d_ff=6912, vocab=32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=6912,
    vocab=32000, head_dim=80, sliding_window=4096,
    subquadratic=True,  # SWA: decode cache is window-bounded
    train_microbatch=64,
)
