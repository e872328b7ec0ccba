"""Config system: model and shape configs (a copy of the JAX package's
`configs/base.py`, so one config means the same model to both packages).

One deliberate difference: here ``attn_impl`` defaults to
``"pallas_flash"``. The name is kept so that a config object means the
same thing to both packages; in this package it selects the hand-written
CUDA flash-attention kernel (`csrc/flash_attention.cu`), and on the CPU
that kernel's plain PyTorch version. ``"xla_chunked"`` still selects the
plain PyTorch `chunked_sdpa` twin. The default differs because the card's
serving path must run the kernel unless the caller asks otherwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int           # per-expert FFN width
    n_shared: int = 0       # shared (always-on) experts
    d_shared: int = 0       # width of the shared expert block
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0    # 0 = plain q projection (DeepSeek-V2-Lite)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads
    qkv_bias: bool = False
    sliding_window: int = 0      # 0 = full attention
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: one attention block (shared params) applied every `attn_every`
    # ssm layers (Zamba2-style); 0 disables
    attn_every: int = 0
    # encoder-decoder (whisper): number of encoder layers (0 = decoder-only)
    encoder_layers: int = 0
    # vlm: number of prepended patch-embedding positions in input_specs
    n_patches: int = 0
    # parallelism / memory
    fsdp: bool = False           # additionally shard big weights on the data axis
    remat: str = "full"          # full | none
    dtype: str = "bfloat16"
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False
    # attention implementation: "pallas_flash" (the CUDA flash kernel on a
    # card, its plain version on the CPU) | "xla_chunked" (the plain
    # PyTorch chunked twin)
    attn_impl: str = "pallas_flash"
    # embedding-table padding so the vocab dim shards evenly over any mesh
    # axis combination (16 model × 32 dp); logits at padded columns are
    # masked in the loss. 1 = no padding (smoke configs).
    vocab_pad: int = 512
    # default gradient-accumulation microbatch (global sequences per micro
    # step) for the train_4k shape; 0 = no accumulation. Sized so the
    # remat-saved layer-boundary stack fits a 16 GiB v5e chip.
    train_microbatch: int = 0

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab + self.vocab_pad - 1) // self.vocab_pad) * self.vocab_pad

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.attn_every else 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab=257,
            vocab_pad=1,
            head_dim=16,
            sliding_window=8 if self.sliding_window else 0,
            n_patches=4 if self.n_patches else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            attn_every=2 if self.attn_every else 0,
            fsdp=False,
            train_microbatch=0,
        )
        if self.moe:
            kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_expert=32,
                                  n_shared=self.moe.n_shared and 1,
                                  d_shared=32 if self.moe.d_shared else 0)
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                  qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm:
            kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2, chunk=8)
        return replace(self, **kw)

    # ---- parameter count (for MODEL_FLOPS = 6·N·D) -------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        n = 0
        # embeddings
        n += self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        per_layer = 0
        if self.family == "ssm" or self.attn_every:
            s = self.ssm
            d_inner = s.expand * d
            nh = d_inner // s.head_dim
            conv_dim = d_inner + 2 * s.n_groups * s.d_state
            zxbcdt = 2 * d_inner + 2 * s.n_groups * s.d_state + nh
            per_layer += d * zxbcdt + conv_dim * s.conv_kernel + d_inner * d + 3 * nh + d_inner
        attn_params = 0
        if self.mla:
            m = self.mla
            qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn_params += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            attn_params += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            attn_params += d * self.n_heads * qk_dim
            attn_params += self.n_heads * m.v_head_dim * d
        elif self.n_heads:
            attn_params += d * self.n_heads * hd      # q
            attn_params += 2 * d * self.n_kv_heads * hd  # kv
            attn_params += self.n_heads * hd * d      # o
        ffn_params = 0
        if self.moe:
            mo = self.moe
            ffn_params += d * mo.n_experts  # router
            ffn_params += mo.n_experts * 3 * d * mo.d_expert
            if mo.n_shared:
                ffn_params += 3 * d * mo.d_shared
        elif self.d_ff:
            ffn_params = 3 * d * self.d_ff
        if self.family == "ssm":
            n += L * per_layer
        elif self.attn_every:  # hybrid: L ssm layers + ONE shared attn+ffn block
            n += L * per_layer + attn_params + ffn_params
        elif self.encoder_layers:
            n += (L + self.encoder_layers) * (attn_params + ffn_params)
            n += L * attn_params  # cross attention in decoder
        else:
            n += L * (attn_params + ffn_params)
        if active_only and self.moe:
            mo = self.moe
            active_ffn = d * mo.n_experts + (mo.top_k * 3 * d * mo.d_expert) + (3 * d * mo.d_shared if mo.n_shared else 0)
            n -= L * ffn_params
            n += L * active_ffn
        return int(n)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> dict:
    """Which of the 4 assigned shapes run for this arch (skips recorded)."""
    out = {}
    for name, sh in SHAPES.items():
        if name == "long_500k" and not cfg.subquadratic:
            out[name] = "skip: full-attention arch (long_500k needs sub-quadratic attention)"
        else:
            out[name] = "run"
    return out
