"""Architecture registry: the 10 architectures of the JAX package, copied.

Every entry is the published configuration; ``get_config(name,
smoke=True)`` returns the reduced same-family variant used by CPU smoke
tests. The port runs every family among them: dense, MoE, SSM, hybrid,
encoder-decoder and VLM.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_NAMES = [
    "internvl2-26b",
    "whisper-small",
    "zamba2-7b",
    "qwen2.5-3b",
    "h2o-danube-1.8b",
    "deepseek-7b",
    "minitron-4b",
    "mamba2-130m",
    "qwen3-moe-235b-a22b",
    "deepseek-v2-lite-16b",
]

_MODULES = {n: "repro_torch.configs." + n.replace("-", "_").replace(".", "_") for n in ARCH_NAMES}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_MODULES[name])
    cfg = mod.CONFIG
    return cfg.smoke() if smoke else cfg


def all_configs(smoke: bool = False):
    return {n: get_config(n, smoke) for n in ARCH_NAMES}
