"""The roofline of one step on NVIDIA H100 SXM cards (the JAX package's
`launch/roofline.py`, on the H100's data-sheet figures in place of a
TPU's).

Terms per (arch × shape × mesh), from one rank's counts of the step
(`launch/step_analysis.py`) times the number of cards:

    compute    = FLOPs      / (chips × 989e12 FLOP/s)   [bf16 dense]
    memory     = bytes      / (chips × 3.35e12 B/s)     [HBM3]
    collective = Σ collective bytes / (chips × link B/s)

A card's link is NVLink 4 (450e9 B/s a direction) while the mesh fits one
node of 8 cards, and its network port (400 Gb/s, 50e9 B/s) past that: a
mesh of 16 or more spans nodes, and its collectives are bound by the
slowest hop. MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) exposes
recompute and dispatch overhead as MODEL_FLOPS / FLOPs. Every term is a
bound from the data sheet, not a measurement.

The flash kernel's work (`flash_pairs`, `flash_work`) is defined here once:
`kernels/flash_attn/kernel.py` reports it to the step counter, and
``chip_smoke.py`` computes the kernel's bound from it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from torch.utils._pytree import tree_flatten

# Dense peaks of the H100 SXM (NVIDIA H100 Tensor Core GPU data sheet):
# bf16 on the tensor cores, f32 on the CUDA cores.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12   # HBM3, the same data sheet
# NVLink 4: 900 GB/s a card both ways (the same data sheet), 450e9 a
# direction, between the 8 cards of one node (NVIDIA DGX H100 data sheet)
NVLINK_BYTES_PER_S = 450e9
GPUS_PER_NODE = 8
# past one node: one ConnectX-7 port of 400 Gb/s a card (NVIDIA DGX H100
# data sheet), 50e9 B/s a direction
NETWORK_BYTES_PER_S = 50e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def link_bytes_per_s(chips: int) -> float:
    """A card's collective bandwidth on a mesh of ``chips`` cards: NVLink
    within one node, the network port past it."""
    return NVLINK_BYTES_PER_S if chips <= GPUS_PER_NODE \
        else NETWORK_BYTES_PER_S


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: dict
    model_flops: float
    per_device_hbm: float
    compile_s: float = 0.0
    model_bytes: float = 0.0   # decode ideal: params + cache read once

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS["bfloat16"])

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BYTES_PER_S)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * link_bytes_per_s(self.chips))

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """How close the step is to its roofline: ideal step time over the
        achievable step time (max of terms). Ideal = MODEL_FLOPS at peak
        compute, or for decode shapes the params+cache-once memory floor —
        whichever bound is higher (the binding one)."""
        ideal = max(self.model_flops / (self.chips * PEAK_FLOPS["bfloat16"]),
                    self.model_bytes / (self.chips * HBM_BYTES_PER_S))
        ach = max(self.t_compute, self.t_memory, self.t_collective)
        return ideal / max(ach, 1e-12)

    def to_json(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes, "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "per_device_hbm": self.per_device_hbm,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "compile_s": self.compile_s, "model_bytes": self.model_bytes,
        }


def model_flops_for(cfg, shape) -> float:
    """6·N·D for training; 2·N·D per generated/processed token for serving."""
    n = cfg.param_count(active_only=cfg.moe is not None)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def ideal_decode_bytes(cfg, shape) -> float:
    """Decode is memory-bound by construction: the floor for one step is
    reading every (bf16) weight once plus the whole KV/state cache once
    (built on ``meta`` by `api.init_cache`: shapes, no data). The
    decode-shape roofline ideal (the 2·N·B FLOPs ideal is ~0)."""
    from repro_torch.models.api import get_api

    n = cfg.param_count(active_only=False)  # all experts resident
    cache = get_api(cfg).init_cache(cfg, shape.global_batch, shape.seq_len,
                                    device="meta")
    return 2.0 * n + float(sum(t.numel() * t.element_size()
                               for t in tree_flatten(cache)[0]))


def from_counts(arch, shape_name, mesh_name, chips, counts, cfg, shape,
                per_device_hbm, compile_s=0.0) -> Roofline:
    """A `Roofline` from one rank's counts (`step_analysis.analyze_step`):
    the step is SPMD, so the global quantities are the rank's times
    ``chips``, and the formulas divide them back."""
    coll = dict(counts["coll"])
    coll["count"] = dict(counts["coll_count"])
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=float(counts["flops"]) * chips,
        hlo_bytes=float(counts["bytes"]) * chips,
        coll_bytes=float(counts["coll_bytes"]) * chips,
        coll_breakdown=coll, model_flops=model_flops_for(cfg, shape),
        per_device_hbm=float(per_device_hbm), compile_s=compile_s,
        model_bytes=(ideal_decode_bytes(cfg, shape)
                     if shape.kind == "decode" else 0.0))


# ------------------------------------------------------------ flash attention
def flash_pairs(Sq, Sk, causal, window) -> int:
    """The (query, key) pairs the mask lets through, per (b, h): query i
    sees keys [max(0, i − window + 1), min(i, Sk − 1)] when ``causal``
    (``window`` 0: no lower limit), every key otherwise."""
    if not causal:
        return Sq * Sk
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q, Sk - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_work(B, H, Hkv, Sq, Sk, D, Dv, itemsize, causal, window) -> tuple:
    """``(operations, bytes)`` of one flash attention call. Operations:
    2·(D + Dv) per visible (query, key) pair (q·k and p·v, a multiply-add
    each). Bytes: q, k (D wide), v and o (Dv wide) read or written once,
    ``itemsize`` bytes an element."""
    flops = 2 * (D + Dv) * flash_pairs(Sq, Sk, causal, window) * B * H
    nbytes = (B * H * Sq * (D + Dv) + B * Hkv * Sk * (D + Dv)) * itemsize
    return flops, nbytes
