"""Layout adaptation between the model's ``(b, s, hkv, g, hd)`` attention
convention and the kernel's ``(B, H, S, D)``.

This is the attention of the serving path's prefill when
``cfg.attn_impl == "pallas_flash"`` (the port's default): the CUDA kernel
on a card, its plain version on the CPU. Query head ``h = kv·g + gi``, so
the kernel's kv head ``h // g`` is the one ``jnp.repeat`` gives in the JAX
package. The kernel takes strides, so q, k and v go in as permuted views
(no copy when q is dense; MLA's v is a strided view of its expanded
latent, read in place), and its output, laid out as q is, comes back as
``(b, sq, hkv, g, vd)`` by a view.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.kernel import flash_attention_bhsd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """q: (b, sq, hkv, g, hd); k: (b, sk, hkv, hd); v: (b, sk, hkv, vd)
    with vd <= hd — `chunked_sdpa`'s layout (MLA's v is narrower than its
    q and k). Returns (b, sq, hkv, g, vd). ``bq``/``bk`` are the JAX
    kernel's block sizes, kept so that one call reads the same in both
    packages; this kernel tiles by its own 64 rows, and its result does
    not depend on them."""
    b, sq, hkv, g, hd = q.shape
    vd = v.shape[-1]
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, sq, hd)
    o = flash_attention_bhsd(qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                             causal=causal, window=window)
    return o.reshape(b, hkv, g, sq, vd).permute(0, 3, 1, 2, 4)
