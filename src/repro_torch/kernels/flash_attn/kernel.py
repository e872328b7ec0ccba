"""Wrapper of the CUDA kernels `csrc/flash_attention.cu`: causal,
sliding-window or full attention with GQA and an online softmax, v
narrower than q and k where MLA needs it.

Dispatch is by the tensor's device, then by its type. A CPU tensor takes
the plain version in `ref.py`; a ``meta`` tensor (the dry run,
`launch/dryrun.py`) gets its output's shape. A CUDA tensor launches a kernel (a failed
launch raises; nothing gives way to another kernel or to the plain
version): bfloat16 the tensor-core kernel (``"tc_bf16"``), float32 the
CUDA-core kernel (``"cuda_core_f32"``, whose f32 arithmetic meets the
reference's f32 tolerance, which TF32 tensor cores cannot). ``LAUNCHES``
counts kernel launches, ``LAUNCHES_BY`` the same by variant. The kernels
read q, k, v and write o through their (batch, head, row) strides, so
views of the model's ``(b, s, h, d)`` activations need no copy. Their
tiles are their own (64 query rows), so the JAX kernel's ``bq``/``bk``
have no counterpart here.

The kernels compute the forward only, as the JAX kernel does (it has no
VJP): on inputs that autograd would record, the wrapper raises, so a
training forward cannot lose the attention gradients without a word.
Training attends through the plain chunked twin
(``attn_impl="xla_chunked"``, `models/attention.chunked_sdpa`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import ref
from repro_torch.launch import step_analysis
from repro_torch.launch.roofline import flash_work

LAUNCHES = 0
LAUNCHES_BY = {"tc_bf16": 0, "cuda_core_f32": 0}
# dtype -> (the launcher's dtype code, the variant it runs)
_DTYPES = {torch.float32: (0, "cuda_core_f32"),
           torch.bfloat16: (1, "tc_bf16")}
_STRIDES = ctypes.c_int64 * 12  # (batch, head, row) of q, k, v, o


def variant(dtype: torch.dtype) -> str:
    """The kernel that a CUDA tensor of ``dtype`` launches."""
    return _DTYPES[dtype][1]


def _strides(t: torch.Tensor, name: str) -> tuple:
    """The (batch, head, row) element strides of ``t`` for the kernels, 0
    for a dim of size 1 (never stepped). The kernels read each row as
    16-byte chunks: raises unless the last dim is contiguous and every row
    (and the base) is 16-byte aligned. Runs on every launch: kept cheap."""
    s, n = t.stride(), t.shape
    st = (s[0] if n[0] > 1 else 0, s[1] if n[1] > 1 else 0,
          s[2] if n[2] > 1 else 0)
    if s[3] != 1:
        raise ValueError(f"the last dim of {name} must be contiguous, got "
                         f"strides {s}")
    if (t.data_ptr() | (st[0] | st[1] | st[2]) * t.element_size()) % 16:
        raise ValueError(f"every row of {name} must start on a 16-byte "
                         f"boundary, got strides {s} and address "
                         f"{t.data_ptr():#x}")
    return st


def _out_like(q: torch.Tensor, Dv: int) -> torch.Tensor:
    """An empty (B, H, Sq, Dv) tensor laid out as q is: its dims in the
    order of q's strides, so a q made dense in the model's (b, s, h, d)
    layout gives an output dense in that layout (no copy on the way back)."""
    order = sorted(range(3), key=lambda i: -q.stride(i))
    out = torch.empty([q.shape[i] for i in order] + [Dv], dtype=q.dtype,
                      device=q.device)
    return out.permute(*[order.index(i) for i in range(3)], 3)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv) with
    H % Hkv == 0 (kv head ``h // (H // Hkv)``), one dtype (bfloat16 or
    float32). On the card D is a multiple of 8 in [8, 256] and Dv a
    multiple of 8 in [8, D] (MLA: 192 and 128), the last dim contiguous
    and every row 16-byte aligned; other strides are free. Scores are
    scaled by ``1/sqrt(D)``. Returns (B, H, Sq, Dv) in q's dtype, laid
    out as q is when q is dense. ``window`` (> 0) limits each query to its
    last ``window`` keys when ``causal``. Raises `RuntimeError` when grad
    is enabled and q, k or v requires grad: there is no backward. On
    ``meta`` (the dry run) returns the output's shape and runs nothing.
    Under a step counter (`launch.step_analysis`) the call counts as one
    op of `roofline.flash_work`'s FLOPs and bytes."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: q, k or v requires grad. "
            "Train through the chunked path (attn_impl='xla_chunked', "
            "models.attention.chunked_sdpa), or call it under "
            "torch.no_grad()")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"need q (B, H, Sq, D) and k, v (B, Hkv, Sk, ·) of "
                         f"one shape but the last dim, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k batch and head dim {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} kv "
                         f"heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of bfloat16 or "
                         f"float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type != "cpu":
        if D % 8 or not 8 <= D <= 256:
            raise ValueError(f"head dim {D} is not a multiple of 8 in "
                             f"[8, 256]")
        if Dv % 8 or not 8 <= Dv <= D:
            raise ValueError(f"v head dim {Dv} is not a multiple of 8 in "
                             f"[8, {D}]")
    return step_analysis.hand_kernel(
        "flash_attention",
        lambda: flash_work(B, H, Hkv, Sq, Sk, D, Dv, q.element_size(),
                           causal, window),
        lambda: _run(q, k, v, causal, window))


def _run(q, k, v, causal, window):
    """The plain version on the CPU, the output's shape on meta (the dry
    run), the kernel on the card; the output laid out as q is on every
    device (`_out_like`), so the ops around the call are the same."""
    global LAUNCHES
    B, H, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if q.device.type == "cpu":
        return _out_like(q, Dv).copy_(ref.attention_ref(
            q, k, v, causal=causal, window=window))
    if q.device.type == "meta":
        return _out_like(q, Dv)
    strides = (*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"))
    out = _out_like(q, Dv)
    if out.numel() == 0:
        return out
    code, name = _DTYPES[q.dtype]
    strides = _STRIDES(*strides, *out.stride()[:3])
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Hkv, Sq, Sk, D, Dv, int(bool(causal)), int(window),
            1.0 / D ** 0.5, code, ctypes.addressof(strides), stream)
    _build.check_status("flash_attention", status)
    LAUNCHES += 1
    LAUNCHES_BY[name] += 1
    return out
