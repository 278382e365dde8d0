"""CUDA flash attention forward (the prefill and full-sequence hot path).

Binding for ``csrc/flash_attention.cu``, built and loaded by
:mod:`.cuda_build` the first time the kernel is launched.  It replaces
``flash_attention_pallas`` (``src/repro/kernels/flash_attention.py:77``)
and computes the reference model's ``blockwise_attention``: causal,
prefix-LM (bidirectional over the first ``prefix_len`` positions, causal
after) or full attention, an optional sliding window, grouped-query heads
read in place.
bf16 inputs run on the tensor cores (``mma.sync``, with p carried into
P V as two bf16 terms); f32 inputs run on the TF32 tensor cores with
split operands (each operand as two TF32 terms, three ``mma.sync``
products for each, which keeps the f32 path's 2e-4 tolerance).

The entry launches on the current CUDA stream, allocates only its output
and never falls back to the plain version: anything the kernel does not
take raises, and so does an operand that requires grad under grad mode
(no backward yet: the output would carry no ``grad_fn``).  ``LAUNCHES``
counts its launches.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import cuda_build

LAUNCHES: Dict[str, int] = {"flash_attention": 0}

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 80, 96, 128, 256)

_SIGNATURES = {"flash_attention_fwd": [cuda_build.PTR] * 4
               + [cuda_build.I32] * 9 + [cuda_build.F32, cuda_build.PTR]}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_attention_operands(**tensors: torch.Tensor) -> torch.dtype:
    """Every tensor is a contiguous, 16-byte aligned CUDA tensor, all on
    one device and of one type, float32 or bfloat16; returns that type."""
    first = next(iter(tensors.values()))
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the CUDA kernel "
                             "takes CUDA tensors only")
        if x.device != first.device:
            raise ValueError(f"{name} is on {x.device}, not {first.device}")
        if x.dtype not in (torch.float32, torch.bfloat16) \
                or x.dtype != first.dtype:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes float32 "
                            "or bfloat16, one type for all operands")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (shape "
                             f"{tuple(x.shape)}, strides {x.stride()})")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    return first.dtype


def check_heads(h: int, kvh: int, hd: int) -> None:
    if kvh < 1 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """Softmax attention of q (B, S, H, hd) over k, v (B, S, KV, hd); keep
    key kp for query qp iff ``kp <= qp`` or ``qp, kp < prefix_len``
    (causal), and ``kp > qp - window`` (when a window is given).  Returns
    (B, S, H, hd) in q's type."""
    cuda_build.refuse_grad("flash_attention", q, k, v)
    dtype = check_attention_operands(q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B,S,H,hd), (B,S,KV,hd)")
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    check_heads(h, kvh, hd)
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    if prefix_len < 0:
        raise ValueError(f"prefix_len {prefix_len} is negative")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} past the kernel's grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = cuda_build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, kvh, hd, int(causal), window or 0, prefix_len,
            int(dtype == torch.bfloat16), hd ** -0.5, stream)
    cuda_build.check_launch("flash_attention_fwd", code)
    cuda_build.count_launch(LAUNCHES, "flash_attention")
    return out
