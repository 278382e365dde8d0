"""CUDA flash attention: the forward (the prefill and full-sequence hot
path) and its backward (the training path).

Bindings for ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``,
built and loaded by :mod:`.cuda_build` the first time a kernel is
launched.  The forward replaces
``flash_attention_pallas`` (``src/repro/kernels/flash_attention.py:77``)
and computes the reference model's ``blockwise_attention``: causal,
prefix-LM (bidirectional over the first ``prefix_len`` positions, causal
after) or full attention, an optional sliding window, grouped-query heads
read in place.
bf16 inputs run on the tensor cores, with p carried into P V as two bf16
terms, by a route that depends on the head dim (:func:`kernel_of`): 64,
80 and 128 on Hopper's ``wgmma`` fed by TMA
(``flash_attention_bf16_wgmma``), 32, 96 and 256 on ``mma.sync``
(``flash_attention_bf16_mma``); f32 inputs run on the TF32 tensor cores
with split operands (each operand as two TF32 terms, three ``mma.sync``
products for each, which keeps the f32 path's 2e-4 tolerance;
``flash_attention_3xtf32``).

Under grad mode, with an operand that requires grad, :func:`flash_attention`
runs :class:`FlashAttention`: its forward launches
:func:`flash_attention_fwd_lse` (the same kernels, also writing each row's
log-sum-exp) and its backward :func:`flash_attention_bwd` (K1: dQ, dK and
dV, the GQA sum inside the kernel; bf16 on the tensor cores with P and dS
carried as two bf16 terms, f32 on the TF32 tensor cores with split
operands, three products for each of the five; bf16 at head dims 80 and
128 on ``wgmma`` fed by TMA, ``flash_bwd_wgmma``, at 32, 64, 96 and 256 on
``mma.sync``, ``flash_bwd_mma``: :func:`bwd_kernel_of`).  Otherwise
(serving) it launches the forward alone, as before.

Where K1's dK / dV grid (KV heads x batch x key tiles, by the type's tiles
:data:`BWD_TILES`) is under :data:`BWD_BLOCKS_PER_SM` blocks an SM,
:func:`bwd_split_plan` splits each key tile's walk over (head of the
group, query tile) into shares balanced by kept pairs; the kernel writes
f32 partials to a workspace and a second launch sums them in a fixed
order.

Each entry launches on the current CUDA stream, allocates only its outputs
(and the backward its row scratch and the split's workspace) and never
falls back to the plain version: anything a kernel does not take raises.
``LAUNCHES`` counts each entry's launches by name, ``BY_KERNEL`` each
entry's launches by the kernel (K1: the kernels' route) each took.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import cuda_build
from ..roofline import kernel_work as work

LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                            "flash_attention_fwd_lse": 0,
                            "flash_attention_bwd": 0}

#: each entry's launches by the kernel each took (:func:`kernel_of`; K1's
#: by the route of its kernels, :func:`bwd_kernel_of`)
BY_KERNEL: Dict[str, Counter] = {"flash_attention": Counter(),
                                 "flash_attention_fwd_lse": Counter(),
                                 "flash_attention_bwd": Counter()}

#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 80, 96, 128, 256)
#: bf16 head dims the forward takes on wgmma (csrc's tc::dispatch)
WGMMA_HEAD_DIMS = (64, 80, 128)
#: bf16 head dims K1 takes on wgmma (csrc's dispatch_bf16; at 64 its
#: wgmma kernels ran slower than the mma.sync ones)
BWD_WGMMA_HEAD_DIMS = (80, 128)

_FWD_SIGNATURES = {
    "flash_attention_fwd": [cuda_build.PTR] * 4 + [cuda_build.I32] * 9
    + [cuda_build.F32, cuda_build.PTR],
    "flash_attention_fwd_lse": [cuda_build.PTR] * 5 + [cuda_build.I32] * 9
    + [cuda_build.F32, cuda_build.PTR]}
_BWD_SIGNATURES = {
    "flash_attention_bwd": [cuda_build.PTR] * 10 + [cuda_build.I32] * 9
    + [cuda_build.F32, cuda_build.PTR],
    "flash_attention_bwd_split": [cuda_build.PTR] * 10
    + [cuda_build.I32] * 9 + [cuda_build.F32, cuda_build.I32,
                               cuda_build.I32, cuda_build.PTR,
                               cuda_build.I32, cuda_build.PTR,
                               cuda_build.PTR]}

#: K1's dK / dV tiles by type and head dim (csrc's wg::DkvGeo for bf16 at
#: head dims 80 and 128, tc::DkvPlan for the other bf16 ones,
#: tf32x3::DkvPlan for f32): (keys a block, query rows a step of its
#: walk); the split entry refuses others
BWD_TILES = {
    torch.bfloat16: {32: (64, 64), 64: (64, 64), 80: (128, 64),
                     96: (64, 32), 128: (128, 32), 256: (64, 32)},
    torch.float32: {32: (64, 64), 64: (64, 64), 80: (64, 64), 96: (64, 64),
                    128: (64, 64), 256: (64, 16)}}
#: K1's dK / dV blocks an SM should have: a smaller grid is split
BWD_BLOCKS_PER_SM = 2


# why the forward with LSE and the backward refuse grad
_RAW = "this entry is not differentiable (flash_attention is)"


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in BY_KERNEL.values():
        counts.clear()


def kernel_of(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel the forward launches for operands of ``dtype`` at
    head dim ``hd`` (the switch of csrc's ``tc::dispatch``)."""
    if dtype == torch.float32:
        return "flash_attention_3xtf32"
    if hd in WGMMA_HEAD_DIMS:
        return "flash_attention_bf16_wgmma"
    return "flash_attention_bf16_mma"


def bwd_kernel_of(dtype: torch.dtype, hd: int) -> str:
    """The route of the kernels K1 launches for operands of ``dtype`` at
    head dim ``hd`` (csrc's ``dispatch_bf16``): its dQ and dK / dV kernels
    are ``flash_bwd_dq_<route>`` and ``flash_bwd_dkdv_<route>``."""
    if dtype == torch.float32:
        return "flash_bwd_3xtf32"
    if hd in BWD_WGMMA_HEAD_DIMS:
        return "flash_bwd_wgmma"
    return "flash_bwd_mma"


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


def _check_call(q, k, v, window, prefix_len, **more
                ) -> Tuple[torch.dtype, Tuple[int, int, int, int, int]]:
    """The checks every entry makes: operands (q, k, v and ``more``) on
    one CUDA device in one type, contiguous and aligned; the shapes q
    (B,S,H,hd), k and v (B,S,KV,hd); the heads, window, prefix and grid.
    Returns (type, (b, s, h, kvh, hd))."""
    dtype = check_attention_operands(q=q, k=k, v=v, **more)
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
    return dtype, (b, s, h, kvh, hd)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """Softmax attention of q (B, S, H, hd) over k, v (B, S, KV, hd); keep
    key kp for query qp iff ``kp <= qp`` or ``qp, kp < prefix_len``
    (causal), and ``kp > qp - window`` (when a window is given).  Returns
    (B, S, H, hd) in q's type.  Under grad mode with an operand that
    requires grad it runs :class:`FlashAttention` on the CUDA kernels (the
    forward with the row log-sum-exp, then K1); otherwise it launches the
    forward alone."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, prefix_len,
                                    flash_attention_fwd_lse,
                                    flash_attention_bwd)
    dtype, (b, s, h, kvh, hd) = _check_call(q, k, v, window, prefix_len)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = cuda_build.library("flash_attention", _FWD_SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, kvh, hd, int(causal), window or 0, prefix_len,
            int(dtype == torch.bfloat16), hd ** -0.5, _stream(q))
    cuda_build.check_launch("flash_attention_fwd", code)
    cuda_build.count_launch(LAUNCHES, "flash_attention",
                            extra=((BY_KERNEL, kernel_of(dtype, hd)),))
    return out


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            prefix_len: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention`'s forward that also returns each row's
    log-sum-exp of the kept scaled scores, lse (B, H, S) f32 (the
    backward's input); ``out`` is bit for bit the forward's.  Not
    differentiable itself: under grad mode an operand that requires grad
    raises (:func:`flash_attention` differentiates)."""
    cuda_build.refuse_grad("flash_attention_fwd_lse", q, k, v,
                           reason=_RAW)
    dtype, (b, s, h, kvh, hd) = _check_call(q, k, v, window, prefix_len)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = cuda_build.library("flash_attention", _FWD_SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.flash_attention_fwd_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, h, kvh, hd, int(causal), window or 0,
            prefix_len, int(dtype == torch.bfloat16), hd ** -0.5,
            _stream(q))
    cuda_build.check_launch("flash_attention_fwd_lse", code)
    cuda_build.count_launch(LAUNCHES, "flash_attention_fwd_lse",
                            extra=((BY_KERNEL, kernel_of(dtype, hd)),))
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, prefix_len: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: (dq, dk, dv) of :func:`flash_attention` given the upstream
    gradient ``dout`` and the forward's ``out`` and ``lse``
    (:func:`flash_attention_fwd_lse`), in the operands' type; dk and dv
    summed over each KV head's query group.  Not differentiable itself
    (no second derivative): under grad mode an operand that requires grad
    raises."""
    cuda_build.refuse_grad("flash_attention_bwd", q, k, v, out, dout, lse,
                           reason=_RAW)
    dtype, (b, s, h, kvh, hd) = _check_call(q, k, v, window, prefix_len,
                                            out=out, dout=dout)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (b, h, s) \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 (B, H, S) = "
                         f"{(b, h, s)} on {q.device}, not {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty_like(lse)
    lib = cuda_build.library("flash_attention_bwd", _BWD_SIGNATURES)
    split = _bwd_split(q.device, dtype, b * kvh, s, h // kvh, hd, causal,
                       window, prefix_len)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, kvh, hd,
            int(causal), window or 0, prefix_len,
            int(dtype == torch.bfloat16), hd ** -0.5)
    with torch.cuda.device(q.device):
        if split is None:
            code = lib.flash_attention_bwd(*args, _stream(q))
        else:
            plan, entries, slots = split
            bk, bq = BWD_TILES[dtype][hd]
            ws = torch.empty(slots * b * kvh * 2 * bk * hd,
                             dtype=torch.float32, device=q.device)
            code = lib.flash_attention_bwd_split(
                *args, bk, bq, plan.data_ptr(), entries, ws.data_ptr(),
                _stream(q))
    cuda_build.check_launch("flash_attention_bwd", code)
    cuda_build.count_launch(LAUNCHES, "flash_attention_bwd",
                            extra=((BY_KERNEL, bwd_kernel_of(dtype, hd)),))
    return dq, dk, dv


def bwd_walk_pairs(kt: int, s: int, bk: int, bq: int, causal: bool,
                   window: Optional[int], prefix_len: int
                   ) -> Tuple[int, np.ndarray]:
    """Key tile ``kt``'s walk in K1's dK / dV kernel: (its first query
    tile, the kept pairs of each query tile it visits with the tile's
    keys).  The tiles run from the one holding its first query (the
    tile's first key under the causal mask, or 0 inside the prefix or
    without the mask) to the one holding its last key + window - 1."""
    k0, k1 = kt * bk, min(s, kt * bk + bk)
    q_begin = k0 if causal and k0 >= prefix_len else 0
    q_end = min(s, k1 - 1 + window) if window else s
    qt0, qt1 = q_begin // bq, -(-q_end // bq)
    qp = np.arange(qt0 * bq, qt1 * bq, dtype=np.int64)
    if causal:
        hi = np.where(qp < prefix_len, prefix_len - 1, qp)
    else:
        hi = np.full_like(qp, s - 1)
    hi = np.minimum(hi, k1 - 1)
    lo = np.maximum(k0, qp - window + 1) if window else np.full_like(qp, k0)
    kept = np.where(qp < s, np.maximum(0, hi - lo + 1), 0)
    return qt0, kept.reshape(-1, bq).sum(1)


def bwd_split_plan(bkv: int, s: int, group: int, bk: int, bq: int,
                   causal: bool, window: Optional[int], prefix_len: int,
                   sms: int) -> Optional[Tuple[np.ndarray, int, int]]:
    """The split of K1's dK / dV walks for ``bkv`` = B x KV blocks a
    key tile, or None where the unsplit grid (``bkv`` x key tiles blocks)
    has :data:`BWD_BLOCKS_PER_SM` blocks an SM of ``sms``.  Key tile kt's
    walk has items i = head i // nq of the group, query tile i % nq
    (:func:`bwd_walk_pairs`); its kept pairs decide how many of about
    ``BWD_BLOCKS_PER_SM * sms`` blocks it takes, and each of its splits is a
    contiguous run of items holding an equal share of them (item i goes to
    split ``pairs before i * n // pairs of the tile``).  Returns (plan,
    entries, slots): plan (int32) holds ``entries`` rows {key tile, first
    item, end item, workspace slot}, heaviest first, then for each key
    tile {first slot, slots}; a tile's slots are consecutive, in walk
    order."""
    tiles = -(-s // bk)
    blocks = BWD_BLOCKS_PER_SM * sms
    if bkv * tiles >= blocks:
        return None
    walks = [bwd_walk_pairs(kt, s, bk, bq, causal, window, prefix_len)[1]
             for kt in range(tiles)]
    totals = [group * int(w.sum()) for w in walks]
    quota = max(1, sum(totals)) / max(tiles, blocks // bkv)
    entries, firsts, slot = [], [], 0
    for kt, w in enumerate(walks):
        items = np.tile(w, group)
        n = int(min(len(items), max(1, -(-totals[kt] // quota))))
        before = np.concatenate(([0], np.cumsum(items)[:-1]))
        split = before * n // max(1, totals[kt])
        starts = np.concatenate(([0], np.flatnonzero(np.diff(split)) + 1))
        ends = np.concatenate((starts[1:], [len(items)]))
        firsts.append((slot, len(starts)))
        for a, e in zip(starts, ends):
            entries.append((int(items[a:e].sum()), kt, int(a), int(e), slot))
            slot += 1
    entries.sort(key=lambda x: (-x[0], x[1], x[2]))
    plan = np.array([v for x in entries for v in x[1:]]
                    + [v for x in firsts for v in x], dtype=np.int32)
    return plan, len(entries), slot


@functools.lru_cache(maxsize=64)
def _bwd_split(device: torch.device, dtype: torch.dtype, bkv: int, s: int,
               group: int, hd: int, causal: bool, window: Optional[int],
               prefix_len: int) -> Optional[Tuple[torch.Tensor, int, int]]:
    """:func:`bwd_split_plan` for a call on ``device`` with operands of
    ``dtype`` (its tiles), its plan as an int32 tensor there (made once a
    shape)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    made = bwd_split_plan(bkv, s, group, *BWD_TILES[dtype][hd], causal,
                          window, prefix_len, sms)
    if made is None:
        return None
    plan, entries, slots = made
    return torch.from_numpy(plan).to(device), entries, slots


def bwd_splits(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
               window: Optional[int] = None, prefix_len: int = 0) -> int:
    """The entries of K1's split plan on these card operands (its dK /
    dV blocks for each KV head and batch element), 0 where the grid is
    not split."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    made = _bwd_split(q.device, q.dtype, b * kvh, s, h // kvh, hd, causal,
                      window, prefix_len)
    return 0 if made is None else made[1]


def meta_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: Optional[int] = None,
                 prefix_len: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd_lse` on meta tensors: (out, lse) of the
    right shapes and types, nothing computed."""
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


def meta_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
             causal: bool = True, window: Optional[int] = None,
             prefix_len: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_bwd` on meta tensors: (dq, dk, dv)."""
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class FlashAttention(torch.autograd.Function):
    """Attention with a backward: ``forward`` computes (out, lse) with
    ``fwd`` and saves q, k, v, out and lse; ``backward`` makes the upstream
    gradient contiguous and hands it with them to ``bwd``.  The pair is
    :func:`flash_attention_fwd_lse` and :func:`flash_attention_bwd` on the
    card, :func:`meta_fwd_lse` and :func:`meta_bwd` on meta, or the plain
    versions (``ref.flash_attention_lse``, ``ref.flash_attention_bwd``),
    which the CPU tests run through this very Function.  Each call of the
    pair runs as a kernel entry (``flash_attention_fwd_lse``,
    ``flash_attention_bwd``: :func:`~repro_torch.roofline.kernel_work.
    entry`).  Differentiable once: a second derivative
    (``create_graph=True``) raises instead of cutting the graph."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                prefix_len: int, fwd: Callable, bwd: Callable):
        opts = dict(causal=causal, window=window, prefix_len=prefix_len)
        with work.entry("flash_attention_fwd_lse", work.flash_attention,
                        q, k, v, lse=True, **opts):
            out, lse = fwd(q, k, v, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts, ctx.bwd = opts, bwd
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        with work.entry("flash_attention_bwd", work.flash_attention_bwd,
                        q, k, v, **ctx.opts):
            dq, dk, dv = ctx.bwd(q, k, v, out, dout, lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None
