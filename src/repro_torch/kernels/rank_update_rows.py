"""CUDA row-local rank-k view update ``M[rows] += block @ Vᵀ``.

Binding for ``csrc/rank_update_rows.cu``, built and loaded by
:mod:`.cuda_build` the first time the kernel is launched.  It replaces
``rank_update_rows_pallas`` (``src/repro/kernels/rank_update_rows.py:50``).

The TPU kernel swept whole row slabs named by a padded slab-id list and
read a dense ``(n, k)`` left factor.  This kernel takes the affected row
indices and the compact ``(r, k)`` block directly, so there is no slab
plan and no padding: it is the dense kernel's two tiles
(``csrc/rank_update_tiles.cuh``) with the block as the left factor and M's
rows looked up through the ids.  The rows are a :class:`RowSet`: checked
once on the host (strictly increasing, inside ``[0, n)``, so no two tiles
write one row) and uploaded once per device, however many views a firing
updates.

The entry works in place on ``m``, launches on the current CUDA stream,
allocates nothing and never falls back to a plain version; an operand that
requires grad under grad mode raises (the kernel has no backward yet).
``LAUNCHES`` counts its launches and ``COLS`` the same launches by M's
columns p (p < 4 takes the skinny tile).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import numpy as np
import torch

from . import cuda_build
from .rank_update import check_operands

LAUNCHES: Dict[str, int] = {"rank_update_rows": 0}
COLS: Dict[str, Counter] = {name: Counter() for name in LAUNCHES}

_SIGNATURES = {
    "rank_update_rows_f32": [cuda_build.PTR] * 4 + [cuda_build.I32] * 3
    + [cuda_build.PTR],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        COLS[name].clear()


class RowSet:
    """Affected row indices of an ``n``-row view, checked on the host.

    ``host`` is the int64 numpy index.  :meth:`index` and :meth:`ids`
    give it as a torch index (int64) and as the kernel's int32 ids on a
    device, each uploaded once.
    """

    def __init__(self, rows, n: int):
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu().numpy()
        host = np.asarray(rows).reshape(-1)
        if host.size and not np.issubdtype(host.dtype, np.integer):
            raise TypeError(f"rows must be integers, got {host.dtype}")
        host = host.astype(np.int64)
        if host.size and (host[0] < 0 or host[-1] >= n
                          or np.any(np.diff(host) <= 0)):
            raise ValueError(f"rows must strictly increase within [0, {n}); "
                             f"got {host[:8]}... ({host.size} rows)")
        self.host = host
        self.n = int(n)
        self._on: Dict[tuple, torch.Tensor] = {}

    @classmethod
    def of(cls, rows, n: int) -> "RowSet":
        """``rows`` as a RowSet of an ``n``-row view (itself if it is one)."""
        if isinstance(rows, RowSet):
            if rows.n != n:
                raise ValueError(f"rows index {rows.n} rows, the view {n}")
            return rows
        return cls(rows, n)

    def __len__(self) -> int:
        return int(self.host.size)

    def _get(self, device, dtype) -> torch.Tensor:
        device = torch.device(device)
        key = (str(device), dtype)
        t = self._on.get(key)
        if t is None:
            t = torch.tensor(self.host, dtype=dtype, device=device)
            self._on[key] = t
        return t

    def index(self, device) -> torch.Tensor:
        """The rows as an int64 torch index on ``device``."""
        return self._get(device, torch.int64)

    def ids(self, device) -> torch.Tensor:
        """The rows as the kernel's int32 ids on ``device``."""
        return self._get(device, torch.int32)


def rank_update_rows(m: torch.Tensor, rows: RowSet, block: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """``m[rows] += block @ v.T`` in place; m (n, p), rows a
    :class:`RowSet` of r rows of m, block (r, k), v (p, k), all float32,
    contiguous, on one CUDA device."""
    cuda_build.refuse_grad("rank_update_rows", m, block, v)
    check_operands(m, block=block, v=v)
    if not isinstance(rows, RowSet):
        raise TypeError("rows must be a RowSet (checked on the host)")
    if m.dim() != 2 or block.dim() != 2 or v.dim() != 2:
        raise ValueError(f"shapes m {tuple(m.shape)}, block "
                         f"{tuple(block.shape)}, v {tuple(v.shape)} are not "
                         "2-D")
    n, p = m.shape
    r, k = block.shape
    if rows.n != n or len(rows) != r or v.shape != (p, k):
        raise ValueError(f"shapes m {(n, p)}, {len(rows)} rows of {rows.n}, "
                         f"block {(r, k)}, v {tuple(v.shape)} are not (n,p), "
                         "r of n, (r,k), (p,k)")
    if max(n, p, k) >= 2 ** 31:
        raise ValueError(f"m {(n, p)} or k = {k} is past the kernel's int32 "
                         "sizes")
    if r == 0 or p == 0 or k == 0:
        return m
    ids = rows.ids(m.device)
    lib = cuda_build.library("rank_update_rows", _SIGNATURES)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        code = lib.rank_update_rows_f32(m.data_ptr(), ids.data_ptr(),
                                        block.data_ptr(), v.data_ptr(),
                                        r, p, k, stream)
    cuda_build.check_launch("rank_update_rows_f32", code)
    cuda_build.count_launch(LAUNCHES, "rank_update_rows", extra=[(COLS, p)])
    return m
