"""Roofline terms of one step from its walk (:mod:`.op_walk`):

  compute    = FLOPs_per_chip / peak_FLOPs
  memory     = bytes_per_chip / HBM_bw
  collective = Σ wire_bytes_per_chip(op) / link_bw

The port's counterpart of the JAX package's ``roofline/analysis.py``.
The reference reads FLOPs and bytes from compiled HLO
(``analyze_compiled``) and its collectives by parsing the HLO text
(``parse_collectives``); the port has no compiled module: the walk of
one eager step on the rank's local blocks counts them
(:func:`analyze_step`), its collectives reported by ``dist/`` in the
type that goes on the wire, so ``parse_collectives`` has no counterpart.
The report keeps the reference's field and key names
(``hlo_flops_per_chip``...), now the walk's counts.  The ring formulas,
the report's math and the analytic model estimates are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .hw import H100_SXM, HardwareSpec


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    operand_bytes: int
    group_size: int
    wire_bytes: float
    line: str = ""


@dataclass
class CollectiveSummary:
    ops: List[CollectiveOp] = field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.ops)

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self.ops:
            out[o.kind] = out.get(o.kind, 0.0) + o.wire_bytes
        return out

    def top(self, n: int = 5) -> List[CollectiveOp]:
        return sorted(self.ops, key=lambda o: -o.wire_bytes)[:n]


def _wire_bytes(kind: str, result: int, operand: int, g: int) -> float:
    """Ring-algorithm wire bytes per chip."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return (g - 1) * operand            # operand = per-chip shard
    if kind == "reduce-scatter":
        return (g - 1) * result             # result = per-chip shard
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * operand
    if kind == "all-to-all":
        return (g - 1) / g * operand
    if kind == "collective-permute":
        return float(operand)
    return float(operand)


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float                 # analytic useful FLOPs (global)
    model_bytes: float = 0.0           # analytic minimal HBM traffic (global)
    peak_flops: float = H100_SXM.peak_flops_bf16
    hbm_bw: float = H100_SXM.hbm_bandwidth
    ici_bw: float = H100_SXM.ici_link_bandwidth * H100_SXM.ici_links
    memory_per_chip: Dict[str, float] = field(default_factory=dict)
    collectives_by_kind: Dict[str, float] = field(default_factory=dict)
    top_collectives: List[str] = field(default_factory=list)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops_per_chip / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes_per_chip / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / self.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs × chips): recompute/redundancy waste."""
        total_hlo = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful-compute time / step lower bound."""
        t_useful = self.model_flops / (self.chips * self.peak_flops)
        return t_useful / self.t_bound if self.t_bound else 0.0

    @property
    def bandwidth_fraction(self) -> float:
        """For memory-bound (decode) cells: useful-bytes time / bound.

        Useful bytes = the data the op *must* stream (params + caches once);
        1.0 means the step streams nothing it doesn't have to."""
        if not self.model_bytes:
            return 0.0
        t_useful = self.model_bytes / (self.chips * self.hbm_bw)
        return t_useful / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "hlo_bytes_per_chip": self.hlo_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bandwidth_fraction": self.bandwidth_fraction,
            "model_bytes": self.model_bytes,
            "memory_per_chip": self.memory_per_chip,
            "collectives_by_kind": self.collectives_by_kind,
            "top_collectives": self.top_collectives,
        }


def analyze_step(walk, *, arch: str, shape: str, mesh_name: str,
                 chips: int, model_flops: float, model_bytes: float = 0.0,
                 hw: HardwareSpec = H100_SXM) -> RooflineReport:
    """The report of one walked step (an :class:`~.op_walk.Walk` that has
    run and :meth:`~.op_walk.Walk.finish`-ed): per chip, the walk's FLOPs,
    bytes and collective wire bytes, and its memory (argument, output,
    temp, peak)."""
    mem = {"argument_bytes": float(walk.argument_bytes),
           "output_bytes": float(walk.output_bytes),
           "temp_bytes": float(walk.temp_bytes),
           "peak_bytes": float(walk.peak_bytes)}
    by_kind = walk.collectives.by_kind()
    agg: Dict[tuple, int] = {}
    for c in walk.collectives.ops:
        key = (c.kind, c.line, c.group_size, c.wire_bytes)
        agg[key] = agg.get(key, 0) + 1
    top = sorted(agg.items(), key=lambda kv: -kv[0][3] * kv[1])[:6]
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=walk.flops, hlo_bytes_per_chip=walk.bytes,
        collective_bytes_per_chip=sum(by_kind.values()),
        model_flops=model_flops, model_bytes=model_bytes,
        peak_flops=hw.peak_flops_bf16, hbm_bw=hw.hbm_bandwidth,
        ici_bw=hw.ici_link_bandwidth * hw.ici_links,
        memory_per_chip=mem, collectives_by_kind=by_kind,
        top_collectives=[f"{k[0]} {k[1]} g={k[2]} {k[3] / 1e6:.1f}MB ×{n}"
                         for k, n in top])


def model_flops_estimate(cfg, shape) -> float:
    """Analytic useful FLOPs (global, per step) — 6·N_active·D for train,
    2·N_active·tokens (+ attention/cache terms) for decode."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    hd = cfg.resolved_head_dim
    if shape.kind == "train":
        base = 6.0 * n_active * tokens
        # attention: fwd 4·S²·H·hd per layer per seq (QK^T + PV), ×3 for bwd
        if cfg.family not in ("ssm",):
            window = cfg.sliding_window or shape.seq_len
            eff = min(window, shape.seq_len)
            attn = (12.0 * cfg.n_layers * cfg.n_heads * hd *
                    shape.seq_len * eff * shape.global_batch)
            if cfg.family == "hybrid":
                attn *= (cfg.n_layers // cfg.attn_every) / cfg.n_layers
            base += attn
        return base
    if shape.kind == "prefill":
        base = 2.0 * n_active * tokens
        if cfg.family not in ("ssm",):
            window = cfg.sliding_window or shape.seq_len
            eff = min(window, shape.seq_len)
            attn = (4.0 * cfg.n_layers * cfg.n_heads * hd *
                    shape.seq_len * eff * shape.global_batch)
            if cfg.family == "hybrid":
                attn *= (cfg.n_layers // cfg.attn_every) / cfg.n_layers
            base += attn
        return base
    # decode: one token over the whole batch
    base = 2.0 * n_active * shape.global_batch
    if cfg.family not in ("ssm",):
        ctx = min(cfg.sliding_window or shape.seq_len, shape.seq_len)
        layers_with_attn = (cfg.n_layers // cfg.attn_every
                            if cfg.family == "hybrid" else cfg.n_layers)
        base += (4.0 * layers_with_attn * cfg.n_heads * hd * ctx *
                 shape.global_batch)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm:
        d_inner = cfg.ssm.expand * cfg.d_model
        base += 6.0 * cfg.n_layers * d_inner * cfg.ssm.state * \
            shape.global_batch
    return base


def model_bytes_estimate(cfg, shape) -> float:
    """Analytic minimal HBM traffic per step (global).

    Train: params read + grads written + opt state r/w (≈16 B/param) +
    activations written once forward (d_model stream per token).
    Decode: active params read once + KV/SSM cache read once.
    """
    elt = 2.0  # bf16
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    tokens = shape.global_batch * shape.seq_len
    hd = cfg.resolved_head_dim
    if shape.kind == "train":
        opt = 16.0 * n_total            # fp32 master/m/v read+write
        act = 2.0 * elt * tokens * cfg.d_model * max(cfg.n_layers, 1)
        return elt * (n_total + n_active) + opt + act
    if shape.kind == "prefill":
        act = 2.0 * elt * tokens * cfg.d_model * max(cfg.n_layers, 1)
        return elt * n_active + act
    # decode: stream params + cache once
    cache = 0.0
    if cfg.family not in ("ssm",):
        ctx = min(cfg.sliding_window or shape.seq_len, shape.seq_len)
        layers_with_attn = (cfg.n_layers // cfg.attn_every
                            if cfg.family == "hybrid" else cfg.n_layers)
        cache += (2.0 * layers_with_attn * cfg.n_kv_heads * hd * ctx *
                  shape.global_batch * elt)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm:
        d_inner = cfg.ssm.expand * cfg.d_model
        cache += (4.0 * cfg.n_layers * d_inner * cfg.ssm.state *
                  shape.global_batch)  # f32 state read+write
    return elt * n_active + cache
