"""K1's bf16 gradients and the plain ones against a float64 witness, on
the H100, at phase 3's ``command_r_prefill_bf16`` case (B=2, S=2048,
H=96, KV=8, hd 128: a group of 12).

    python3 tools/k1_bound_witness.py

Phase 3 of ``chip_smoke.py`` holds K1's bf16 (dq, dk, dv) against the
plain gradient through autograd (``ref.flash_attention`` in f32 on the
same bf16 tensors) within the bound of ``tests/flash_bounds.py``.  With
phase 3's generator (seed 3) drawing the cases in another order, the
two shard cases of ``K1_CASES`` before ``danube_f32_s4128``, that case's
dv exceeded the bound (ROADMAP.md Queue 3, F2).  This script draws the
inputs in both orders ("f2": that one; "phase3": the order the script
has now) and, for that case, prints a JSON line an order:

- ``bound_ratio``: the largest |K1 - plain| / bound of each gradient,
  the check phase 3 makes;
- against the exact gradient of the same bf16 inputs (float64 through
  ``ref.flash_attention_lse`` and ``ref.flash_attention_bwd``), for K1
  and for the plain side: the largest error, the share of elements not
  the correctly rounded bf16 value, and the largest *excess*, the error
  beyond half a bf16 ulp of the exact value (what the f32 arithmetic
  before the last rounding must have been off by at least);
- for dv, the condition ``Σ_group Pᵀ |dout|`` of each element: an f32
  sum of those terms is off by up to a few 2^-24 of it, and K1's split P
  (bf16 hi + lo) by about 2^-16 of it, while the bound allows 2e-4 +
  2e-4 |dv|; the excess over the condition says which of the two sides
  strays and how far;
- the worst element of K1 against the plain side: both values, the
  exact one and its condition.

Prints the card's name and power limit first; exits non-zero when no
card is there, or when a gradient of either order passes its bound
(``bound_ratio`` of 1 or more).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))   # tests/flash_bounds.py

import chip_smoke as cs  # noqa: E402

CASE = "command_r_prefill_bf16"


def orders() -> dict:
    """Phase 3's K1 cases in the order of the F2 draw and in the order
    the script has now."""
    shard = [c for c in cs.K1_CASES if c[0].startswith("shard_")]
    rest = [c for c in cs.K1_CASES if not c[0].startswith("shard_")]
    at = [c[0] for c in rest].index("danube_f32_s4128")
    return {"f2": rest[:at] + shard + rest[at:], "phase3": cs.K1_CASES}


def draw(cases):
    """Phase 3's draws, case by case, with its generator; CASE's
    (q, k, v, dout) and its options."""
    import torch
    gen = torch.Generator(device=cs.DEVICE).manual_seed(3)
    for label, b, s, h, kvh, hd, window, dt, causal, prefix in cases:
        dtype = getattr(torch, dt)
        q, dout = (torch.randn(b, s, h, hd, device=cs.DEVICE,
                               generator=gen).to(dtype) for _ in range(2))
        k, v = (torch.randn(b, s, kvh, hd, device=cs.DEVICE,
                            generator=gen).to(dtype) for _ in range(2))
        if label == CASE:
            return (q, k, v, dout), dict(causal=causal, window=window,
                                         prefix_len=prefix)
        del q, k, v, dout
    raise KeyError(CASE)


def half_ulp(x):
    """Half a bf16 ulp at |x| (8 significant bits)."""
    import torch
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 8)


def witness(tensors, opts) -> dict:
    import torch
    from flash_bounds import flash_attention_bwd_bf16_bound
    from repro_torch.kernels import flash_attention as cuda_fa
    from repro_torch.kernels import ref
    q, k, v, dout = tensors
    out, lse = cuda_fa.flash_attention_fwd_lse(q, k, v, **opts)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    cuda_fa.flash_attention(*leaves, **opts).backward(dout)
    got = [x.grad for x in leaves]
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref.flash_attention(*plain, **opts).backward(dout)
    want = [x.grad for x in plain]
    del leaves, plain
    bounds = flash_attention_bwd_bf16_bound(q, k, v, out, dout, lse, got,
                                            want, **opts)
    q64, k64, v64, do64 = (x.double() for x in tensors)
    o64, lse64 = ref.flash_attention_lse(q64, k64, v64, **opts)
    exact = ref.flash_attention_bwd(q64, k64, v64, o64, do64, lse64, **opts)
    cond_dv = ref.flash_attention_bwd(q64, k64, v64, o64, do64.abs(), lse64,
                                      **opts)[2]
    rec = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        g, w, x, bnd = got[i].double(), want[i].double(), exact[i], bounds[i]
        diff = (g - w).abs()
        ratio = diff / bnd.double()
        hu = half_ulp(x)
        rnd = x.to(torch.bfloat16).double()
        r = {"bound_ratio": float(ratio.max()),
             "max_abs_k1_minus_plain": float(diff.max())}
        for side, y in (("k1", g), ("plain", w)):
            err = (y - x).abs()
            excess = (err - hu).clamp_min(0.0)
            r[side] = {"max_err": float(err.max()),
                       "not_correctly_rounded": float((y != rnd).double()
                                                      .mean()),
                       "max_excess": float(excess.max())}
            if name == "dv":
                r[side]["max_excess_over_cond"] = float(
                    (excess / cond_dv.clamp_min(1e-30)).max())
        at = int(torch.argmax(ratio))
        worst = {"k1": float(g.flatten()[at]), "plain": float(w.flatten()[at]),
                 "exact": float(x.flatten()[at]),
                 "bound": float(bnd.flatten()[at]),
                 "index": list(map(int, torch.unravel_index(
                     torch.tensor(at), g.shape)))}
        if name == "dv":
            worst["cond"] = float(cond_dv.flatten()[at])
            r["cond_max"] = float(cond_dv.max())
        r["worst"] = worst
        rec[name] = r
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_bound_witness: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for name, cases in orders().items():
        tensors, opts = draw(cases)
        rec = {"order": name, "case": CASE, **witness(tensors, opts)}
        print(json.dumps(rec), flush=True)
        worst = max([worst] + [rec[g]["bound_ratio"]
                               for g in ("dq", "dk", "dv")])
        del tensors
        torch.cuda.empty_cache()
    print(json.dumps({"largest_bound_ratio": worst,
                      "within_bound": worst < 1.0}), flush=True)
    return 0 if worst < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
