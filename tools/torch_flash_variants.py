#!/usr/bin/env python3
"""Side-by-side timing of build variants of the flash-attention kernels on
one GPU: the prefill entry's f32 kernel (split TF32) and bf16 kernels
(wgmma fed by TMA at head dims 64, 80 and 128; mma.sync at 32, 96 and
256), and the backward entry (K1: bf16 on wgmma fed by TMA at head dims
80 and 128 and on mma.sync at 32, 64, 96 and 256, f32 on the TF32 tensor
cores with split operands).

    python3 tools/torch_flash_variants.py [--parent ROOT]
        [--entries fwd,bwd] [--dtypes f32,bf16] [--rounds N] [VARIANT ...]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Each variant is ``src/repro_torch/kernels/csrc/
flash_attention.cu``, ``flash_attention_bwd.cu`` and the headers they
share, ``attention_common.cuh`` (whose split-TF32 products both f32 paths
use) and ``wgmma_common.cuh`` (the wgmma kernels' TMA, barriers and
products), with a few lines of their text replaced (``VARIANTS`` below; ``checkout``
is the files as they are), each compiled with the port's own ``nvcc``
flags into a temporary directory, all builds started together.
``--parent ROOT`` adds the variant ``parent``: the same libraries built
from the sources under ROOT (another checkout, e.g. the parent commit
unpacked with ``git archive`` into the git-ignored ``_parent/``), so old
and new kernels run in one call.  Without variant names the script runs
``checkout`` and every variant of the entries and dtypes asked for.

For each variant the script prints every kernel instance's registers and
spills (``ptxas``), then, from ``cuobjdump -sass``, each instance's
tensor-core, copy and arithmetic instructions by kind
(``HMMA.1688.F32.TF32`` is the split-TF32 product, ``HMMA.16816.F32.BF16``
the mma.sync bf16 one, ``HGMMA`` the wgmma one, ``UTMALDG`` a TMA load;
the mma.sync bf16 instances are not listed) and whether each instance's
SASS is the first variant's instruction for instruction (with
``--parent``: the parent's; instances the first variant lacks are
``new``, instances only the first variant has are ``gone``), and a
``sass_check`` line per library: the instances identical, different,
new and gone.  For the backward library a ``wgmma_check`` line counts
each wgmma instance's ``HGMMA``, ``UTMALDG`` and ``HMMA`` instructions
(it raises if one has no ``HGMMA`` or ``UTMALDG``, or any ``HMMA``).
Then it times each entry asked for
(``--entries``, ``fwd`` by default) at every shape of its dtypes in rounds
(``--rounds``, 4 by default; variants in turn, then in reverse: parent,
change, change, parent), each by CUDA events over a run of launches after
warm-ups (``ms``) and by ``torch.profiler``, the kernels alone
(``device_ms``; for the backward the sum of its launches a call, and each
kernel's share by name).

The forward (``F32_SHAPES``: every f32 shape of ``chip_smoke.py``'s
phase 3; ``bf16_shapes()``: every bf16 one, its serving cases
``FLASH_CASES`` through the entry without the row log-sum-exp and K1's
cases ``K1_CASES`` through the one with it, labelled ``_lse``): beside
the variants, once a shape, SDPA's time (its fused kernels where it
takes one: an explicit keep-mask for a window or the prefix, with the
heads expanded), the plain version's, the bound (f32: the split-TF32
rate, 495 / 3 TFLOP/s, and the FMA peak, 67; bf16: 989; 3.35 TB/s) and
each output held against the plain version at the entry's tolerance
(f32 rtol = atol = 2e-4; bf16 rtol 1e-2, atol 1e-3; the log-sum-exp
within 2e-4) and, bit for bit, against the first variant's.  Each timed
record gives TFLOP/s of the function's work and of the work the kernel
issues (bf16: 1.5 times, P V's second term) and the ratio of its device
time to SDPA's (``x_sdpa``).  A variant that must
fail the tolerance (``one_tf32``) raises if it does not, and so do
``checkout`` and ``parent`` if they fail it.

The backward (``chip_smoke.py``'s ``K1_CASES``, of the dtypes asked
for; each dtype's shapes run its own kernels' variants): each variant's
(dq, dk, dv), given the first variant's forward out and lse, against
torch.autograd through the plain attention (f32 within 2e-4; bf16 within
``tests/flash_bounds.py``'s bound; reported as the largest fraction of
it), bit for bit against a second call; beside them the plain backward's
time, SDPA's backward (as ``chip_smoke.py`` times it) and the bound (the
five products at 989 TFLOP/s for bf16, 495 / 3 for f32; 3.35 TB/s).  A
call takes the split entry where the binding would (``bwd_split_plan``
on the dtype's tiles; a parent whose split entry takes bf16 alone runs
f32 unsplit); ``unsplit`` is the checkout's kernels always launched
unsplit.  ``checkout``, ``unsplit`` and ``parent`` raise if they leave
the bound or differ from a second call; a variant that must leave it
(``bwd_one_term``, ``bwd_f32_one_tf32``) raises if it does not.

``--rounds 0`` builds, reads the SASS and checks every variant once, with
no timing.  The last lines (``summary``) give each variant's median
times over the rounds and their ratios to the first variant's.  A variant
whose text no longer matches the source raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

CSRC = Path("src/repro_torch/kernels/csrc")
SOURCE, HEADER = "flash_attention.cu", "attention_common.cuh"
WG_HEADER = "wgmma_common.cuh"
BWD_SOURCE = "flash_attention_bwd.cu"
F32_PART = "namespace tf32x3 {"   # where the f32 kernels' code begins
BWD_WG_PART = "namespace wg {"    # where K1's wgmma kernels' code begins
BWD_PART = "namespace tc {"       # where K1's mma.sync kernels' code begins
# the split entry of a K1 source that takes f32 too (an older one took
# bf16 alone)
SPLIT_TAKES_F32 = "int prefix, int is_bf16, float scale, int bk"

# -- the bf16 kernels' variants ----------------------------------------------
_SPLIT_PV = """\
        mma_bf16(o[2 * np], lo, bf[0], bf[1]);
        mma_bf16(o[2 * np], hi, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], lo, bf[2], bf[3]);
        mma_bf16(o[2 * np + 1], hi, bf[2], bf[3]);"""
# the wgmma kernel's (head dims 64, 80, 128) P V: lo, then hi
_WG_PV = """\
    mma_rs(o, lo[kk], dv);
    mma_rs(o, hi[kk], dv);"""
_WG_PV_TAIL = """\
      mma_rs(ot, lo[kk], dt);
      mma_rs(ot, hi[kk], dt);"""
_WG_STAGES = ("  static constexpr int STAGES = HD <= 80 ? 3 : 2;   "
              "// the K / V ring")
_WG_SHORT = "constexpr int SHORT_S = 256;"
_MIN_BLOCKS = "constexpr int MIN_BLOCKS = HD <= 80 ? 2 : 1;"
# Q's fragments re-read from shared memory at every k16 step of every tile
# at every head dim (the kernel does so above head dim 128 only)
_Q_SMEM = [("constexpr bool Q_IN_REGS = HD <= 128;",
            "constexpr bool Q_IN_REGS = false;")]
VARIANTS_BF16 = {
    # p as one bf16 term, as the reference rounds it, in both kernels:
    # fails the tolerance
    "single_p": [(_SPLIT_PV, """\
        mma_bf16(o[2 * np], hi, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], hi, bf[2], bf[3]);"""),
                 (_WG_PV, "    mma_rs(o, hi[kk], dv);"),
                 (_WG_PV_TAIL, "      mma_rs(ot, hi[kk], dt);")],
    "libm_exp2f": [("\n      alpha[r] = exp2_approx(",
                    "\n      alpha[r] = exp2f("),
                   ("sc[j][e] = exp2_approx(", "sc[j][e] = exp2f("),
                   ("\n    alpha[r] = exp2_approx(",
                    "\n    alpha[r] = exp2f("),
                   ("      sc[4 * j + e] =\n          exp2_approx(",
                    "      sc[4 * j + e] =\n          exp2f(")],
    # the wgmma kernel's K / V ring: 2 or 3 stages at every head dim (3
    # at 128 fills 224 KB of shared memory); head dim 64 on 64-key tiles
    # at every S, or on 128-key tiles at every S
    "wg_stages2": [(_WG_STAGES, _WG_STAGES.replace("HD <= 80 ? 3 : 2",
                                                   "2"))],
    "wg_stages3": [(_WG_STAGES, _WG_STAGES.replace("HD <= 80 ? 3 : 2",
                                                   "3"))],
    "wg_hd64_short": [(_WG_SHORT, _WG_SHORT.replace("256", "1 << 30"))],
    "wg_hd64_long": [(_WG_SHORT, _WG_SHORT.replace("256", "0"))],
    # the consumers issue without taking turns (no ping-pong) at any
    # length, or take them in every block
    "wg_no_turns": [(f'  asm volatile("bar.{op} %0, 256;\\n" :: "r"({arg}) '
                     ': "memory");\n', "")
                    for op, arg in (("sync", "1 + wgi"),
                                    ("arrive", "2 - wgi"))],
    "wg_turns_always": [("constexpr bool turns = BK == 128;",
                         "constexpr bool turns = true;")],
    "four_warps_bf16": [("constexpr int WARPS = 8;",
                         "constexpr int WARPS = 4;")],
    "q_smem": _Q_SMEM,
    "q_smem_two_blocks": _Q_SMEM + [(_MIN_BLOCKS,
                                     "constexpr int MIN_BLOCKS = 2;")],
}

# -- the f32 (split-TF32) kernel's variants ----------------------------------
_PRODUCTS = """\
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);"""
_QK_RUN = "  static constexpr int QK_RUN = Q_IN_REGS ? HD / 16 : 2;\n"
_PV_RUN = "  static constexpr int PV_RUN = 2;\n"
# S's and O's running sums kept in the mma's accumulator
_QK_TC = [("        float ds[4] = {0.f, 0.f, 0.f, 0.f};\n",
           "        float (&ds)[4] = sc[j];\n"),
          ("        add4(sc[j], ds);\n", "")]
_PV_TC = [("        float dp[4] = {0.f, 0.f, 0.f, 0.f};\n",
           "        float (&dp)[4] = o[n];\n"),
          ("        add4(o[n], dp);\n", "")]
_WIDE = "constexpr int WIDE = 3;"
_SPLIT = """\
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));"""
_LOADER = """\
  for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
    const int row = e / CPR;
    const int col = (e % CPR) * 4;"""
# design point 5, the other placement of the split: one pass a tile writes
# big over the ring's K and V tile in place and small into planes of its
# own, behind one more barrier; the warps read both and split nothing.
# (Head dim 256's planes do not fit beside its ring and Q tile: refused.)
_PRESPLIT = """\
// c += a b for split A (ab, as) and a B pair split already (big, small).
__device__ __forceinline__ void mma_presplit(float (&c)[4],
                                             const uint32_t (&ab)[4],
                                             const uint32_t (&as)[4],
                                             float2 big, float2 small) {
  attn::mma_tf32(c, as, __float_as_uint(big.x), __float_as_uint(big.y));
  attn::mma_tf32(c, ab, __float_as_uint(small.x), __float_as_uint(small.y));
  attn::mma_tf32(c, ab, __float_as_uint(big.x), __float_as_uint(big.y));
}

// Start copying rows pos0 .. pos0 + ROWS - 1 of a (rows x HD) f32"""
_SPLIT_PASS = """\
    cp_async_commit();
    {
      float* kt_ = ks + buf * BK * LDK;
      float* vt_ = vs + buf * BK * LDV;
      for (int e = threadIdx.x; e < BK * HD; e += THREADS) {
        const int r = e / HD, c = e % HD;
        uint32_t bg, sm;
        split_tf32(kt_[r * LDK + c], bg, sm);
        kt_[r * LDK + c] = __uint_as_float(bg);
        kss[r * LDK + c] = __uint_as_float(sm);
        split_tf32(vt_[r * LDV + c], bg, sm);
        vt_[r * LDV + c] = __uint_as_float(bg);
        vss[r * LDV + c] = __uint_as_float(sm);
      }
      __syncthreads();
    }

    const int k0 = kt * BK + half * BKW;"""
SPLIT_SMEM = [
    ("      sizeof(float) * (2 * BK * (LDK + LDV) + (Q_IN_REGS ? 0 : BQ * LDK));",
     "      sizeof(float) * (3 * BK * (LDK + LDV) + (Q_IN_REGS ? 0 : BQ * LDK));"),
    ("  float* qs = vs + 2 * BK * LDV;     // [BQ][LDK], unless Q_IN_REGS\n",
     "  float* qs = vs + 2 * BK * LDV;     // [BQ][LDK], unless Q_IN_REGS\n"
     "  float* kss = qs + (G::Q_IN_REGS ? 0 : BQ * LDK);\n"
     "  float* vss = kss + BK * LDK;\n"),
    ("// Start copying rows pos0 .. pos0 + ROWS - 1 of a (rows x HD) f32",
     _PRESPLIT),
    ("    cp_async_commit();\n\n    const int k0 = kt * BK + half * BKW;",
     _SPLIT_PASS),
    ("          mma_split(ds, qbig[r], qsmall[r], kp.x, kp.y);",
     "          const float2 kq = *reinterpret_cast<const float2*>(\n"
     "              kss + (half * BKW + g) * LDK + 2 * t + 8 * j * LDK"
     " + 8 * (kr + r));\n"
     "          mma_presplit(ds, qbig[r], qsmall[r], kp, kq);"),
    ("          mma_split(dp, pbig[r], psmall[r], vk[0], vk[LDV]);",
     "          const float* vq =\n"
     "              vss + (half * BKW + 8 * (kr + r) + 2 * t) * LDV + g"
     " + 8 * n;\n"
     "          mma_presplit(dp, pbig[r], psmall[r],\n"
     "                       make_float2(vk[0], vk[LDV]),\n"
     "                       make_float2(vq[0], vq[LDV]));"),
]
VARIANTS_F32 = {
    # one TF32 product of the rounded operands: fails the tolerance
    "one_tf32": [(_PRODUCTS, "  mma_tf32(c, ab, bb0, bb1);")],
    # the running sums of S, or of S and O, kept in the mma's accumulator,
    # as against runs of QK_RUN / PV_RUN k8 steps from zero added into them
    # by FADD; or runs of one k8 step
    "qk_tc": _QK_TC,
    "tc_accumulate": _QK_TC + _PV_TC,
    "run1": [(_QK_RUN, "  static constexpr int QK_RUN = 1;\n"),
             (_PV_RUN, "  static constexpr int PV_RUN = 1;\n")],
    # Q K^T in runs of 2 k8 steps at every head dim
    "qk_run2": [(_QK_RUN, "  static constexpr int QK_RUN = 2;\n")],
    # both terms rounded by cvt.rna.tf32.f32 (4 instructions for big, its
    # guard for inf and NaN, 2 more for small), as against the integer
    # rounding of big and small passed unrounded
    "cvt_rna": [(_SPLIT, "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(big) : "
                 "\"f\"(x));\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : "
                 "\"=r\"(small)\n      : \"f\"(x - __uint_as_float(big)));")],
    "split_smem": SPLIT_SMEM,
    "bk32": [("  static constexpr int BK = HD <= 128 ? 64 : 32;",
              "  static constexpr int BK = 32;")],
    # one geometry at every shape: 64-row blocks with the keys split, or
    # 128-row blocks (head dim 256 keeps 64)
    "split_keys_all": [(_WIDE, "constexpr int WIDE = 1 << 20;")],
    "rows128_all": [(_WIDE, "constexpr int WIDE = 0;")],
    # probes (wrong results): one product of the raw operands, no split;
    # no exp in the softmax; no K / V (and head dim 256's Q) tile copies
    "probe_no_split": [(
        "  uint32_t bb0, bs0, bb1, bs1;\n  split_tf32(b0, bb0, bs0);\n"
        "  split_tf32(b1, bb1, bs1);\n" + _PRODUCTS,
        "  mma_tf32(c, ab, __float_as_uint(b0), __float_as_uint(b1));")],
    "probe_no_exp": [(
        "        sc[j][e] = exp2_approx(fmaf(sc[j][e], scale_log2, "
        "neg_m[e >> 1]));",
        "        sc[j][e] = fmaf(sc[j][e], scale_log2, neg_m[e >> 1]);")],
    "probe_no_loads": [(_LOADER, _LOADER.replace("e < ROWS * CPR", "e < 0"))],
}
# -- K1's bf16 kernels' variants (flash_attention_bwd.cu) --------------------
_MMA_SPLIT = """\
  mma_bf16(c0, lo, bf[0], bf[1]);
  mma_bf16(c0, hi, bf[0], bf[1]);
  mma_bf16(c1, lo, bf[2], bf[3]);
  mma_bf16(c1, hi, bf[2], bf[3]);"""
_BWD_LOADER = """\
  for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {"""
_DQ_MIN_BLOCKS = ("  static constexpr int MIN_BLOCKS = HD <= 64 ? 4 : HD <= 80 ? 3 "
                  ": 1;")

VARIANTS_BWD = {
    # P and dS as one bf16 term each: fails the bound
    "bwd_one_term": [(_MMA_SPLIT, """\
  mma_bf16(c0, hi, bf[0], bf[1]);
  mma_bf16(c1, hi, bf[2], bf[3]);""")],
    # geometry: dK / dV query tiles of 32 rows at every head dim (the
    # split plan is made for the variant's tiles); K and V re-read by
    # ldmatrix at every step of the dK / dV kernel; 8-warp dQ blocks (128
    # rows)
    "bwd_bq32": [("  static constexpr int BQ = HD <= 80 ? 64 : 32;",
                  "  static constexpr int BQ = 32;")],
    "bwd_kv_smem": [("  static constexpr bool IN_REGS = HD <= 80;",
                     "  static constexpr bool IN_REGS = false;")],
    "bwd_dq_8warps": [("struct DqPlan {\n  static constexpr int WARPS = 4;",
                       "struct DqPlan {\n  static constexpr int WARPS = 8;")],
    # 8 strips (128 keys) a dK / dV block up to head dim 128: each Q / dO
    # tile feeds twice the keys
    "bwd_dkdv_8strips": [("  static constexpr int STRIPS = 4;",
                          "  static constexpr int STRIPS = HD <= 128 ? 8 : 4;")],
    # registers capped so that 2 dQ blocks fit an SM at head dims 32 - 80
    # (the kernel asks 4 below 80, 3 at 80), or 3 dK / dV blocks
    "bwd_dq_2blocks": [(_DQ_MIN_BLOCKS, _DQ_MIN_BLOCKS.replace(
        "? 4 : HD <= 80 ? 3", "? 2 : HD <= 80 ? 2"))],
    "bwd_dkdv_3blocks": [("__launch_bounds__(DkvPlan<HD>::THREADS)",
                          "__launch_bounds__(DkvPlan<HD>::THREADS, 3)")],
    # probes (wrong results): no tile copies (the loads' share); no
    # products of dV, dK and dQ (the second products' share)
    "bwd_probe_no_loads": [(_BWD_LOADER,
                            _BWD_LOADER.replace("e < ROWS * CPR", "e < 0"))],
    "bwd_probe_no_grad_mma": [(_MMA_SPLIT, """\
  c0[0] += __uint_as_float(hi[0] ^ lo[1] ^ bf[0] ^ bf[1]);
  c1[0] += __uint_as_float(hi[2] ^ lo[3] ^ bf[2] ^ bf[3]);""")],
}
# -- K1's wgmma kernels' variants (flash_attention_bwd.cu, from BWD_WG_PART)
_WG_BWD_RS = """\
    mma_rs(d, lo[kk], db);
    mma_rs(d, hi[kk], db);"""
_WG_BWD_RS_TAIL = """\
      mma_rs(dt, lo[kk], dbt);
      mma_rs(dt, hi[kk], dbt);"""
VARIANTS_BWD_WG = {
    # P and dS as one bf16 term each: fails the bound
    "bwd_wg_one_term": [(_WG_BWD_RS, "    mma_rs(d, hi[kk], db);"),
                        (_WG_BWD_RS_TAIL, "      mma_rs(dt, hi[kk], dbt);")],
}
# -- K1's f32 kernels' variants (flash_attention_bwd.cu, from F32_PART) ----
_BWD_F32_SECOND = "        mma_split(part, xb[r], xs[r], bp[0], bp[LD]);"
VARIANTS_BWD_F32 = {
    # one TF32 product of the rounded operands in all five products: fails
    # the tolerance
    "bwd_f32_one_tf32": [("using attn::mma_split;\n", """\
// one TF32 product of the rounded operands
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&)[4], float b0,
                                          float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  attn::split_tf32(b0, bb0, bs0);
  attn::split_tf32(b1, bb1, bs1);
  attn::mma_tf32(c, ab, bb0, bb1);
}
""")],
    # dK / dV: two warps share a strip's columns at head dim 128 too (as
    # at 256: 16-row query tiles, no spill, S^T and dP^T computed twice)
    "bwd_f32_hsplit128": [("  static constexpr bool HSPLIT = HD > 128;",
                           "  static constexpr bool HSPLIT = HD >= 128;")],
    # the split's sum one block a key tile (as bf16's), its slots' loads
    # in turn
    "bwd_f32_sum_whole": [("constexpr int SUM_PARTS = 8;",
                           "constexpr int SUM_PARTS = 1;"),
                          ("SUM_PARTS, true>(ws", "SUM_PARTS, false>(ws")],
    # probes (wrong results): no tile copies (the loads' share); no dQ, dK
    # and dV products, their B pairs read but neither split nor multiplied
    # (the second products' share); one product of the raw operands, B
    # unsplit (the share of the split's extra products and B's splits)
    "bwd_f32_probe_no_loads": [(_BWD_LOADER, _BWD_LOADER.replace(
        "e < ROWS * CPR", "e < 0"))],
    "bwd_f32_probe_no_second": [(_BWD_F32_SECOND, (
        "        part[0] += bp[0] + bp[LD] + "
        "__uint_as_float(xb[r][0] ^ xs[r][3]);"))],
    "bwd_f32_probe_one_mma": [("using attn::mma_split;\n", """\
// one product of the raw operands
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&)[4], float b0,
                                          float b1) {
  attn::mma_tf32(c, ab, __float_as_uint(b0), __float_as_uint(b1));
}
""")],
}
# K1's checkout kernels launched unsplit at every shape
UNSPLIT = "unsplit"
# f32 dK / dV tiles (keys, query rows) of the variants whose tiles are
# not BWD_TILES[float32][hd]: the split plan is made for them (a bf16
# variant's are read from its source, bf16_tiles)
BWD_TILES_OF = {"bwd_f32_hsplit128": lambda hd, tiles: (
    (64, 16) if hd == 128 else tiles)}


def _constexpr(body: str, name: str, hd: int) -> int:
    """The value at head dim ``hd`` of ``static constexpr int <name> =
    <expr>;`` in a struct's body: a number, or ``HD <= n ? a : <expr>``."""
    expr = re.search(rf"static constexpr int {name} = ([^;]+);",
                     body).group(1).strip()
    while not expr.isdigit():
        cond = re.fullmatch(r"HD (<=|<|==) (\d+) \? (\d+) : (.+)", expr)
        if cond is None:
            raise ValueError(f"{name} = {expr}: not a form this reads")
        op, n, a, rest = cond.groups()
        if {"<=": hd <= int(n), "<": hd < int(n), "==": hd == int(n)}[op]:
            return int(a)
        expr = rest.strip()
    return int(expr)


def bf16_tiles(text: str, hd: int) -> tuple:
    """K1's bf16 dK / dV tiles (keys, query rows) at head dim ``hd`` in the
    K1 source ``text``: its wgmma kernel's (wg::DkvGeo) where its dispatch
    sends the head dim there (``WG_CASE``), else its mma.sync one's
    (tc::DkvPlan, 16 STRIPS keys)."""
    def body(struct: str, namespace: str) -> str:
        part = text.split(f"namespace {namespace} {{", 1)[1]
        return re.search(rf"struct {struct} {{(.*?)\n}};", part,
                         re.S).group(1)
    if f"WG_CASE({hd})" in text:
        geo = body("DkvGeo", "wg")
        return _constexpr(geo, "BK", hd), _constexpr(geo, "BQ", hd)
    plan = body("DkvPlan", "tc")
    return 16 * _constexpr(plan, "STRIPS", hd), _constexpr(plan, "BQ", hd)
VARIANTS = {"checkout": [], UNSPLIT: [], **VARIANTS_F32, **VARIANTS_BF16,
            **VARIANTS_BWD_WG, **VARIANTS_BWD, **VARIANTS_BWD_F32}
MUST_FAIL = {"one_tf32", "single_p", "bwd_one_term", "bwd_wg_one_term",
             "bwd_f32_one_tf32"}
OWN = {"f32": VARIANTS_F32, "bf16": VARIANTS_BF16}
OWN_BWD = {"f32": VARIANTS_BWD_F32,
           "bf16": {**VARIANTS_BWD_WG, **VARIANTS_BWD}}
# the parts of the sources (``sources``) each kind of variant edits: the
# f32 forward's variants edit its part and the header's split-TF32
# products, which K1's f32 kernels share
PARTS = {**{n: ("f32", "common") for n in VARIANTS_F32},
         **{n: ("bf16",) for n in VARIANTS_BF16},
         **{n: ("bwd_wg",) for n in VARIANTS_BWD_WG},
         **{n: ("bwd",) for n in VARIANTS_BWD},
         **{n: ("bwd_f32",) for n in VARIANTS_BWD_F32}}

# (label, b, s, h, kvh, hd, window, causal, prefix): every f32 shape of
# chip_smoke.py's phase 3 (phase 11's danube cut; phase 17's paligemma
# prefill and the f32 cuts of 17a, 17c, 17d; phase 18a's zamba2 cut; the
# two dense configs no phase serves)
F32_SHAPES = [
    ("danube_prefill_f32_s4128", 8, 4128, 32, 8, 80, 4096, True, 0),
    ("paligemma_prefill_f32", 4, 1024, 8, 1, 256, None, True, 256),
    ("qwen2_moe_cut_prefill_f32", 2, 256, 16, 16, 128, None, True, 0),
    ("qwen2_moe_cut_forward_f32", 2, 288, 16, 16, 128, None, True, 0),
    ("paligemma_cut_forward_f32", 2, 544, 8, 1, 256, None, True, 256),
    ("hubert_cut_f32", 2, 1024, 16, 16, 80, None, False, 0),
    ("zamba2_cut_forward_f32", 2, 288, 32, 32, 64, None, True, 0),
    ("command_r_prefill_f32", 2, 2048, 96, 8, 128, None, True, 0),
    ("qwen15_32b_prefill_f32", 2, 2048, 40, 40, 128, None, True, 0)]


def bf16_shapes() -> list:
    """Every bf16 forward shape of chip_smoke.py's phase 3, as (label, b,
    s, h, kvh, hd, window, causal, prefix, lse): its serving cases
    (``FLASH_CASES``, the entry without the row log-sum-exp) and, under
    the label ``<case>_lse``, K1's (``K1_CASES``, the forward with it)."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke
    out = []
    for cases, lse in ((chip_smoke.FLASH_CASES, False),
                       (chip_smoke.K1_CASES, True)):
        for label, b, s, h, kvh, hd, window, dt, causal, prefix in cases:
            if dt == "bfloat16":
                out.append((label + ("_lse" if lse else ""), b, s, h, kvh,
                            hd, window, causal, prefix, lse))
    return out


def shapes(dtype: str) -> list:
    """The forward shapes of a dtype, each ending in whether it runs the
    entry with the row log-sum-exp."""
    if dtype == "f32":
        return [(*shape, False) for shape in F32_SHAPES]
    return bf16_shapes()

TOL = {"f32": (2e-4, 2e-4), "bf16": (1e-2, 1e-3)}
# H100 SXM data sheet, 700 W: TF32 and bf16 tensor cores (dense), fp32
# FMA, memory
TF32_TFLOPS, BF16_TFLOPS, FP32_TFLOPS, TBS = 495.0, 989.0, 67.0, 3.35


def sources(name: str) -> dict:
    """The texts of ``flash_attention.cu``, ``flash_attention_bwd.cu``,
    ``attention_common.cuh`` and ``wgmma_common.cuh`` in variant ``name``,
    by file name; ``a+b`` is variant a's edits, then b's.  Each edit
    replaces a text that occurs exactly once in the parts its kind edits
    (``PARTS``): the forward's f32 kernel (from ``F32_PART`` on) and the
    header, the forward's bf16 kernels (the rest), K1's wgmma kernels
    (from ``BWD_WG_PART`` to ``BWD_PART``), its mma.sync kernels (from
    ``BWD_PART`` to ``F32_PART``) or its f32 kernels (from ``F32_PART``
    on)."""
    head, sep, tail = (ROOT / CSRC / SOURCE).read_text().partition(F32_PART)
    bhead, wsep, btail = (ROOT / CSRC / BWD_SOURCE).read_text().partition(
        BWD_WG_PART)
    bwg, bsep, btail = btail.partition(BWD_PART)
    btc, fsep, bf32 = btail.partition(F32_PART)
    parts = {"common": (ROOT / CSRC / HEADER).read_text(), "bf16": head,
             "f32": sep + tail, "bwd_wg": wsep + bwg, "bwd": bsep + btc,
             "bwd_f32": fsep + bf32}
    for part in name.split("+"):
        for old, new in VARIANTS[part]:
            found = [key for key in PARTS[part] if old in parts[key]]
            if len(found) != 1 or parts[found[0]].count(old) != 1:
                raise ValueError(f"variant {name}: text not found once in "
                                 f"the parts {PARTS[part]}:\n{old}")
            parts[found[0]] = parts[found[0]].replace(old, new)
    return {SOURCE: parts["bf16"] + parts["f32"],
            BWD_SOURCE: bhead + parts["bwd_wg"] + parts["bwd"]
            + parts["bwd_f32"],
            HEADER: parts["common"],
            WG_HEADER: (ROOT / CSRC / WG_HEADER).read_text()}


def _entry(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(tmp: Path, names, parent) -> dict:
    """Build both libraries of every variant (all nvcc started together);
    returns {variant: {entry: function}}, the split entry where the
    variant has one (and ``split_f32``: whether it takes f32)."""
    from repro_torch.kernels import cuda_build
    procs, takes_f32 = {}, {}
    for name in names:
        d = tmp / name
        d.mkdir()
        # a parent from before the wgmma header has none
        texts = ({f: (Path(parent) / CSRC / f).read_text()
                  for f in (SOURCE, BWD_SOURCE, HEADER, WG_HEADER)
                  if (Path(parent) / CSRC / f).exists()}
                 if name == "parent" else sources(name))
        takes_f32[name] = SPLIT_TAKES_F32 in texts[BWD_SOURCE]
        for f, text in texts.items():
            (d / f).write_text(text)
            if f in (HEADER, WG_HEADER):
                continue
            procs[name, f] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                 str(d / f"lib{Path(f).stem}.so"), str(d / f)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (name, f), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name} {f}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                inst = short(line.split("'")[1])
                print(f"ptxas {name} {inst}: " + " | ".join(
                    x.strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x), flush=True)
    entries = {}
    for name in names:
        fwd = ctypes.CDLL(str(tmp / name / "libflash_attention.so"))
        bwd = ctypes.CDLL(str(tmp / name / "libflash_attention_bwd.so"))
        entries[name] = {
            "fwd": _entry(fwd, "flash_attention_fwd",
                          [P] * 4 + [I] * 9 + [F, P]),
            "fwd_lse": _entry(fwd, "flash_attention_fwd_lse",
                              [P] * 5 + [I] * 9 + [F, P]),
            "bwd": _entry(bwd, "flash_attention_bwd",
                          [P] * 10 + [I] * 9 + [F, P])}
        entries[name]["bwd_text"] = (tmp / name / BWD_SOURCE).read_text()
        if hasattr(bwd, "flash_attention_bwd_split") and name != UNSPLIT:
            entries[name]["split_f32"] = takes_f32[name]
            entries[name]["bwd_split"] = _entry(
                bwd, "flash_attention_bwd_split",
                [P] * 10 + [I] * (9 if takes_f32[name] else 8)
                + [F, I, I, P, I, P, P])
    return entries


def short(mangled: str) -> str:
    """A kernel instance's mangled name without its anonymous namespace
    (which names the source file) and its parameter list.  The forward
    without the row log-sum-exp (a third template argument, WRITE_LSE =
    false) goes by its name from before the flag, so that a parent
    without it compares with it."""
    name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", mangled)
    name = name.split("EEv")[0]
    args = re.findall(r"L[a-z]\d+E", name)
    return name[:-4] if len(args) == 3 and args[-1] == "Lb0E" else name


def sass(so: Path) -> dict:
    """Every kernel's SASS in ``so``, by short name, as lists of
    instructions without addresses or encodings."""
    from repro_torch.kernels import cuda_build
    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = short(found.group(1))
            out[fn] = []
        elif fn:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
            if ins:
                out[fn].append(ins.group(1).strip())
    return out


def report_sass(tmp: Path, names) -> None:
    """For each library, whether each instance is the first variant's
    instruction for instruction (``new`` where the first has no such
    instance: the forward with the row log-sum-exp against a parent
    without it, K1's bf16 kernels against a parent with the FMA ones),
    each instance's tensor-core and arithmetic instructions by kind (the
    forward's bf16 instances excepted), and a ``sass_check`` line
    counting them."""
    for lib in ("libflash_attention.so", "libflash_attention_bwd.so"):
        codes = {name: sass(tmp / name / lib) for name in names}
        base = codes[names[0]]
        for name in names:
            counts = {"identical": [], "different": [], "new": [],
                      "gone": sorted(set(base) - set(codes[name]))}
            for fn, ins in sorted(codes[name].items()):
                if name != names[0]:
                    same = ("new" if fn not in base else
                            "identical" if base[fn] == ins else "different")
                    counts[same].append(fn)
                    print(f"sass {name} vs {names[0]} {fn}: {len(ins)} / "
                          f"{len(base.get(fn, []))} instructions, {same}",
                          flush=True)
                if "bf16_mma" in fn:
                    continue
                kinds = {}
                for i in ins:
                    op = i.split()[0] if not i.startswith("@") \
                        else i.split()[1]
                    if op.startswith(("HMMA", "HGMMA", "UTMALDG", "FFMA",
                                      "MUFU", "LDS", "LDGSTS", "F2F",
                                      "FADD", "LDSM")):
                        kinds[op] = kinds.get(op, 0) + 1
                print(f"sass {name} {fn}: {len(ins)} instructions, "
                      + json.dumps(dict(sorted(kinds.items()))), flush=True)
            if lib == "libflash_attention_bwd.so":
                wgmma_check(name, codes[name])
            if name != names[0]:
                print("sass_check " + json.dumps(
                    {"variant": name, "base": names[0], "library": lib,
                     **{k: len(v) for k, v in counts.items()},
                     "different_instances": counts["different"],
                    "gone_instances": counts["gone"]}),
                    flush=True)


def wgmma_check(name: str, code: dict) -> None:
    """Each wgmma instance of K1 in ``code`` (SASS by instance): its
    ``HGMMA``, ``UTMALDG`` and ``HMMA`` instructions, printed as a
    ``wgmma_check`` line; raises if one has no ``HGMMA`` or ``UTMALDG``,
    or any ``HMMA``."""
    counts = {}
    for fn, ins in sorted(code.items()):
        if "wgmma" not in fn:
            continue
        ops = [i.split()[1] if i.startswith("@") else i.split()[0]
               for i in ins]
        counts[fn] = {kind: sum(op.startswith(kind) for op in ops)
                      for kind in ("HGMMA", "UTMALDG", "HMMA")}
        c = counts[fn]
        if not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"]:
            raise AssertionError(f"{name} {fn}: {c}")
    print("wgmma_check " + json.dumps({"variant": name,
                                       "instances": counts}), flush=True)


def attention_pairs(s, causal, window, prefix) -> int:
    import numpy as np
    qp = np.arange(s, dtype=np.int64)
    hi = np.where(qp < prefix, prefix - 1, qp) if causal \
        else np.full(s, s - 1, dtype=np.int64)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(s, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def time_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, per_call: bool = False) -> float:
    """Mean time on the card of the one kernel ``fn`` launches, by
    torch.profiler: the host's launch time and the gaps between kernels
    excluded; the mean over the launches the profiler recorded (it may
    miss some), and a second window if it recorded none.  ``per_call``:
    the time of all the kernels a call launches, over ``reps`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        count = sum(e.count for e in events)
        if count:
            return sum(e.self_device_time_total for e in events) / 1e3 \
                / (reps if per_call else count)
    raise RuntimeError("the profiler recorded no kernel")


def orders(names: list, rounds: int) -> list:
    return [names if rnd % 2 == 0 else names[::-1] for rnd in range(rounds)]


def run_shapes(dtype, names, rounds, entries, results) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rtol, atol = TOL[dtype]
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    for label, b, s, h, kvh, hd, window, causal, prefix, with_lse in \
            shapes(dtype):
        q, k, v = (torch.randn(b, s, n, hd, device="cuda", generator=gen
                               ).to(tdt) for n in (h, kvh, kvh))
        opts = dict(causal=causal, window=window, prefix_len=prefix)
        want, want_lse = ref.flash_attention_lse(q, k, v, **opts)
        want = want.float()
        flops = 4.0 * b * h * hd * attention_pairs(s, causal, window,
                                                    prefix)
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) \
            + (4 * b * h * s if with_lse else 0)
        peak = TF32_TFLOPS / 3 if dtype == "f32" else BF16_TFLOPS
        meta = {"flops": flops, "hd": hd, "lse": with_lse,
                "issued_flops": flops * (1.5 if dtype == "bf16" else 1.0),
                "bound_ms": max(nbytes / TBS / 1e9, flops / peak / 1e9),
                "bound_fp32_ms": max(nbytes / TBS / 1e9,
                                     flops / FP32_TFLOPS / 1e9)}
        reps = max(5, min(200, int(40 / max(meta["bound_ms"] * 4, 0.01))))
        if rounds:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None
            if (window is not None and window < s) or (causal and prefix):
                pos = torch.arange(s, device="cuda")
                mask = ref.attention_keep(pos, pos, **opts)
                kt, vt = (x.repeat_interleave(h // kvh, dim=1)
                          for x in (kt, vt))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None,
                    enable_gqa=mask is None)
            meta["sdpa_ms"] = time_ms(sdpa, reps)
            meta["sdpa_device_ms"] = device_ms(sdpa, min(reps, 20),
                                               per_call=True)
            meta["plain_ms"] = time_ms(
                lambda: ref.flash_attention(q, k, v, **opts),
                max(3, reps // 10))
            del qt, kt, vt, mask
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
        lse_ptr = (lse.data_ptr(),) if with_lse else ()

        def launch(name):
            fn = entries[name]["fwd_lse" if with_lse else "fwd"]
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), *lse_ptr, b, s, h, kvh, hd,
                      int(causal), window or 0, prefix, int(dtype == "bf16"),
                      hd ** -0.5, stream)
            if code:
                raise RuntimeError(f"launch failed with {code}")

        firsts = {}
        for rnd, order in enumerate(orders(names, max(rounds, 1))):
            for name in order:
                try:   # a variant may not fit a head dim in shared memory
                    launch(name)
                except RuntimeError as err:
                    print(json.dumps({"variant": name, "case": label,
                                      "refused": str(err)}), flush=True)
                    continue
                torch.cuda.synchronize()
                got = out.float()
                excess = float(((got - want).abs() - rtol * want.abs()
                                ).max())
                within = excess <= atol
                if with_lse:
                    # the row log-sum-exp: the kernel tolerance (f32's)
                    lse_err = float(((lse - want_lse).abs()
                                     - 2e-4 * want_lse.abs()).max())
                    within = within and lse_err <= 2e-4
                if name in MUST_FAIL and within:
                    raise AssertionError(f"{name} {label} is within the "
                                         "tolerance it must fail")
                if name in ("checkout", "parent") and not within:
                    raise AssertionError(f"{name} {label} is outside the "
                                         "tolerance")
                firsts.setdefault(name, got.clone())
                rec = {"variant": name, "round": rnd, "case": label,
                       "max_abs_err": float((got - want).abs().max()),
                       "within_tolerance": within,
                       "same_bits": bool(torch.equal(
                           got, firsts.get(names[0], got)))}
                if with_lse:
                    rec["lse_excess"] = lse_err
                if rounds:
                    rec["ms"] = time_ms(lambda: launch(name), reps)
                    rec["device_ms"] = device_ms(lambda: launch(name),
                                                 min(reps, 20))
                    rec["tflops"] = flops / rec["device_ms"] / 1e9
                    rec["issued_tflops"] = meta["issued_flops"] \
                        / rec["device_ms"] / 1e9
                    if "sdpa_device_ms" in meta:
                        rec["x_sdpa"] = rec["device_ms"] \
                            / meta["sdpa_device_ms"]
                    slot = results.setdefault(label, {"_meta": meta})
                    slot.setdefault(name, []).append(
                        {k: rec[k] for k in ("ms", "device_ms")})
                print(json.dumps({**rec, **meta}), flush=True)
        del q, k, v, want, want_lse, out, lse, firsts
        torch.cuda.empty_cache()


def kernel_ms(fn, reps: int) -> dict:
    """Mean ms a call of each kernel ``fn`` launches, by name (the
    template arguments dropped), by torch.profiler over ``reps`` calls (a
    further window, up to three, where it recorded none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # another window if the profiler recorded none
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out: dict = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                found = re.search(r"(\w+)<", e.key) or \
                    re.search(r"(\w+)\(", e.key)
                name = found.group(1) if found else e.key
                out[name] = out.get(name, 0.0) + \
                    e.self_device_time_total / 1e3 / reps
        if out:
            return out
    raise RuntimeError("the profiler recorded no kernel")


def run_bwd_shapes(dtypes, names, rounds, entries, results) -> None:
    """K1 at chip_smoke.py's K1_CASES of ``dtypes``: each variant held to
    the plain gradient and a second call, then timed (module docstring)."""
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import chip_smoke
    from flash_bounds import flash_attention_bwd_bf16_bound
    from repro_torch.kernels import flash_attention as cuda_fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, b, s, h, kvh, hd, window, dt, causal, prefix in \
            chip_smoke.K1_CASES:
        bf16 = dt == "bfloat16"
        if ("bf16" if bf16 else "f32") not in dtypes:
            continue
        tdt = getattr(torch, dt)
        q, dout = (torch.randn(b, s, h, hd, device="cuda", generator=gen
                               ).to(tdt) for _ in range(2))
        k, v = (torch.randn(b, s, kvh, hd, device="cuda", generator=gen
                            ).to(tdt) for _ in range(2))
        opts = dict(causal=causal, window=window, prefix_len=prefix)
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
        common = (b, s, h, kvh, hd, int(causal), window or 0, prefix)
        if entries[names[0]]["fwd_lse"](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *common, int(bf16), hd ** -0.5, stream):
            raise RuntimeError("flash_attention_fwd_lse failed")
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ref.flash_attention(*leaves, **opts).backward(dout)
        want = [x.grad for x in leaves]
        del leaves
        flops = 10.0 * b * h * hd * attention_pairs(s, causal, window,
                                                     prefix)
        nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel()) \
            + 4 * b * h * s
        peak = BF16_TFLOPS if bf16 else TF32_TFLOPS / 3
        meta = {"dtype": dt, "flops": flops,
                "bound_ms": max(nbytes / TBS / 1e9, flops / peak / 1e9)}
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty_like(lse)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common)
        splits = {}
        for name in names:
            if bf16:
                tiles = bf16_tiles(entries[name]["bwd_text"], hd)
            else:
                tiles = cuda_fa.BWD_TILES[tdt][hd]
                for part in name.split("+"):
                    if part in BWD_TILES_OF:
                        tiles = BWD_TILES_OF[part](hd, tiles)
            made = cuda_fa.bwd_split_plan(b * kvh, s, h // kvh, *tiles,
                                          causal, window, prefix, sms)
            if made is not None and "bwd_split" in entries[name] and (
                    bf16 or entries[name]["split_f32"]):
                plan, n, slots = made
                splits[name] = (tiles, torch.from_numpy(plan).cuda(), n,
                                torch.empty(slots * b * kvh * 2 * tiles[0]
                                            * hd, device="cuda"))
        meta["split_entries"] = splits["checkout"][2] \
            if "checkout" in splits else 0

        def launch(name):
            if name in splits:
                (bk, bq), plan, n, ws = splits[name]
                dtype_arg = (int(bf16),) if entries[name]["split_f32"] \
                    else ()
                code = entries[name]["bwd_split"](
                    *args, *dtype_arg, hd ** -0.5, bk, bq, plan.data_ptr(),
                    n, ws.data_ptr(), stream)
            else:
                code = entries[name]["bwd"](*args, int(bf16), hd ** -0.5,
                                            stream)
            if code:
                raise RuntimeError(f"{name}: launch failed with {code}")

        reps = max(3, min(100, int(40 / max(meta["bound_ms"] * 10, 0.01))))
        if rounds:
            qt, kt, vt, mask = chip_smoke.sdpa_inputs(q, k, v, causal,
                                                      window, prefix)
            lq, lk, lv = (x.detach().requires_grad_(True)
                          for x in (qt, kt, vt))
            lib_out = F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=mask is None)
            gt = dout.transpose(1, 2)
            meta["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), gt, retain_graph=True), reps)
            meta["plain_ms"] = time_ms(lambda: ref.flash_attention_bwd(
                q, k, v, out, dout, lse, **opts), 3)
            del qt, kt, vt, mask, lq, lk, lv, lib_out
        # a dtype's shapes run the parent, the checkout, unsplit and the
        # variants of the kernels the shape's head dim takes (bf16: the
        # wgmma ones at 80 and 128, the mma.sync ones at the others)
        own = OWN_BWD["bf16" if bf16 else "f32"]
        if bf16:
            own = (VARIANTS_BWD_WG if hd in cuda_fa.BWD_WGMMA_HEAD_DIMS
                   else VARIANTS_BWD)
        mine = [n for n in names if n in ("parent", "checkout", UNSPLIT)
                or all(part in own for part in n.split("+"))]
        for rnd, order in enumerate(orders(mine, max(rounds, 1))):
            for name in order:
                rec = {"variant": name, "round": rnd, "case": label}
                if rnd == 0:
                    launch(name)
                    got = (dq.clone(), dk.clone(), dv.clone())
                    launch(name)
                    torch.cuda.synchronize()
                    rec["same_bits_twice"] = all(
                        torch.equal(a, b_) for a, b_ in zip(got, (dq, dk,
                                                                  dv)))
                    if bf16:
                        bounds = flash_attention_bwd_bf16_bound(
                            q, k, v, out, dout, lse, got, want, **opts)
                        frac = max(float(((g.float() - w.float()).abs()
                                          / bd).max())
                                   for g, w, bd in zip(got, want, bounds))
                        del bounds
                    else:
                        frac = max(float(((g - w).abs() - 2e-4 * w.abs()
                                          ).max()) / 2e-4
                                   for g, w in zip(got, want))
                    rec["max_abs_err"] = max(float((g.float() - w.float()
                                                    ).abs().max())
                                             for g, w in zip(got, want))
                    rec["of_bound"] = frac
                    within = frac <= 1.0 and rec["same_bits_twice"]
                    if name in MUST_FAIL and frac <= 1.0:
                        raise AssertionError(f"{name} {label} is within "
                                             "the bound it must leave")
                    if name in ("checkout", "parent", UNSPLIT) \
                            and not within:
                        raise AssertionError(f"{name} {label}: {rec}")
                    del got
                if rounds:
                    rec["ms"] = time_ms(lambda: launch(name), reps)
                    by_kernel = kernel_ms(lambda: launch(name),
                                          min(reps, 10))
                    rec["device_ms"] = sum(by_kernel.values())
                    rec["kernels_ms"] = by_kernel
                    rec["tflops"] = flops / rec["device_ms"] / 1e9
                    slot = results.setdefault(label, {"_meta": meta})
                    slot.setdefault(name, []).append(
                        {k: rec[k] for k in ("ms", "device_ms")})
                print(json.dumps({**rec, **meta}), flush=True)
        del q, k, v, dout, out, lse, want, dq, dk, dv, delta, splits
        torch.cuda.empty_cache()


def summary(names, results) -> None:
    base = names[0]
    for label, by in results.items():
        med = {name: {key: statistics.median(x[key] for x in by[name])
                      for key in by[name][0]}
               for name in names if name in by}
        print("summary " + json.dumps({
            "case": label, "base": base, **by["_meta"],
            **{name: {**t, **{f"{key}_vs_base": t[key] / med[base][key]
                              for key in t if base in med}}
               for name, t in med.items()}}), flush=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout, built as "
                    "the variant 'parent' and run first")
    ap.add_argument("--entries", default="fwd",
                    help="comma-separated: fwd (the prefill entry), bwd "
                    "(K1) (default fwd)")
    ap.add_argument("--dtypes", default="f32",
                    help="comma-separated: f32, bf16 (default f32)")
    ap.add_argument("--rounds", type=int, default=4,
                    help="rounds of all variants (default 4; 0: build, "
                    "read the SASS and check once, no timing)")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes, kinds = args.dtypes.split(","), args.entries.split(",")
    names = args.variants or ["checkout"] + [
        n for d in dtypes for n in OWN[d] if "fwd" in kinds] + (
        [UNSPLIT] + [n for d in dtypes for n in OWN_BWD[d]]
        if "bwd" in kinds else [])
    unknown = [n for n in names
               if any(part not in VARIANTS for part in n.split("+"))]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{', '.join(VARIANTS)}")
    if args.parent:
        names = ["parent"] + names
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    results: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(Path(tmp), names, args.parent)
        report_sass(Path(tmp), names)
        for dtype in dtypes if "fwd" in kinds else ():
            # a dtype's shapes run the parent, the checkout and its own
            # kernel's variants
            mine = [n for n in names if n in ("parent", "checkout") or all(
                part in OWN[dtype] for part in n.split("+"))]
            run_shapes(dtype, mine, args.rounds, entries, results)
        if "bwd" in kinds:
            run_bwd_shapes(dtypes, names, args.rounds, entries, results)
    summary(names, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
