"""Iterative models (paper §3.2, Table 1) as program generators.

Each generator emits a straight-line :class:`Program` whose statements
follow one of the three recurrences — linear, exponential, skip-s — for

  * matrix powers            P_k = A^k
  * sums of matrix powers    S_k = I + A + … + A^{k-1}
  * the general form         T_{i+1} = A·T_i + B

The emitted program is then fed to the LINVIEW compiler; the incremental /
re-evaluation / hybrid strategies of Table 2 correspond to how the program
is executed, not to different programs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import expr as ex
from .program import Program, dim


def _check_pow2(x: int, what: str):
    if x < 1 or (x & (x - 1)) != 0:
        raise ValueError(f"{what} must be a power of two, got {x}")


def matrix_powers(k: int, n: int, model: str = "exp", s: int = 4,
                  name: Optional[str] = None) -> Program:
    """P_k = A^k per Table 1. Views are named ``P{i}``; output is ``P{k}``."""
    p = Program(name=name or f"powers_{model}_k{k}")
    N = dim("n")
    A = p.input("A", (N, N))
    p.bind_dims(n=n)

    views: Dict[int, ex.Expr] = {1: A}
    if model == "linear":
        for i in range(2, k + 1):
            views[i] = p.let(f"P{i}", ex.matmul(A, views[i - 1]))
    elif model == "exp":
        _check_pow2(k, "k")
        i = 2
        while i <= k:
            half = views[i // 2]
            views[i] = p.let(f"P{i}", ex.matmul(half, half))
            i *= 2
    elif model == "skip":
        _check_pow2(s, "s")
        if k % s != 0:
            raise ValueError(f"k={k} must be a multiple of s={s}")
        i = 2
        while i <= s:
            half = views[i // 2]
            views[i] = p.let(f"P{i}", ex.matmul(half, half))
            i *= 2
        Ps = views[s]
        for i in range(2 * s, k + 1, s):
            views[i] = p.let(f"P{i}", ex.matmul(Ps, views[i - s]))
    else:
        raise ValueError(f"unknown model {model!r}")
    p.outputs = [f"P{k}"] if k > 1 else []
    return p


def sums_of_powers(k: int, n: int, model: str = "exp", s: int = 4,
                   name: Optional[str] = None) -> Program:
    """S_k = I + A + … + A^{k-1} per Table 1.  Output view ``S{k}``."""
    p = Program(name=name or f"sums_{model}_k{k}")
    N = dim("n")
    A = p.input("A", (N, N))
    p.bind_dims(n=n)
    I = ex.identity(N)

    S: Dict[int, ex.Expr] = {}
    P: Dict[int, ex.Expr] = {1: A}
    if model == "linear":
        S[1] = p.let("S1", ex.add(I))  # S_1 = I  (Add of single identity)
        for i in range(2, k + 1):
            S[i] = p.let(f"S{i}", ex.add(ex.matmul(A, S[i - 1]), I))
    elif model == "exp":
        _check_pow2(k, "k")
        S[1] = p.let("S1", ex.add(I))
        i = 2
        while i <= k:
            if i < k:  # P_k itself is not needed for S_k
                P[i] = p.let(f"P{i}", ex.matmul(P[i // 2], P[i // 2]))
            half_p = P[i // 2]
            S[i] = p.let(f"S{i}", ex.add(ex.matmul(half_p, S[i // 2]), S[i // 2]))
            i *= 2
    elif model == "skip":
        _check_pow2(s, "s")
        if k % s != 0:
            raise ValueError(f"k={k} must be a multiple of s={s}")
        S[1] = p.let("S1", ex.add(I))
        i = 2
        while i <= s:
            P[i] = p.let(f"P{i}", ex.matmul(P[i // 2], P[i // 2]))
            S[i] = p.let(f"S{i}", ex.add(ex.matmul(P[i // 2], S[i // 2]), S[i // 2]))
            i *= 2
        for i in range(2 * s, k + 1, s):
            S[i] = p.let(f"S{i}", ex.add(ex.matmul(P[s], S[i - s]), S[s]))
    else:
        raise ValueError(f"unknown model {model!r}")
    p.outputs = [f"S{k}"]
    return p


def append_general_iteration(prog: Program, A: ex.Expr, B: Optional[ex.Expr],
                             T0: ex.Expr, k: int, model: str = "exp",
                             s: int = 4, prefix: str = "") -> str:
    """Append Table-1 statements for T_{i+1} = A·T_i (+ B) to ``prog``.

    ``A`` may be an input *or a previously-defined view* (PageRank and
    gradient descent derive their transition matrix as a view).  Returns
    the name of the output view ``T{k}``.
    """
    N = A.shape[0]
    with_b = B is not None

    def step(x: ex.Expr) -> ex.Expr:
        ax = ex.matmul(A, x)
        return ex.add(ax, B) if with_b else ax

    T: Dict[int, ex.Expr] = {}
    Pw: Dict[int, ex.Expr] = {1: A}
    S: Dict[int, ex.Expr] = {1: ex.identity(N)}

    def emit_doubling(i: int):
        h = i // 2
        Pw[i] = prog.let(f"{prefix}P{i}", ex.matmul(Pw[h], Pw[h]))
        if with_b:
            S[i] = prog.let(f"{prefix}S{i}",
                            ex.add(ex.matmul(Pw[h], S[h]), S[h]))
            T[i] = prog.let(f"{prefix}T{i}", ex.add(ex.matmul(Pw[h], T[h]),
                                                    ex.matmul(S[h], B)))
        else:
            T[i] = prog.let(f"{prefix}T{i}", ex.matmul(Pw[h], T[h]))

    if model == "linear":
        T[1] = prog.let(f"{prefix}T1", step(T0))
        for i in range(2, k + 1):
            T[i] = prog.let(f"{prefix}T{i}", step(T[i - 1]))
    elif model == "exp":
        _check_pow2(k, "k")
        T[1] = prog.let(f"{prefix}T1", step(T0))
        i = 2
        while i <= k:
            emit_doubling(i)
            i *= 2
    elif model == "skip":
        _check_pow2(s, "s")
        if k % s != 0:
            raise ValueError(f"k={k} must be a multiple of s={s}")
        T[1] = prog.let(f"{prefix}T1", step(T0))
        i = 2
        while i <= s:
            emit_doubling(i)
            i *= 2
        for i in range(2 * s, k + 1, s):
            if with_b:
                T[i] = prog.let(f"{prefix}T{i}",
                                ex.add(ex.matmul(Pw[s], T[i - s]),
                                       ex.matmul(S[s], B)))
            else:
                T[i] = prog.let(f"{prefix}T{i}", ex.matmul(Pw[s], T[i - s]))
    else:
        raise ValueError(f"unknown model {model!r}")
    return f"{prefix}T{k}"


def general_form(k: int, n: int, p_dim: int, model: str = "exp", s: int = 4,
                 with_b: bool = True, name: Optional[str] = None) -> Program:
    """T_i per Table 1 for T_{i+1} = A·T_i + B.  Output ``T{k}``.

    ``T0`` (n×p) and ``B`` (n×p) are inputs; ``A`` (n×n) is the dynamic
    matrix.  ``with_b=False`` gives the degenerate T_{i+1} = A·T_i used in
    the paper's Fig. 3g study.
    """
    prog = Program(name=name or f"general_{model}_k{k}")
    N, P_ = dim("n"), dim("p")
    A = prog.input("A", (N, N))
    T0 = prog.input("T0", (N, P_))
    B = prog.input("B", (N, P_)) if with_b else None
    prog.bind_dims(n=n, p=p_dim)
    out = append_general_iteration(prog, A, B, T0, k, model, s)
    prog.outputs = [out]
    return prog
