"""Symbolic linear-algebra expression IR for LINVIEW.

The delta calculus (paper §4.1) operates on a small symbolic IR rather than
on traced JAX values: derivation, common-factor extraction and CSE all
happen *before* staging to XLA, mirroring the paper's compiler/runtime
split (Fig. 2).

Nodes are immutable and hash-consed so that structural equality is pointer
equality; this makes common-subexpression detection during trigger
compilation cheap.

Shapes are symbolic pairs ``(rows, cols)`` where each element is either an
``int`` or a ``Dim`` (a named symbolic dimension).  Vectors are ``(n, 1)``
matrices; scalars are ``(1, 1)``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple, Union


# ---------------------------------------------------------------------------
# symbolic dimensions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Dim:
    """A named symbolic dimension (e.g. ``n``, ``m``, ``p``)."""

    name: str

    def __repr__(self) -> str:  # pragma: no cover - repr cosmetics
        return self.name


DimLike = Union[int, Dim]
Shape = Tuple[DimLike, DimLike]


def dims_equal(a: DimLike, b: DimLike) -> bool:
    return a == b


def shape_mul(a: Shape, b: Shape) -> Shape:
    """Shape of a matrix product; raises on symbolic mismatch."""
    if not dims_equal(a[1], b[0]):
        raise ShapeError(f"matmul mismatch: {a} @ {b}")
    return (a[0], b[1])


class ShapeError(ValueError):
    pass


# ---------------------------------------------------------------------------
# expression nodes
# ---------------------------------------------------------------------------

_INTERN: Dict[Tuple[Any, ...], "Expr"] = {}
_COUNTER = itertools.count()


def _intern(key: Tuple[Any, ...], build) -> "Expr":
    node = _INTERN.get(key)
    if node is None:
        node = build()
        _INTERN[key] = node
    return node


class Expr:
    """Base class. Subclasses are hash-consed; use the module constructors."""

    shape: Shape
    children: Tuple["Expr", ...] = ()

    # --- operator sugar ----------------------------------------------------
    def __matmul__(self, other: "Expr") -> "Expr":
        return matmul(self, other)

    def __mul__(self, other):  # scalar * expr handled in scale()
        return scale(other, self)

    __rmul__ = __mul__

    def __add__(self, other: "Expr") -> "Expr":
        return add(self, other)

    def __sub__(self, other: "Expr") -> "Expr":
        return sub(self, other)

    def __neg__(self) -> "Expr":
        return scale(-1.0, self)

    @property
    def T(self) -> "Expr":
        return transpose(self)

    def inv(self) -> "Expr":
        return inverse(self)

    # --- utilities ---------------------------------------------------------
    def free_vars(self) -> frozenset:
        out = set()
        stack = [self]
        seen = set()
        while stack:
            e = stack.pop()
            if id(e) in seen:
                continue
            seen.add(id(e))
            if isinstance(e, Var):
                out.add(e.name)
            stack.extend(e.children)
        return frozenset(out)

    def contains(self, name: str) -> bool:
        return name in self.free_vars()

    def is_zero(self) -> bool:
        return isinstance(self, Zero)

    def size_nodes(self) -> int:
        seen = set()
        stack = [self]
        while stack:
            e = stack.pop()
            if id(e) in seen:
                continue
            seen.add(id(e))
            stack.extend(e.children)
        return len(seen)


@dataclass(frozen=True, eq=False)
class Var(Expr):
    """A named matrix variable (input matrix or materialized view)."""

    name: str
    shape: Shape

    def __repr__(self) -> str:
        return self.name


@dataclass(frozen=True, eq=False)
class Zero(Expr):
    """The zero matrix of a given shape (delta of an unaffected expr)."""

    shape: Shape

    def __repr__(self) -> str:
        return "0"


@dataclass(frozen=True, eq=False)
class Identity(Expr):
    """The identity matrix I_n."""

    shape: Shape

    def __repr__(self) -> str:
        return "I"


@dataclass(frozen=True, eq=False)
class Const(Expr):
    """A scalar literal, usable as a (1,1) expression or a scale factor."""

    value: float
    shape: Shape = (1, 1)

    def __repr__(self) -> str:
        return repr(self.value)


@dataclass(frozen=True, eq=False)
class MatMul(Expr):
    lhs: Expr
    rhs: Expr
    shape: Shape = field(init=False)
    children: Tuple[Expr, ...] = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "shape", shape_mul(self.lhs.shape, self.rhs.shape))
        object.__setattr__(self, "children", (self.lhs, self.rhs))

    def __repr__(self) -> str:
        return f"({self.lhs!r} {self.rhs!r})"


@dataclass(frozen=True, eq=False)
class Add(Expr):
    terms: Tuple[Expr, ...]
    shape: Shape = field(init=False)
    children: Tuple[Expr, ...] = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "shape", self.terms[0].shape)
        object.__setattr__(self, "children", tuple(self.terms))

    def __repr__(self) -> str:
        return "(" + " + ".join(map(repr, self.terms)) + ")"


@dataclass(frozen=True, eq=False)
class Scale(Expr):
    """scalar * matrix.  ``factor`` is an Expr of shape (1,1)."""

    factor: Expr
    operand: Expr
    shape: Shape = field(init=False)
    children: Tuple[Expr, ...] = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "shape", self.operand.shape)
        object.__setattr__(self, "children", (self.factor, self.operand))

    def __repr__(self) -> str:
        return f"({self.factor!r} * {self.operand!r})"


@dataclass(frozen=True, eq=False)
class Transpose(Expr):
    operand: Expr
    shape: Shape = field(init=False)
    children: Tuple[Expr, ...] = field(init=False)

    def __post_init__(self):
        s = self.operand.shape
        object.__setattr__(self, "shape", (s[1], s[0]))
        object.__setattr__(self, "children", (self.operand,))

    def __repr__(self) -> str:
        return f"{self.operand!r}^T"


@dataclass(frozen=True, eq=False)
class Inverse(Expr):
    operand: Expr
    shape: Shape = field(init=False)
    children: Tuple[Expr, ...] = field(init=False)

    def __post_init__(self):
        s = self.operand.shape
        if not dims_equal(s[0], s[1]):
            raise ShapeError(f"inverse of non-square {s}")
        object.__setattr__(self, "shape", s)
        object.__setattr__(self, "children", (self.operand,))

    def __repr__(self) -> str:
        return f"{self.operand!r}^-1"


# ---------------------------------------------------------------------------
# smart constructors (perform local simplification + hash-consing)
# ---------------------------------------------------------------------------


def var(name: str, shape: Shape) -> Var:
    return _intern(("var", name, shape), lambda: Var(name, shape))


def zero(shape: Shape) -> Zero:
    return _intern(("zero", shape), lambda: Zero(shape))


def identity(n: DimLike) -> Identity:
    return _intern(("identity", n), lambda: Identity((n, n)))


def const(value: float) -> Const:
    return _intern(("const", float(value)), lambda: Const(float(value)))


def matmul(a: Expr, b: Expr) -> Expr:
    if a.is_zero() or b.is_zero():
        return zero(shape_mul(a.shape, b.shape))
    if isinstance(a, Identity):
        return b
    if isinstance(b, Identity):
        return a
    if isinstance(a, Const):
        return scale(a, b)
    if isinstance(b, Const):
        return scale(b, a)
    return _intern(("matmul", id_of(a), id_of(b)), lambda: MatMul(a, b))


def add(*terms: Expr) -> Expr:
    flat = []
    for t in terms:
        if isinstance(t, Add):
            flat.extend(t.terms)
        elif not t.is_zero():
            flat.append(t)
    if not flat:
        return zero(terms[0].shape)
    for t in flat[1:]:
        if t.shape != flat[0].shape:
            raise ShapeError(f"add mismatch: {[x.shape for x in flat]}")
    if len(flat) == 1:
        return flat[0]
    return _intern(("add", tuple(id_of(t) for t in flat)), lambda: Add(tuple(flat)))


def sub(a: Expr, b: Expr) -> Expr:
    return add(a, scale(-1.0, b))


def scale(factor, operand: Expr) -> Expr:
    if not isinstance(factor, Expr):
        factor = const(factor)
    if isinstance(factor, Const):
        if factor.value == 0.0:
            return zero(operand.shape)
        if factor.value == 1.0:
            return operand
        if isinstance(operand, Scale) and isinstance(operand.factor, Const):
            return scale(factor.value * operand.factor.value, operand.operand)
    if operand.is_zero():
        return operand
    return _intern(("scale", id_of(factor), id_of(operand)), lambda: Scale(factor, operand))


def transpose(e: Expr) -> Expr:
    if e.is_zero():
        return zero((e.shape[1], e.shape[0]))
    if isinstance(e, Identity):
        return e
    if isinstance(e, Transpose):
        return e.operand
    if isinstance(e, MatMul):  # (AB)^T = B^T A^T
        return matmul(transpose(e.rhs), transpose(e.lhs))
    if isinstance(e, Add):
        return add(*[transpose(t) for t in e.terms])
    if isinstance(e, Scale):
        return scale(e.factor, transpose(e.operand))
    return _intern(("transpose", id_of(e)), lambda: Transpose(e))


def inverse(e: Expr) -> Expr:
    if isinstance(e, Identity):
        return e
    if isinstance(e, Inverse):
        return e.operand
    return _intern(("inverse", id_of(e)), lambda: Inverse(e))


def id_of(e: Expr) -> int:
    """Identity key used for hash-consing (nodes are interned ⇒ id is stable)."""
    return id(e)


# ---------------------------------------------------------------------------
# substitution & traversal
# ---------------------------------------------------------------------------


def substitute(e: Expr, env: Dict[str, Expr]) -> Expr:
    """Replace Var nodes by expressions from ``env`` (capture-free)."""
    cache: Dict[int, Expr] = {}

    def go(x: Expr) -> Expr:
        hit = cache.get(id(x))
        if hit is not None:
            return hit
        if isinstance(x, Var):
            out = env.get(x.name, x)
        elif isinstance(x, MatMul):
            out = matmul(go(x.lhs), go(x.rhs))
        elif isinstance(x, Add):
            out = add(*[go(t) for t in x.terms])
        elif isinstance(x, Scale):
            out = scale(go(x.factor), go(x.operand))
        elif isinstance(x, Transpose):
            out = transpose(go(x.operand))
        elif isinstance(x, Inverse):
            out = inverse(go(x.operand))
        else:
            out = x
        cache[id(x)] = out
        return out

    return go(e)


def postorder(e: Expr) -> Iterable[Expr]:
    seen = set()
    out = []

    def go(x: Expr):
        if id(x) in seen:
            return
        seen.add(id(x))
        for c in x.children:
            go(c)
        out.append(x)

    go(e)
    return out


def monomials(e: Expr) -> Tuple[Expr, ...]:
    """Flatten an Add tree into its summand monomials."""
    if isinstance(e, Add):
        out = []
        for t in e.terms:
            out.extend(monomials(t))
        return tuple(out)
    if e.is_zero():
        return ()
    return (e,)


def concrete_shape(e: Expr, binding: Dict[str, int]) -> Tuple[int, int]:
    """Resolve symbolic dims against a {dim-name: int} binding."""

    def res(d: DimLike) -> int:
        if isinstance(d, Dim):
            return binding[d.name]
        return int(d)

    return (res(e.shape[0]), res(e.shape[1]))
