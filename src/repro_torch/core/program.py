"""Linear-algebra programs (paper §3).

A :class:`Program` is an ordered list of statements ``target := expr`` over
input matrices and previously-defined views, with symbolic dimensions bound
to concrete sizes at compile/run time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import expr as ex
from .expr import Dim, Expr, Shape, Var


@dataclass(frozen=True)
class Statement:
    target: Var
    expr: Expr

    def __repr__(self) -> str:
        return f"{self.target.name} := {self.expr!r}"


@dataclass
class Program:
    """A sequence of statements over declared inputs.

    ``outputs`` names the result views (default: last statement's target).
    """

    name: str = "program"
    inputs: Dict[str, Var] = field(default_factory=dict)
    statements: List[Statement] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    dims: Dict[str, int] = field(default_factory=dict)

    # -- construction -------------------------------------------------------
    def input(self, name: str, shape: Shape) -> Var:
        if name in self.inputs:
            raise ValueError(f"duplicate input {name}")
        v = ex.var(name, shape)
        self.inputs[name] = v
        return v

    def let(self, name: str, e: Expr) -> Var:
        if name in self.inputs or any(s.target.name == name for s in self.statements):
            raise ValueError(f"duplicate definition {name}")
        v = ex.var(name, e.shape)
        self.statements.append(Statement(v, e))
        return v

    def bind_dims(self, **dims: int) -> "Program":
        self.dims.update(dims)
        return self

    # -- queries -------------------------------------------------------------
    def view_names(self) -> List[str]:
        return [s.target.name for s in self.statements]

    def statement_for(self, name: str) -> Statement:
        for s in self.statements:
            if s.target.name == name:
                return s
        raise KeyError(name)

    def output_names(self) -> List[str]:
        if self.outputs:
            return list(self.outputs)
        return [self.statements[-1].target.name]

    def __repr__(self) -> str:
        lines = [f"program {self.name}:"]
        lines += [f"  in  {v.name}: {v.shape}" for v in self.inputs.values()]
        lines += [f"  {s!r}" for s in self.statements]
        return "\n".join(lines)


def dim(name: str) -> Dim:
    return Dim(name)
