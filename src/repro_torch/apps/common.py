"""Shared app scaffolding: every app exposes the same engine pair
(incremental / re-evaluation) so drivers and tests treat them uniformly."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..core import IncrementalEngine, Program, ReevalEngine

Tensor = torch.Tensor


@dataclass
class AppEngines:
    program: Program
    incremental: IncrementalEngine
    reeval: ReevalEngine

    def initialize(self, inputs: Dict[str, object]):
        self.incremental.initialize(inputs)
        self.reeval.initialize(inputs)

    def update_both(self, input_name: str, u, v):
        self.incremental.apply_update(input_name, u, v)
        self.reeval.apply_update(input_name, u, v)

    def divergence(self, name: Optional[str] = None) -> float:
        name = name or self.program.output_names()[0]
        a = self.incremental.views[name]
        b = self.reeval.views[name]
        scale = float(b.abs().max()) or 1.0
        return float((a - b).abs().max()) / scale


class App:
    """Base: subclasses set ``self.program`` and ``self.update_input``.

    Both engines live on ``device`` (``None`` means the card); the other
    keywords (``plan``, ``flush_policy``, ``trigger_cache``, ...) go to
    the :class:`IncrementalEngine`."""

    program: Program
    update_input: str

    def __init__(self, program: Program, update_input: str, rank: int = 1,
                 force_rep: Optional[str] = None, sequential_sm: bool = False,
                 device=None, **engine_kw):
        self.program = program
        self.update_input = update_input
        self.rank = rank
        self.engine = IncrementalEngine(
            program, {update_input: rank}, force_rep=force_rep,
            sequential_sm=sequential_sm, device=device, **engine_kw)
        self.device = self.engine.device
        self.reeval = ReevalEngine(program, device=self.device)

    def initialize(self, inputs: Dict[str, object]):
        self.engine.initialize(inputs)
        self.reeval.initialize(inputs)
        return self

    def update(self, u, v) -> Tensor:
        self.engine.apply_update(self.update_input, u, v)
        return self.engine.output()

    def update_reeval(self, u, v) -> Tensor:
        self.reeval.apply_update(self.update_input, u, v)
        return self.reeval.output()

    def output(self) -> Tensor:
        return self.engine.output()

    def speedup_estimate(self) -> float:
        """Analytic FLOP ratio reeval/incremental for one update."""
        return (self.engine.reeval_flops() /
                max(self.engine.trigger_flops(self.update_input), 1.0))


# ---------------------------------------------------------------------------
# app discovery
# ---------------------------------------------------------------------------

_APP_REGISTRY: Dict[str, type] = {}


def register_app(name: str, factory: Optional[type] = None):
    """Register an app factory under ``name`` so drivers enumerate it.

    Usable as a decorator (``@register_app("ols")``) or a direct call
    (``register_app("ols", OLS)``).
    """
    def _register(f):
        _APP_REGISTRY[name] = f
        return f
    if factory is not None:
        return _register(factory)
    return _register


def get_app(name: str) -> type:
    """The registered factory for ``name`` (KeyError lists what's
    available)."""
    try:
        return _APP_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown app {name!r}; available: "
                       f"{available_apps()}") from None


def available_apps() -> list:
    return sorted(_APP_REGISTRY)
