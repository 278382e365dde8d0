"""Serving: the batched decode engine and incremental logit views."""

from .engine import ServeEngine, make_prefill_step, make_serve_step
from .incremental_views import IncrementalLogitView, build_logit_view_program

__all__ = ["ServeEngine", "IncrementalLogitView", "build_logit_view_program",
           "make_prefill_step", "make_serve_step"]
