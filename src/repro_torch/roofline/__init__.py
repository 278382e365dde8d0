"""Roofline analysis of one walked step (:mod:`.op_walk`) against the
card's data sheet (:mod:`.hw`)."""

from .hw import H100_SXM
from .analysis import RooflineReport, analyze_step

__all__ = ["H100_SXM", "RooflineReport", "analyze_step"]
