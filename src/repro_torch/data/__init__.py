"""Update-stream generators used to drive the engines."""

from .updates import UpdateStream

__all__ = ["UpdateStream"]
