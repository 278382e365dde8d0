"""Training utilities of the port.  So far only the low-rank gradient
compression step that the learning views (:mod:`repro_torch.fivm`) use
to push model coefficients as factored deltas; the training loop itself
is ROADMAP.md Queue 1 item 13."""

from .grad_compression import compress_leaf

__all__ = ["compress_leaf"]
