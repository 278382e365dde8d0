"""Update-stream generators used to drive the engines, and the synthetic
model batches of :mod:`.pipeline`."""

from .pipeline import (TokenPipeline, make_batch_specs, synth_batch,
                       synth_tokens)
from .updates import (LabeledStream, LabeledUpdate, RowLocalStream,
                      UpdateStream, labeled_stream, row_local_stream,
                      zipf_row_stream)

__all__ = ["LabeledStream", "LabeledUpdate", "RowLocalStream",
           "TokenPipeline", "UpdateStream", "labeled_stream", "make_batch_specs",
           "row_local_stream",
           "synth_batch", "synth_tokens", "zipf_row_stream"]
