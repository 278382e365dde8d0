"""Update-stream generators used to drive the engines."""

from .updates import (LabeledStream, LabeledUpdate, RowLocalStream,
                      UpdateStream, labeled_stream, row_local_stream,
                      zipf_row_stream)

__all__ = ["LabeledStream", "LabeledUpdate", "RowLocalStream",
           "UpdateStream", "labeled_stream", "row_local_stream",
           "zipf_row_stream"]
