"""Update-stream generators used to drive the engines."""

from .updates import (RowLocalStream, UpdateStream, row_local_stream,
                      zipf_row_stream)

__all__ = ["RowLocalStream", "UpdateStream", "row_local_stream",
           "zipf_row_stream"]
