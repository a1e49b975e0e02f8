"""fleet_stage_ms: host ms a read of the station batch spends staging its
graphed step (``FusedWbfmBatchStreamer.stage``: the key and its lookup,
the wait on the staging buffer's fence, the copy of the (dongles, bytes)
block into the pinned staging buffer, the non-blocking H2D enqueue), from
the program's span totals over the untraced reads."""

from sdrbench import fleet_program


def read(rec):
    return fleet_program.span_ms("FusedWbfmBatchStreamer.stage")
