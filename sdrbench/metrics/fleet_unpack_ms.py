"""fleet_unpack_ms: host ms a read of the station batch spends copying
its audio out of the pinned buffer (``FusedWbfmBatchStreamer.unpack``),
from the program's span totals over the untraced reads."""

from sdrbench import fleet_program


def read(rec):
    return fleet_program.span_ms("FusedWbfmBatchStreamer.unpack")
