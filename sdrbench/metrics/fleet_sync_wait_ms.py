"""fleet_sync_wait_ms: host ms a read of the station batch is blocked on
the device after its graph replay (``FusedWbfmBatchStreamer.sync``: the
D2H enqueue and the synchronize), from the program's span totals over the
untraced reads."""

from sdrbench import fleet_program


def read(rec):
    return fleet_program.span_ms("FusedWbfmBatchStreamer.sync")
