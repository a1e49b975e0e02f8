"""sync_wait_ms: host ms a read is blocked on the device after the
streamer's graph replay (``WidebandStreamer.sync``: the D2H enqueue and the
synchronize), from the program's span totals over the untraced reads."""

from sdrbench import program


def read(rec):
    return program.span_ms("WidebandStreamer.sync")
