"""stage_ms: host ms a read spends staging the streamer's graphed step
(``WidebandStreamer.stage``: the wait on the staging buffer's fence, the
copy of the read into the pinned staging buffer, the non-blocking H2D
enqueue), from the program's span totals over the untraced reads."""

from sdrbench import program


def read(rec):
    return program.span_ms("WidebandStreamer.stage")
