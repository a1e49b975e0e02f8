"""unpack_ms: host ms a read spends copying the streamer's outputs out of
the pinned buffer (``WidebandStreamer.unpack``: the audio, and with RDS the
multiplex), from the program's span totals over the untraced reads."""

from sdrbench import program


def read(rec):
    return program.span_ms("WidebandStreamer.unpack")
