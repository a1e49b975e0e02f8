"""join_ms: host ms a read spends in the streamer's residual join
(``WidebandStreamer.join``: the ``np.concatenate`` of the residual and the
read), from the program's span totals over the untraced reads."""

from sdrbench import program


def read(rec):
    return program.span_ms("WidebandStreamer.join")
