"""demod_ms: host ms a traced read spends in the streamer's
``demodulate`` (the harness's ``demod`` span): the residual join, the
staging copy, one graph replay, the D2H copy and its wait."""


def read(rec):
    s = rec.span_mean_s("demod")
    return None if s is None else s * 1e3
