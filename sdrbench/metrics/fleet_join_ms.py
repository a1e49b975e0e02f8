"""fleet_join_ms: host ms a read of the station batch spends in its
residual's join (``FusedWbfmBatchStreamer.join``: the ``np.concatenate`` of
each row's residual and read, and the copy of the rows' whole chunks into
one block), from the program's span totals over the untraced reads."""

from sdrbench import fleet_program


def read(rec):
    return fleet_program.span_ms("FusedWbfmBatchStreamer.join")
