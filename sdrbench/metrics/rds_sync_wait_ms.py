"""rds_sync_wait_ms: host ms a read the RDS decoders of all stations are
blocked on the device after their baseband replays (``RdsReceiver.sync``:
the D2H enqueue and the synchronize), from the program's span totals over
the untraced reads."""

from sdrbench import program


def read(rec):
    return program.span_ms("RdsReceiver.sync")
