"""rds_host_ms: host ms a read the RDS decoders of all stations spend on
the host after their baseband comes back (``RdsStreamDecoder.bits``: the
baseband join, lock, integrate-and-dump, differential decode;
``RdsStreamDecoder.groups``: group sync and text), from the program's span
totals over the untraced reads."""

from sdrbench import program


def read(rec):
    return program.span_ms("RdsStreamDecoder.bits", "RdsStreamDecoder.groups")
