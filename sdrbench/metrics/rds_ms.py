"""rds_ms: host ms a traced read spends in the per-station RDS decoders
(the harness's ``rds`` span): each decoder's baseband replay, its D2H and
the group layer on the host."""


def read(rec):
    s = rec.span_mean_s("rds")
    return None if s is None else s * 1e3
