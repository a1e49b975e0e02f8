"""host_calls_per_read: CUDA runtime calls (launches, graph launches,
memcpys, synchronizes, event calls) the host makes a traced read, from
the whole trace."""


def read(rec):
    if not rec.reads or rec.busy_s is None:
        return None
    return sum(rec.host_calls.values()) / rec.reads
