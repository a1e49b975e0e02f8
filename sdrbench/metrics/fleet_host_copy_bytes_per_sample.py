"""fleet_host_copy_bytes_per_sample: bytes the program copies on the host
a complex sample of the fleet's reads (the program's ``host_copy_bytes``
counter: the join, the staging copy, the audio unpacked; the s16
conversion is the client's and not counted), a read being one
``FusedWbfmBatchStreamer.demodulate``, over the untraced reads."""

from sdrbench import fleet_program


def read(rec):
    n = fleet_program.counter_per_read("host_copy_bytes")
    return None if n is None else n / (int(rec.cell.traffic["read_bytes"]) / 2)
