"""host_copy_bytes_per_sample: bytes the program copies on the host a
complex sample of the capture (the program's ``host_copy_bytes`` counter:
each join, each copy into a staging buffer, each output unpacked; the s16
conversion is the client's and not counted), over the untraced reads."""

from sdrbench import program


def read(rec):
    n = program.counter_per_read("host_copy_bytes")
    return None if n is None else n / (int(rec.cell.traffic["read_bytes"]) / 2)
