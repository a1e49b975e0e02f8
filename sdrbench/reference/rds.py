"""RDS against the truth: the groups the generator put into each station.

The ring repeats a station's ``G`` groups, each distinct, so a decoded
group names its place in the ring, and consecutive decoded groups name the
groups between them that were missed.  Group ``a`` of the stream (counting
from the first sample of the capture) is whole once its 104 bits are in
the multiplex fed to the decoder.
"""

from __future__ import annotations

GROUP_BITS = 104
# groups a sound decoder may leave out at each end: before it locks (the
# pilot, 104 bits of baseband, then a whole valid group to sync on), and
# the last ones still in its filters and its group buffer
LOCK_GROUPS, TAIL_GROUPS = 3, 2


def compare(sent: list, decoded: list, bits_fed: float) -> dict:
    """``sent[s]``: station s's groups of one ring; ``decoded[s]``: the
    groups its decoder gave, in order; ``bits_fed``: RDS bit times of
    multiplex fed to each decoder.  Returns the wrong groups (not sent,
    or out of their order), the missed ones and those expected."""
    wrong = missed = expected = 0
    whole = int(bits_fed // GROUP_BITS)
    for ring, got in zip(sent, decoded):
        place = {g: i for i, g in enumerate(ring)}
        exp = max(0, whole - LOCK_GROUPS - TAIL_GROUPS)
        expected += exp
        first = last = None
        seen = 0
        for g in got:
            i = place.get(g)
            if i is None:
                wrong += 1
                continue
            if last is None:
                first = last = i
            else:
                step = (i - last) % len(ring)
                if step == 0:        # the same group twice
                    wrong += 1
                    continue
                last += step
            seen += 1
        if last is None:
            missed += exp
            continue
        between = last - first + 1 - seen
        early = max(0, first - LOCK_GROUPS)
        late = max(0, whole - TAIL_GROUPS - 1 - last)
        missed += between + early + late
    return {"wrong": wrong, "missed": missed, "expected": expected}
