"""Device milliseconds a step or a frame in no layer's span or piece (the
dispatch's copies, the frame's copies to the host, work outside every span):
the guard that the layers cover the unit's busy time
(``vdnbench/marks.py``); None without marks."""

from vdnbench import marks


def read(rec):
    m = marks.of(rec)
    return None if m is None else marks.per_unit_ms(m.unmarked_s(), rec)
