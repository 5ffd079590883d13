"""Device milliseconds a step or a frame in the SDF block: ``render.sdf`` and
the backward's ``bwd.sdf`` piece, from the program's device marks
(``vdnbench/marks.py``); None without marks."""

from vdnbench import marks


def read(rec):
    m = marks.of(rec)
    return None if m is None else marks.per_unit_ms(m.layer_s("sdf"), rec)
