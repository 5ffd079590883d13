"""Device milliseconds a step in the learned cameras: the program's
``render.cameras`` span (the learned c2w and K^-1) and the backward's
``bwd.cameras`` piece (the rays' cotangents into r, t and fx), from its
device marks (``vdnbench/marks.py``); None where neither is marked."""

from vdnbench import marks

LABELS = ("render.cameras", "bwd.cameras")


def read(rec):
    m = marks.of(rec)
    if m is None or not any(label in m.busy for label in LABELS):
        return None
    return marks.per_unit_ms(sum(m.busy.get(label, 0.0) for label in LABELS), rec)
