"""Device milliseconds a step or a frame in the composite:
``render.composite``, ``step.loss``, ``serve.outputs`` and the backward's
first piece (the loss's and the composite's), from the program's device
marks (``vdnbench/marks.py``); None without marks."""

from vdnbench import marks


def read(rec):
    m = marks.of(rec)
    return None if m is None else marks.per_unit_ms(m.layer_s("composite"), rec)
