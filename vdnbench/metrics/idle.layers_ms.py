"""Idle device milliseconds a step or a frame while a layer's span or backward
piece is the innermost open one: in eager serving launch-bound host code,
inside a replay the graph's bubbles, from the program's device marks
(``vdnbench/marks.py``); None without marks."""

from vdnbench import marks


def read(rec):
    m = marks.of(rec)
    return None if m is None else marks.per_unit_ms(m.idle_s("layers"), rec)
