"""Idle device milliseconds a step or a frame while the innermost open span of
the program is ``data.*`` (the host draws and gathers a batch), from the
program's device marks (``vdnbench/marks.py``); None without marks."""

from vdnbench import marks


def read(rec):
    m = marks.of(rec)
    return None if m is None else marks.per_unit_ms(m.idle_s("data"), rec)
