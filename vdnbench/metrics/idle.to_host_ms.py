"""Idle device milliseconds a step or a frame while the innermost open span is
``serve.to_host`` (the chunk's copies and reads on the host), from the
program's device marks (``vdnbench/marks.py``); None without marks."""

from vdnbench import marks


def read(rec):
    m = marks.of(rec)
    return None if m is None else marks.per_unit_ms(m.idle_s("to_host"), rec)
