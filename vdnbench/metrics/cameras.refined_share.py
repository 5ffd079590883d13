"""Replays of step programs that refine the learned cameras (``.refine``
programs) over all replays, from the program's counters
``dispatch.replays.<program>`` over the whole run (``vdnbench/marks.py``);
None without replays."""

from vdnbench import marks

PREFIX = "dispatch.replays."


def read(rec):
    trace = marks.program_trace()
    counts = trace.counts() if trace is not None else {}
    replays = {k[len(PREFIX):]: n for k, n in counts.items() if k.startswith(PREFIX)}
    total = sum(replays.values())
    if not total:
        return None
    return sum(n for program, n in replays.items() if program.endswith(".refine")) / total
