"""Host seconds in the program's ``setup.optimizer`` span: every Adam's
construction in set-up (``vdnbench/marks.py``); None without it."""

from vdnbench import marks


def read(rec):
    trace = marks.program_trace()
    host = trace.host() if trace is not None else {}
    return host["setup.optimizer"][1] if "setup.optimizer" in host else None
