"""Host syncs a frame: the program's counter ``serve.host_syncs`` (one a copy
to the host or a read of a device value) over ``serve.frames``, over the
whole run (``vdnbench/marks.py``); None without them."""

from vdnbench import marks


def read(rec):
    trace = marks.program_trace()
    counts = trace.counts() if trace is not None else {}
    if not counts.get("serve.frames"):
        return None
    return counts.get("serve.host_syncs", 0) / counts["serve.frames"]
