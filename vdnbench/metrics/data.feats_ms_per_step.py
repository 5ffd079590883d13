"""Host milliseconds a step in the program's ``data.gather_feats`` span (the
depth features' gather of ``RayStore.sample_pixels``), over the count of its
``data.sample`` spans, both from the program's registry over the whole run,
set-up and warm-up included (``vdnbench/marks.py``); None without them."""

from vdnbench import marks


def read(rec):
    trace = marks.program_trace()
    host = trace.host() if trace is not None else {}
    if "data.gather_feats" not in host or not host.get("data.sample", (0,))[0]:
        return None
    return host["data.gather_feats"][1] / host["data.sample"][0] * 1e3
