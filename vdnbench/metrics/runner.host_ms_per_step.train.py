"""Host milliseconds a step in the runner's loop body: the image permutation
and pixel sampling (span ``runner.sample``), over the untraced window."""


def read(rec):
    if not rec.timed_units or "runner.sample" not in rec.host_s:
        return None
    return rec.host_s["runner.sample"] / rec.timed_units * 1e3
