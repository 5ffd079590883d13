"""Host milliseconds a step inside ``StepDispatch.run`` (span ``dispatch.run``:
the window's upload and one replay launch a step), over the untraced window."""


def read(rec):
    if not rec.timed_units or "dispatch.run" not in rec.host_s:
        return None
    return rec.host_s["dispatch.run"] / rec.timed_units * 1e3
