"""Device milliseconds a step: the union of the device operations' intervals
in the traced sub-window, over its steps."""


def read(rec):
    busy = rec.busy_s()
    return busy / rec.units * 1e3 if busy > 0 else None
