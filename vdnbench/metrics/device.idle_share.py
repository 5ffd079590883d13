"""The device's idle share of the traced sub-window: one minus the union of
the device operations' intervals over the sub-window's host time."""


def read(rec):
    """1 - busy / window, in %."""
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s) if rec.window_s > 0 else None
