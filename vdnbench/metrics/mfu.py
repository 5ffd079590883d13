"""The whole step's or frame's share of the card's peak: its model operations
(the ladder forward, the SDF block, the heads and the NeRF, with their
backwards in training) at 495 TFLOP/s."""

from vdnbench import work


def read(rec):
    """model operations of a step or frame over its time in the untraced
    window, over the peak, in %."""
    if not rec.timed_units:
        return None
    per = rec.timed_s / rec.timed_units
    return 100.0 * rec.work["model_flops"] / per / work.PEAK_FLOPS
