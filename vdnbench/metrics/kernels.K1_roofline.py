"""K1's share of its roofline, a step or a frame: the ladder's SDF queries' bound time
(operations over 495 TFLOP/s or bytes over 3.35 TB/s) over ``sdf_fwd_kernel``'s
device time."""

from vdnbench import work


def read(rec):
    """bound time of the ladder's work / its kernels' device time, in %."""
    s = rec.group_s("K1")
    if s <= 0:
        return None
    t, _ = work.bound(rec.work["K1"]["flops"], rec.work["K1"]["bytes"])
    return 100.0 * t * rec.units / s
