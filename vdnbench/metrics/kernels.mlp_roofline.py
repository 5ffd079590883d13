"""The MLP kernels' share of their roofline, a step or a frame: the colour
head, the depth head and the background NeRF, forward and (in training)
backward, at the rows they run, over the device time of K2-K5, the dW
contraction and the split kernels."""

from vdnbench import work


def read(rec):
    """bound time of the heads' and NeRF's work / its kernels' device time, in %."""
    s = rec.group_s("mlp")
    if s <= 0:
        return None
    t, _ = work.bound(rec.work["mlp"]["flops"], rec.work["mlp"]["bytes"])
    return 100.0 * t * rec.units / s
