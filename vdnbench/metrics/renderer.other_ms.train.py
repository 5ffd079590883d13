"""Device milliseconds a step in kernels that are neither the port's nor
cuBLAS's: elementwise work, the composites, the loss, Adam."""


def read(rec):
    s = rec.group_s("other")
    return s / rec.units * 1e3 if s > 0 else None
