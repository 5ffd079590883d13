"""Device milliseconds a step or a frame in cuBLAS's and CUTLASS's products (in JAX's default
mode the plain SDF block's), kernels matched after the port's exact names."""


def read(rec):
    s = rec.group_s("cublas")
    return s / rec.units * 1e3 if s > 0 else None
