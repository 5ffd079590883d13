"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: K1 ``sdf_fwd``, K2 ``render_fwd`` and K4 ``nerf_fwd``."""
