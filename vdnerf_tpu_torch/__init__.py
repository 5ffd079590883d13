"""PyTorch/CUDA port of vdnerf_tpu for NVIDIA Hopper (H100).

Layout mirrors ``vdnerf_tpu``: ``models/`` (fields), ``ops/`` (sampling,
renderer, hand-written CUDA kernels under ``ops/kernels``), ``data/``,
``train/``, ``io/``, ``runner.py`` and ``cli.py``. The package imports
torch, numpy and cv2 only; entry points run on ``cuda:<gpu>`` unless the
caller passes ``device="cpu"``.
"""
