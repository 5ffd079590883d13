"""Developer observability: NaN guards and profiler hooks.

Counterpart of ``vdnerf_tpu/utils/debug.py``, under the same variables:

- ``VDNERF_DEBUG_NANS=1`` (read once by the entry points,
  :func:`nans_requested`): :func:`nan_debugging` turns on autograd's anomaly
  detection with its NaN check, so a backward that makes a NaN raises where
  it happened (JAX's ``debug_nans``). A CUDA graph cannot be checked, so
  training steps then run eagerly on the card (``train/dispatch.py``); the
  kernels still run.
- :func:`check_finite`: an on-device guard, a bool tensor to read when the
  host needs it.
- ``VDNERF_PROFILE_DIR=<dir>``: :func:`profile_trace` traces a block into a
  Chrome trace there; the runner so traces training steps 10-15 (rank 0).
  Open the file in ``chrome://tracing`` or Perfetto. While it records, the
  program's spans are host ranges and device marks in it (``utils/trace.py``),
  and training steps replay their marked twins.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

log = logging.getLogger(__name__)

NANS_ENV = "VDNERF_DEBUG_NANS"
PROFILE_ENV = "VDNERF_PROFILE_DIR"


def nans_requested() -> bool:
    return os.environ.get(NANS_ENV, "") in ("1", "true")


@contextlib.contextmanager
def nan_debugging(enable: bool = True):
    """Anomaly detection with the NaN check for the length of the block
    (nothing with ``enable`` false); the previous mode comes back on exit."""
    if not enable:
        yield
        return
    log.warning("%s: autograd anomaly detection on; training steps run eagerly, not as "
                "CUDA-graph replays", NANS_ENV)
    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        yield


def nan_debugging_enabled() -> bool:
    return torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()


def check_finite(tensors) -> torch.Tensor:
    """True where every element of ``tensors`` (a tensor, a dict or an
    iterable of tensors) is finite: a bool tensor on their device, computed
    without a host round trip."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    elif isinstance(tensors, dict):
        tensors = list(tensors.values())
    flags = [torch.isfinite(t).all() for t in tensors]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None, name: str = "trace.json"):
    """Profile the block, host and (with CUDA) device, into the Chrome trace
    ``<log_dir>/<name>`` (``log_dir`` defaults to ``VDNERF_PROFILE_DIR``;
    neither set: no profiling). Yields the profiler, or None. The trace is
    written on exit, after the card has finished."""
    log_dir = log_dir or os.environ.get(PROFILE_ENV)
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, name)
        prof.export_chrome_trace(path)
        log.info("profiler trace %s", path)
