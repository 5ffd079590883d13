"""The benchmark of vdnerf_tpu_torch: one run of one cell.

    python3 vdnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Sets the cell up from the seed (scene, features and weights made here,
the kernels built into the checkout on its first run), warms up the cell's
own programs, measures for ``--seconds``, and with ``--trace 1`` profiles a
fixed sub-window after that. Then it frees the program, checks what the
timed path produced against the plain reference under ``vdnbench/reference``
and prints the numbers compared, each beside its limit, as the last lines
of standard error, and the result as the last line of standard output: the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics.

Exits with another code than 0, printing no result, without CUDA or with
fewer cards than the cell asks for, and if ``jax``, ``jaxlib``, ``flax`` or
the JAX package is loaded by then.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "vdnerf_tpu")
# host threads of torch's CPU operations: the load of one process with few
# threads, so that runs on a shared host spread less
THREADS = 2


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    the program's precision switches at the configuration's (unset)."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    for key in ("VDNERF_FUSED", "VDNERF_BF16", "VDNERF_DEBUG_NANS", "VDNERF_PROFILE_DIR"):
        os.environ.pop(key, None)


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that are JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env(ROOT)
    sys.path.insert(0, ROOT)

    import torch

    from vdnbench import harness

    torch.set_num_threads(THREADS)

    cell = harness.cell(ROOT, args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="vdnbench_") as workdir:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                               "cuda:0", workdir, T_START)
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    emit(out)
    return 0


def emit(out: dict, stdout=None, stderr=None) -> None:
    """The run's ``info`` on an earlier line, each compared number beside its
    limit as the last lines of standard error, and the result (``checks``
    its last key) as the last line of standard output."""
    stdout, stderr = stdout or sys.stdout, stderr or sys.stderr
    out = dict(out)
    print("info " + json.dumps(out.pop("info", {})), file=stdout, flush=True)
    checks = out.pop("checks")
    print(f"correct {out['correct']}", file=stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} = {value!r} limit {limit!r}", file=stderr)
    stderr.flush()
    print(json.dumps({**out, "checks": checks}), file=stdout, flush=True)


if __name__ == "__main__":
    sys.exit(main())
