"""On the card: one short run of each cell through the benchmark's command
comes out correct, its last line to the contract. Skips without CUDA.

    python -m pytest --noconftest -p no:cacheprovider -m cuda vdnbench/tests
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from vdnbench.tests.small import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["womsk.train_rs96", "wdepth.train_rs96", "womsk.views_l4"])
def test_short_run_is_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "vdnbench", "run.py"), "--workload", workload,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, out.stderr[-2000:]
    assert last["device"]["platform"] == "gpu" and last["device"]["count"] == 1
    assert list(last)[-1] == "checks"
