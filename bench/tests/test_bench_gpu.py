"""On the card: one short run of the first cell through the command the
driver runs, and the contract of its last line."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
def test_first_cell_runs_and_is_correct(cuda_device):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "vgg16.offline_b32",
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"img_per_s", "setup_s"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
