"""What the benchmark loads: nothing of JAX or the JAX package in the
process that runs a cell, with every program module, nothing of the
program in any reference module, and nothing under ``bench/`` reads the
JAX package's ``benchmarks/``."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN_PROBE = r"""
import sys
sys.path[:0] = [{src!r}, {root!r}]
import importlib.util
from pathlib import Path
import bench.run, bench.control
for p in sorted(Path({root!r}, "bench", "metrics").glob("*.py")):
    spec = importlib.util.spec_from_file_location("m", p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for p in sorted(Path({root!r}, "bench", "programs").glob("*.py")):
    importlib.import_module("bench.programs." + p.stem)
# what a run drives of the port
import repro_torch.vision.engine
import repro_torch.sparsity.conv, repro_torch.analysis
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REF_PROBE = r"""
import sys
sys.path[:0] = [{src!r}, {root!r}]
import importlib
from pathlib import Path
for p in sorted(Path({root!r}, "bench", "reference").glob("*.py")):
    importlib.import_module("bench.reference." + p.stem)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def top_level(probe):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", probe.format(src=str(ROOT / "src"),
                                            root=str(ROOT))],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    names = top_level(RUN_PROBE)
    assert "repro_torch" in names and "bench" in names
    for bad in ("jax", "jaxlib", "flax", "repro"):
        assert bad not in names


def test_the_reference_loads_nothing_of_the_program():
    names = top_level(REF_PROBE)
    assert "torch" in names
    assert "repro_torch" not in names and "repro" not in names


def test_nothing_under_bench_reads_benchmarks():
    for p in (ROOT / "bench").rglob("*.py"):
        if p.name == Path(__file__).name:
            continue
        text = p.read_text()
        assert "benchmarks" not in text, p
