"""The port stands alone: importing ``repro_torch`` and every submodule
loads neither JAX nor the reference package, and the entry points default
to the card instead of quietly running on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15          # every submodule was imported
    assert bad == "[]", bad


def test_default_device_is_the_card():
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    from repro_torch.launch.vision import main
    from repro_torch.vision import VisionEngine, build_vision_model
    with pytest.raises((AssertionError, RuntimeError)):
        VisionEngine(build_vision_model("VGGNet", num_layers=1))
    with pytest.raises((AssertionError, RuntimeError)):
        main(["--smoke"])
