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
    assert int(count) >= 40          # every submodule was imported
    assert bad == "[]", bad


ANALYSIS_PROBE = r"""
import sys
import repro_torch.analysis
from repro_torch.analysis import lint, verify
from repro_torch.analysis.rules import torch_rules
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(bad)
"""


def test_analysis_imports_no_jax_and_no_reference():
    """The verifier and the lint keep their own copy of the reference's
    diagnostics vocabulary: importing them loads neither JAX nor
    ``repro``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", ANALYSIS_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


DRYRUN_PROBE = r"""
import sys
import torch.distributed as dist
import repro_torch.launch.dryrun
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(bad, dist.is_initialized())
"""


def test_dryrun_imports_no_jax_and_no_reference():
    """The dry run (``repro_torch.launch.dryrun``) imports neither JAX nor
    ``repro``, and importing it starts no process group (the fake world
    starts in ``main``)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", DRYRUN_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False", out.stdout


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


def test_lm_entry_points_default_to_the_card():
    """The LM params, the scheduler on them and the serving launcher need
    a card unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    from repro_torch.configs import load_smoke
    from repro_torch.launch.serve import main
    from repro_torch.models import model as M
    from repro_torch.serve import Scheduler
    cfg = load_smoke("qwen3_4b")
    with pytest.raises((AssertionError, RuntimeError)):
        Scheduler(cfg, M.init_params(cfg))
    with pytest.raises((AssertionError, RuntimeError)):
        M.init_cache(cfg, 1, 4)
    with pytest.raises((AssertionError, RuntimeError)):
        main(["--arch", "qwen3_4b", "--smoke", "--sparse", "--continuous"])


MESH_MODULES = ("repro_torch.dist", "repro_torch.dist.elastic",
                "repro_torch.dist.partitioning",
                "repro_torch.dist.collective_matmul",
                "repro_torch.dist.compression", "repro_torch.vision.mesh")


def test_mesh_modules_import_no_jax_and_no_reference():
    """The distribution substrate and the mesh-sharded vision runtime,
    imported alone in a fresh process, load neither JAX nor ``repro``."""
    probe = (f"import importlib, sys\nfor m in {MESH_MODULES!r}:\n"
             "    importlib.import_module(m)\n"
             "print(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro'))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_mesh_entry_points_default_to_the_card():
    """A mesh is NCCL on the card unless the caller names the CPU: without
    a card the default mesh raises (nothing falls back to gloo)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    probe = ("from repro_torch.vision.mesh import data_mesh\n"
             "try:\n    data_mesh(1)\nexcept (AssertionError, RuntimeError,"
             " ValueError) as e:\n    print('refused', type(e).__name__)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.startswith("refused"), out.stdout + out.stderr


TRAIN_MODULES = ("repro_torch.optim.adamw", "repro_torch.ckpt.checkpoint",
                 "repro_torch.data.pipeline", "repro_torch.train.train_step",
                 "repro_torch.train.loop", "repro_torch.sparsity.pruning",
                 "repro_torch.sparsity.instrument",
                 "repro_torch.launch.train")


def test_training_modules_import_no_jax_and_no_reference():
    """The training and pruning modules, imported alone in a fresh
    process, load neither JAX nor ``repro``."""
    probe = (f"import importlib, sys\nfor m in {TRAIN_MODULES!r}:\n"
             "    importlib.import_module(m)\n"
             "print(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro'))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_training_entry_points_default_to_the_card(tmp_path):
    """Training state, batches, restores and the training launcher need a
    card unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import ShapeConfig, load_smoke
    from repro_torch.data.pipeline import batch_for
    from repro_torch.launch.train import main
    from repro_torch.models import model as M
    from repro_torch.train.loop import TrainLoopConfig, init_state, train
    cfg = load_smoke("qwen3_4b")
    shape = ShapeConfig("t", 8, 2, "train")
    ckpt.save(str(tmp_path), 1, M.init_params(cfg, device="cpu"))
    for call in (lambda: init_state(cfg),
                 lambda: batch_for(cfg, shape, 0),
                 lambda: train(cfg, shape, TrainLoopConfig(steps=1)),
                 lambda: ckpt.restore(str(tmp_path), 1,
                                      M.abstract_params(cfg)),
                 lambda: main(["--arch", "qwen3_4b", "--smoke",
                               "--steps", "1"])):
        with pytest.raises((AssertionError, RuntimeError)):
            call()


LM_MESH_MODULES = ("repro_torch.dist.act_sharding", "repro_torch.launch.mesh",
                   "repro_torch.dist.partitioning",
                   "repro_torch.models.model",
                   "repro_torch.train.train_step")


@pytest.mark.parametrize("first", LM_MESH_MODULES)
def test_lm_mesh_modules_import_alone_no_jax(first):
    """The LM mesh modules (A8b), each imported first in a fresh process
    (``models.model`` imports ``dist.act_sharding``, which imports
    ``dist.partitioning``), load neither JAX nor ``repro``; without a card
    the default debug mesh raises (NCCL, nothing falls back to gloo)."""
    probe = (f"import importlib, sys\nimportlib.import_module({first!r})\n"
             f"for m in {LM_MESH_MODULES!r}:\n"
             "    importlib.import_module(m)\n"
             "print(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro'))\n"
             "import torch\n"
             "from repro_torch.launch.mesh import make_debug_mesh\n"
             "if not torch.cuda.is_available():\n"
             "    try:\n        make_debug_mesh()\n"
             "    except RuntimeError as e:\n        print('refused')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "[]", out.stdout
    if not torch.cuda.is_available():
        assert lines[1:] == ["refused"], out.stdout


EXAMPLES = SRC.parent / "examples"
EXAMPLE_NAMES = ("torch_sparse_cnn_sim", "torch_quickstart",
                 "torch_serve_batched", "torch_train_sparse_lm")


def test_numpy_models_and_examples_import_no_jax_and_no_reference():
    """The paper's numpy models (``core.simulator``, ``core.asic_model``,
    ``core.telescope``) and each ``examples/torch_*.py``, imported in a
    fresh process, load neither JAX nor ``repro``; importing an example
    runs nothing (its ``main`` is only called)."""
    probe = ("import importlib, importlib.util, sys\n"
             "for m in ('repro_torch.core.asic_model', "
             "'repro_torch.core.simulator', 'repro_torch.core.telescope'):\n"
             "    importlib.import_module(m)\n"
             f"for name in {EXAMPLE_NAMES!r}:\n"
             f"    spec = importlib.util.spec_from_file_location(name, "
             f"{str(EXAMPLES)!r} + '/' + name + '.py')\n"
             "    mod = importlib.util.module_from_spec(spec)\n"
             "    spec.loader.exec_module(mod)\n"
             "    assert callable(mod.main)\n"
             "print(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro'))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("name", EXAMPLE_NAMES)
def test_examples_default_to_the_card(name):
    """Without a card each example's default device raises; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    import importlib.util
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = {"torch_serve_batched": ["--smoke"],
            "torch_train_sparse_lm": ["--steps", "1", "--d-model", "64",
                                      "--layers", "1", "--ckpt", ""],
            "torch_sparse_cnn_sim": ["--layers", "1", "--image-size", "8"],
            "torch_quickstart": []}[name]
    with pytest.raises((AssertionError, RuntimeError)):
        mod.main(argv)


CNN_MODULES = ("repro_torch.graphs", "repro_torch.vision.engine",
               "repro_torch.vision.model", "repro_torch.sparsity.conv",
               "repro_torch.analysis")
LM_PACKAGES = ("models", "serve", "train", "optim", "ckpt", "launch")


@pytest.mark.parametrize("module", CNN_MODULES)
def test_cnn_path_imports_no_lm_and_no_dtensor(module):
    """The CNN path's layers point one way: each entry module, imported
    alone in a fresh process, loads neither DTensor
    (``torch.distributed.tensor``) nor any LM package of the port."""
    lm = tuple(f"repro_torch.{p}" for p in LM_PACKAGES)
    probe = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
             "print(sorted(m for m in sys.modules if m == "
             "'torch.distributed.tensor' or m in "
             f"{lm!r} or m.startswith(tuple(p + '.' for p in {lm!r}))))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
