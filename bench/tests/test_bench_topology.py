"""A configuration names its topology, whose program and reference modules
share its stem. Without the key it runs the chain, bit for bit as the
harness ran it before the key existed, also beside a configuration that
names another topology; a pair under a stem of its own, in a tree of its
own, is found by ``load_cell`` and drives a whole run, the check and the
yardstick; a bad name or a missing file fails at ``load_cell``, naming the
file."""
import hashlib
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness
from bench.inputs import make_inputs
from bench.reference import chain, counts
from bench.run import run_cell
from conftest import tiny_config

ROOT = Path(__file__).resolve().parents[2]
FIXTURE = Path(__file__).parent / "topology_fixture"
SEED = 2**31 + 5
H100 = "NVIDIA H100 80GB HBM3"

# Recorded from the chain's code before a configuration named its modules
# (``harness.build_model``, and ``prune_filters``, ``forward``'s
# ``masks_out`` and ``counts.map_bytes`` of the chain's reference, then
# ``bench/reference/net.py``), on 3 images of 16 px drawn from
# SEED: sha256 prefixes of the pruned filters and of the packed network
# (``digest``, ``model_digest``), each image's MACs, one image's map bytes.
GOLDEN = {
    "tiny_unstructured": {"pruned": "421d3542b2063bf4",
                          "model": "daf1662b16bd594e",
                          "macs": [50689, 50481, 49489], "map_bytes": 15104},
    "tiny_chunk": {"pruned": "82a2d8c3bfd5b0cd", "model": "41d5112f333b8ade",
                   "macs": [49165, 50269, 50733], "map_bytes": 15104},
    "vgg16_chunk": {"pruned": "9a9c5d6a7e20f9a0", "model": "e5075bab1a151e6f",
                    "macs": [8640265, 8644041, 8667401],
                    "map_bytes": 461824},
    "resnet50_unstructured": {"pruned": "26f7bcbf884797d6",
                              "model": "e0acc50bf03c0490",
                              "macs": [3582844, 3569592, 3576811],
                              "map_bytes": 390144},
}


def digest(*arrays) -> str:
    d = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        d.update(str(a.dtype).encode())
        d.update(str(a.shape).encode())
        d.update(a.tobytes())
    return d.hexdigest()[:16]


def model_digest(model) -> str:
    parts = [np.array([model.input_size]), np.array([model.density]),
             np.frombuffer(model.name.encode(), np.uint8)]
    for l in model.layers:
        text = str((l.padding, l.pool_after, l.conv.layout, l.conv.pattern))
        parts += [np.array(l.stride), np.frombuffer(text.encode(), np.uint8),
                  l.conv.w_dense, l.conv.perm]
    return digest(*parts)


def config_of(key):
    """The tiny chain, or an accepted configuration cut to a 16 px
    input."""
    if key.startswith("tiny_"):
        return tiny_config(key[len("tiny_"):])
    cfg = json.loads((ROOT / "bench" / "configs" / f"{key}.json").read_text())
    return dict(cfg, input_size=16)


def tree(root: Path, **keys) -> Path:
    """A tree of its own under ``root``: a ``BENCHMARK.json`` of one cell
    on the tiny chain, whose configuration carries ``keys``, its files,
    and the fixture's modules."""
    bench = root / "bench"
    for folder in ("programs", "reference"):
        shutil.copytree(FIXTURE / folder, bench / folder)
    files = {
        "configs/tiny.json": dict(tiny_config(), **keys),
        "workloads/tiny.offline.json": {
            "num_slots": 4, "warm_steps": 2, "sample_steps": 2,
            "limits": {"max_rel_err": 1e-4}},
        "traffic/closed_16.json": {"loop": "closed", "sides": [16],
                                   "pool": 8, "queue_depth": 8},
    }
    for rel, obj in files.items():
        (bench / rel).parent.mkdir(parents=True, exist_ok=True)
        (bench / rel).write_text(json.dumps(obj))
    (root / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "tiny", "file": "bench/configs/tiny.json"}],
        "workloads": [{"name": "tiny.offline", "config": "tiny",
                       "traffic": "closed_16", "chips": 1}],
        "end_to_end": [{"name": "img_per_s", "unit": "img/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []}))
    return root


def topologies(root: Path) -> dict:
    """Each configuration of ``root``'s ``BENCHMARK.json`` by name, with
    the topology it names (``chain`` where it names none), having checked
    that it and every cell on it resolve to that topology's two files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    stems = {}
    for c in spec["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        stems[c["name"]] = cfg.get("topology", "chain")
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"], root=root)
        stem = stems[w["config"]]
        assert Path(cell.program.__file__) == \
            root / f"bench/programs/{stem}.py"
        assert Path(cell.reference.__file__) == \
            root / f"bench/reference/{stem}.py"
    return stems


def with_a_keyed_config(root: Path) -> Path:
    """A copy of the benchmark's files under ``root`` that gains a
    configuration naming the fixture's topology, and a cell on it."""
    for rel in ("BENCHMARK.json", "bench/configs", "bench/workloads",
                "bench/traffic", "bench/programs", "bench/reference"):
        src, dst = ROOT / rel, root / rel
        if src.is_dir():
            shutil.copytree(src, dst,
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dst)
    for folder in ("programs", "reference"):
        shutil.copy(FIXTURE / folder / "twin.py",
                    root / "bench" / folder / "twin.py")
    bench = root / "bench"
    (bench / "configs/tiny_twin.json").write_text(
        json.dumps(dict(tiny_config(), topology="twin")))
    shutil.copy(bench / "workloads/vgg16.offline_b32.json",
                bench / "workloads/tiny_twin.offline.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_twin",
                            "file": "bench/configs/tiny_twin.json"})
    spec["workloads"].append({"name": "tiny_twin.offline",
                              "config": "tiny_twin",
                              "traffic": "closed_224", "chips": 1})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("keyed", [False, True],
                         ids=["as_committed", "beside_a_keyed_config"])
def test_a_configuration_without_the_keys_runs_the_chain(tmp_path, keyed):
    root = with_a_keyed_config(tmp_path) if keyed else ROOT
    stems = topologies(root)
    assert stems["vgg16_chunk"] == "chain"
    assert stems["resnet50_unstructured"] == "chain"
    if keyed:
        assert stems["tiny_twin"] == "twin"


@pytest.mark.parametrize("key", list(GOLDEN))
def test_the_chain_through_its_modules_is_unchanged_bit_for_bit(key):
    cfg = config_of(key)
    want = GOLDEN[key]
    program, reference = harness.modules_of(cfg)
    filters, pool = make_inputs(cfg, 3, 16, SEED, "cpu")
    dense = [f.numpy() for f in filters]
    pruned = reference.prune_filters(cfg, dense)
    assert digest(*pruned) == want["pruned"]
    ref = reference.device_filters(pruned, "cpu")
    direct = chain.device_filters(chain.prune_filters(cfg, dense), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(ref, direct))
    for precision in ("float32", "tf32"):
        assert torch.equal(reference.forward(cfg, ref, pool, precision),
                           chain.forward(cfg, direct, pool, precision))
    masks = []
    reference.forward(cfg, ref, pool, masks_out=masks)
    assert torch.stack(masks).sum(0).tolist() == want["macs"]
    assert reference.map_bytes(cfg, 16) == want["map_bytes"]
    y = harness.yardstick(reference, cfg, pruned, ref, pool, H100)
    assert y.macs.tolist() == want["macs"]
    assert y.map_bytes == want["map_bytes"]
    assert y.step_bound_s([0, 2]) == counts.forward_bound_s(
        want["macs"][0] + want["macs"][2], 2, want["map_bytes"],
        counts.filter_bytes(pruned), counts.peaks_for(H100))
    assert model_digest(program.build(cfg, filters, "cpu")) == want["model"]


def test_a_pair_under_other_stems_runs_in_a_tree_of_its_own(tmp_path):
    root = tree(tmp_path, topology="twin")
    cell = harness.load_cell("tiny.offline", root=root)
    assert Path(cell.program.__file__) == root / "bench/programs/twin.py"
    assert Path(cell.reference.__file__) == root / "bench/reference/twin.py"
    res = run_cell(cell, SEED, 0.5, False, torch.device("cpu"),
                   log=io.StringIO())
    assert res["correct"], res["checks"]
    assert res["checks"]["sampled"]["value"] > 0
    assert cell.program.CALLS == ["build"]
    assert cell.reference.CALLS[:2] == ["prune_filters", "device_filters"]
    assert "forward" in cell.reference.CALLS
    # the yardstick and the bound it gives a step go through it too
    cfg = cell.config
    filters, pool = make_inputs(cfg, 4, 16, SEED, "cpu")
    pruned = cell.reference.prune_filters(cfg, [f.numpy() for f in filters])
    ref = cell.reference.device_filters(pruned, "cpu")
    y = harness.yardstick(cell.reference, cfg, pruned, ref, pool, H100)
    assert cell.reference.CALLS[-1] == "map_bytes"
    assert y.map_bytes == chain.map_bytes(cfg, 16)
    assert y.step_bound_s([0, 1]) > 0
    assert (y.macs > 0).all()


@pytest.mark.parametrize("stem,says", [
    ("../chain", "not the stem"),
    ("a/b", "not the stem"),
    ("chain.py", "not the stem"),
    ("..", "not the stem"),
    ("", "not the stem"),
    (7, "not the stem"),
    ("nosuch", "no file bench/programs/nosuch.py"),
    ("solo", "no file bench/reference/solo.py"),
    ("half", "bench/reference/half.py defines no "
             "prune_filters, device_filters, map_bytes"),
])
def test_a_bad_name_or_a_missing_file_fails_at_load_cell(tmp_path, stem,
                                                         says):
    root = tree(tmp_path, topology=stem)
    programs = root / "bench/programs"
    for name in ("solo", "half"):
        shutil.copy(programs / "twin.py", programs / f"{name}.py")
    (root / "bench/reference/half.py").write_text(
        "def forward(config, filters, x, precision='float32',"
        " masks_out=None):\n    return x\n")
    with pytest.raises(SystemExit) as e:
        harness.load_cell("tiny.offline", root=root)
    assert str(e.value).startswith("bench/configs/tiny.json: ")
    assert says in str(e.value)
