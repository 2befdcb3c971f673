"""Port parity, the production dry run (``repro_torch.launch.dryrun``,
ROADMAP A8c): full-config cells on a fake world of 256 (512) ranks, the
per-rank argument bytes against the reference's specs, FLOPs against the
solo count, and a data-parallel step's gradient reduction.

The fake-world legs run in subprocesses (no process group leaks into the
pytest worker): one runs the Jamba prefill cell (the longest: the
Mamba scan's chunks over 32768 tokens in 63 layers), the other the rest
of the cells through the module's entry point, then a (2, 2) and a (4, 1)
fake mesh; both at once. The argument bytes against the reference need
no world (a stub mesh of names and extents)."""
import ast
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import base as r_base
from repro.dist import partitioning as r_part
from repro.models import model as RM
from repro_torch.configs import base as t_base
from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 500
# (arch, shape, mesh, opt): one cell of each kind on the (16, 16) mesh,
# one multi-pod cell and one --opt cell
CELLS = [("qwen3_4b", "train_4k", "single", False),
         ("arctic_480b", "decode_32k", "single", False),
         ("rwkv6_3b", "train_4k", "single", False),
         ("seamless_m4t_medium", "decode_32k", "single", False),
         ("paligemma_3b", "prefill_32k", "single", False),
         ("qwen3_4b", "decode_32k", "single", False),
         ("qwen3_4b", "decode_32k", "multi", False),
         ("qwen3_4b", "decode_32k", "single", True)]
SLOW_CELLS = [("jamba_1_5_large_398b", "prefill_32k", "single", False)]

WORLD_SCRIPT = r"""
import json, sys, time, traceback
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs.base import load_smoke
from repro_torch.dist import partitioning as part
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M
from repro_torch.tree import flatten_tree, map_tree
from repro_torch.optim import adamw
from repro_torch.train import train_step as T

out_dir, which = sys.argv[1], sys.argv[2]
cells = json.loads(sys.argv[3])
rec = {}
for arch, shape, mesh, opt in cells:
    tag = f"{arch}_{shape}_{mesh}" + ("_opt" if opt else "")
    t0 = time.perf_counter()
    try:
        res = D.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                      "--out", out_dir] + (["--opt"] if opt else []))
        rec[tag] = ("ok", next(iter(res.values())))
    except BaseException:                 # SystemExit on a failed cell
        rec[tag] = ("failed", traceback.format_exc())
    rec[tag + "/wall"] = time.perf_counter() - t0


class Sizes(D.Probe):
    # the probe, logging each collective's kind and bytes
    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = dict(self.per_op_bytes)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented:
            for k, v in self.per_op_bytes.items():
                if v != before[k]:
                    self.log.append((k, v - before[k]))
        return out


def meta_batch(mesh, b, s):
    ids = torch.zeros((b, s), dtype=torch.long, device="meta")
    sh = part.NamedSharding.of(mesh, part.batch_spec(mesh))
    return {k: D._meta(ids, sh) for k in ("tokens", "labels")}


if which == "rest":
    cfg = load_smoke("qwen3_4b")
    abs_p = M.abstract_params(cfg)
    step = T.make_train_step(cfg, adamw.AdamWConfig())
    try:
        # solo FLOPs of the global step (torch's counter, no mesh)
        ids = torch.zeros((8, 32), dtype=torch.long, device="meta")
        with FlopCounterMode(display=False) as fc:
            step(abs_p, adamw.init(abs_p), {"tokens": ids, "labels": ids})
        D.fake_world(4)
        mesh = make_debug_mesh(2, 2, device="cpu")
        sp = map_tree(D._meta, abs_p, part.param_shardings(mesh, abs_p))
        probe = D.Probe()
        with probe:
            step(sp, adamw.init(sp), meta_batch(mesh, 8, 32))
        rec["flops_2x2"] = ("ok", {"rank": probe.flops,
                                   "solo": fc.get_total_flops()})
        torch.distributed.destroy_process_group()
        D.fake_world(4)
        mesh = make_debug_mesh(1, 4, device="cpu")
        sp = map_tree(D._meta, abs_p, part.param_shardings(mesh, abs_p))
        probe = Sizes()
        with probe:
            step(sp, adamw.init(sp), meta_batch(mesh, 8, 32))
        leaves = [t.to_local() for t in flatten_tree(sp).values()
                  if t.is_floating_point()]
        rec["dp_4x1"] = ("ok", {"log": probe.log, "leaf_bytes": [
            t.numel() * t.element_size() for t in leaves]})
        torch.distributed.destroy_process_group()
    except BaseException:
        rec["flops_2x2"] = rec["dp_4x1"] = ("failed", traceback.format_exc())
with open(f"{out_dir}/{which}.json", "w") as f:
    json.dump(rec, f)
print("WORLD_OK")
"""


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = {which: subprocess.Popen(
        [sys.executable, "-c", WORLD_SCRIPT, str(out), which,
         json.dumps(cells)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for which, cells in (("slow", SLOW_CELLS), ("rest", CELLS))}
    rec = {}
    for which, proc in procs.items():
        try:
            o, e = proc.communicate(timeout=max(
                1.0, TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            o, e = proc.communicate()
        assert proc.returncode == 0 and "WORLD_OK" in o, e[-3000:]
        with open(out / f"{which}.json") as f:
            rec.update(json.load(f))
    rec["wall"] = time.perf_counter() - t0
    return rec


def _ok(legs, tag):
    status, val = legs[tag]
    assert status == "ok", val
    return val


@pytest.mark.parametrize("cell", CELLS + SLOW_CELLS,
                         ids=lambda c: "_".join(str(v) for v in c))
def test_full_config_cell_runs(legs, cell):
    """Each cell runs through ``python -m repro_torch.launch.dryrun``'s
    ``main`` without a raise or a leaf off its placements, and records
    what the reference's does: finite, positive per-rank FLOPs and
    memory; collectives by kind; ``fits`` against the H100's target; a
    train cell's argument bytes are the state's (:func:`D.state_bytes`)
    plus the batch's."""
    arch, shape, mesh, opt = cell
    res = _ok(legs, f"{arch}_{shape}_{mesh}" + ("_opt" if opt else ""))
    assert res["arch"] == arch and res["shape"] == shape and res["opt"] == opt
    assert res["devices"] == (512 if mesh == "multi" else 256)
    mem, pd = res["memory"], res["per_device"]
    assert pd["flops"] > 0 and mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    assert set(pd["per_op_bytes"]) == set(D.COLLECTIVES)
    assert pd["collective_bytes"] == sum(pd["per_op_bytes"].values()) > 0
    assert res["fits"] == (mem["argument_size_in_bytes"]
                           + mem["temp_size_in_bytes"] <= D.TARGET_BYTES)
    if shape == "train_4k":
        sizes = dict(res["mesh"])
        stub = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
        cfg = t_base.load_config(arch)
        B = 256 // sizes["data"]
        batch = 2 * B * 4096 * 8                   # tokens and labels, int64
        assert mem["argument_size_in_bytes"] == D.state_bytes(
            cfg, stub, fsdp=D.ARCH_TUNE[arch]["fsdp"]) + batch
        assert mem["alias_size_in_bytes"] > 0      # the donated state


def test_cells_print_their_time(legs):
    walls = {k: round(v, 1) for k, v in legs.items() if k.endswith("/wall")}
    print(f"dry-run legs took {legs['wall']:.1f} s together: {walls}")
    assert len(walls) == len(CELLS) + len(SLOW_CELLS)


def test_opt_decode_moves_less_than_the_baseline(legs):
    """The head-sharded decode cache (``--opt``) leaves the sequence whole
    on each rank: the baseline gathers the sequence-sharded cache every
    step (the reference's §Perf finding), the rules move next to
    nothing."""
    base = _ok(legs, "qwen3_4b_decode_32k_single")["per_device"]
    opt = _ok(legs, "qwen3_4b_decode_32k_single_opt")["per_device"]
    assert opt["collective_bytes"] * 100 < base["collective_bytes"]


def _ref_arch_tune() -> dict:
    """The reference's ``ARCH_TUNE``, read from its source: importing
    ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py")
                     .read_text())
    node = next(n for n in tree.body if isinstance(n, ast.AnnAssign)
                and getattr(n.target, "id", "") == "ARCH_TUNE")
    return eval(compile(ast.Expression(node.value), "ARCH_TUNE", "eval"),
                {"dict": dict})


def _ref_state_bytes(arch: str, sizes: dict) -> int:
    """One rank's params, two fp32 moments and the int32 step, from the
    reference's ``param_specs`` with ``Rules(sizes=...)`` (its
    ``param_shardings``' specs) on the full config."""
    cfg = r_base.load_config(arch)
    abs_p = RM.abstract_params(cfg)
    tp = tuple(a for a in sizes if a.startswith("model"))
    rules = r_part.Rules(tp=tp, q_axes=tp, kv_axes=tp, sizes=sizes)
    fsdp = sizes["data"] if _ref_arch_tune()[arch]["fsdp"] else 0
    specs = r_part.param_specs(abs_p, fsdp=fsdp, rules=rules)
    total = 4
    leaves = jax.tree_util.tree_leaves(abs_p)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        for dim, e in zip(leaf.shape, entries):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            n *= dim // int(np.prod([sizes[a] for a in axes]))
        total += n * (np.dtype(leaf.dtype).itemsize + 8)
    return total


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", t_base.ARCHS)
def test_state_bytes_equal_reference_specs(arch, multi):
    """Per-rank argument bytes of the train state (params in their
    blocks, AdamW's two fp32 moments, the step) exactly equal to what the
    reference's specs imply, for all ten full configs on the production
    mesh, with the reference's FSDP choice."""
    assert D.ARCH_TUNE == _ref_arch_tune()
    shape, names = (((2, 16, 16), ("pod", "data", "model")) if multi
                    else ((16, 16), ("data", "model")))
    sizes = dict(zip(names, shape))
    stub = types.SimpleNamespace(axis_names=names, shape=sizes)
    got = D.state_bytes(t_base.load_config(arch), stub,
                        fsdp=D.ARCH_TUNE[arch]["fsdp"])
    assert got == _ref_state_bytes(arch, sizes)


def test_rank_flops_times_four_equal_solo(legs):
    """On a (2, 2) fake mesh with the Qwen3 smoke config (every matmul
    divides), one rank's FLOPs x 4 equal ``FlopCounterMode``'s count of
    the same global step solo within 1%: the probe counts local ops only
    (DTensor's sharding propagation runs each op once more on fake
    tensors of the global shapes), and no model rank repeats another's
    work."""
    got = _ok(legs, "flops_2x2")
    assert got["solo"] > 0
    assert abs(4 * got["rank"] - got["solo"]) <= 0.01 * got["solo"]


def test_data_parallel_step_reduces_each_gradient_once(legs):
    """A pure data-parallel (4, 1) train step: every collective an
    all-reduce; one per float leaf with that leaf's bytes, besides the
    loss's two scalars."""
    got = _ok(legs, "dp_4x1")
    assert {k for k, _ in got["log"]} == {"all-reduce"}
    sizes = [b for _, b in got["log"]]
    assert sorted(b for b in sizes if b > 8) == sorted(got["leaf_bytes"])
    assert min(got["leaf_bytes"]) > 8
    assert len(sizes) == len(got["leaf_bytes"]) + 2
