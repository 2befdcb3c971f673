"""The port's checkpoints and training loop: bitwise round trips (bf16
through its raw bits, fp32, int32), atomic commits, async saves, resume
from the newest complete checkpoint (6 steps then 9 bitwise equal to 9 in
one run), and a restored pruned model served as the in-memory one is.
The reference's own checkpoint tests (``tests/test_ckpt_serve.py``) are
the model: the same saves, restores and ``latest_step`` cases."""
import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig, load_smoke
from repro_torch.dist import partitioning as part
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.serve import Request, Scheduler
from repro_torch.sparsity import pruning
from repro_torch.sparsity.sparse_ffn import sparsify_model
from repro_torch.train.loop import (TrainLoopConfig, init_state,
                                    restore_or_init, train)
from repro_torch.tree import flatten_tree, map_tree

CPU = torch.device("cpu")
SHAPE = ShapeConfig("t", 32, 4, "train")


def _bf16_moe():
    """Moonlight smoke in bf16: bf16 weights, the fp32 router and the
    int32 ``expert_perm`` in one tree."""
    cfg = dataclasses.replace(load_smoke("moonshot_v1_16b_a3b"),
                              dtype="bfloat16")
    params = M.init_params(cfg, seed=3, device=CPU)
    params["expert_perm"] = torch.randperm(
        cfg.moe.num_experts, generator=torch.Generator().manual_seed(0)
    ).to(torch.int32)
    return cfg, params


def _bitwise(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        x, y = fa[k], fb[k]
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y), k


def test_save_restore_roundtrip_bitwise(tmp_path):
    cfg, params = _bf16_moe()
    dtypes = {str(v.dtype) for v in flatten_tree(params).values()}
    assert {"torch.bfloat16", "torch.float32", "torch.int32"} <= dtypes
    # an optimizer state after one update: non-trivial fp32 moments
    opt = adamw.init(params)
    opt = adamw.OptState(opt.step + 7, map_tree(torch.randn_like, opt.mu),
                         opt.nu)
    d = str(tmp_path)
    ckpt.save(d, 3, params, opt, extra={"arch": cfg.name})
    abs_p = M.abstract_params(cfg)
    p2, o2, man = ckpt.restore(d, 3, abs_p, adamw.init(abs_p), device=CPU)
    assert man["step"] == 3 and man["arch"] == cfg.name
    _bitwise(params, p2)
    _bitwise(opt, o2)
    assert int(o2.step) == 7 and o2.step.dtype == torch.int32
    # every leaf is stored as its raw bits, bf16 as its 16-bit patterns
    raw = (tmp_path / "step_00000003" / "params.bin").read_bytes()
    for key in ("embed", "expert_perm", "blocks/1/p0/moe/router"):
        e = man["leaves"]["params"][key]
        t = flatten_tree(params)[key]
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert e["offset"] % ckpt.ALIGN == 0
        assert raw[e["offset"]:e["offset"] + e["nbytes"]] == \
            bits.numpy().tobytes(), key
    assert man["leaves"]["params"]["embed"]["dtype"] == "bfloat16"
    # the templates' dtypes win: an fp32 template restores bf16 values
    p32 = ckpt.restore(d, 3, map_tree(
        lambda t: t.float() if t.is_floating_point() else t, abs_p),
        device=CPU)[0]
    assert torch.equal(p32["embed"], params["embed"].float())


def test_restore_rejects_a_wrong_manifest(tmp_path):
    cfg, params = _bf16_moe()
    d = str(tmp_path)
    final = ckpt.save(d, 1, params)
    with open(os.path.join(final, "manifest.json")) as f:
        man = json.load(f)
    for field, value in (("dtype", "float32"), ("dtype", "complex32"),
                         ("offset", 1 << 40)):
        bad = json.loads(json.dumps(man))
        bad["leaves"]["params"]["final_norm"][field] = value
        with open(os.path.join(final, "manifest.json"), "w") as f:
            json.dump(bad, f)
        with pytest.raises((ValueError, TypeError)):
            ckpt.restore(d, 1, M.abstract_params(cfg), device=CPU)


def test_latest_step_ignores_tmp(tmp_path):
    cfg, params = _bf16_moe()
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 1, params)
    ckpt.save(d, 2, params)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a crash mid-save
    assert ckpt.latest_step(d) == 2
    ckpt.save(d, 2, params)                              # overwrite
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000002",
                                     "step_00000009.tmp"]


def test_async_save(tmp_path):
    cfg, params = _bf16_moe()
    t = ckpt.save_async(str(tmp_path), 5, params)
    # the host copy was taken before the call returned: a later in-place
    # change does not reach the checkpoint
    snapshot = params["embed"].clone()
    params["embed"].add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    assert ckpt.latest_step(str(tmp_path)) == 5
    p2 = ckpt.restore(str(tmp_path), 5, M.abstract_params(cfg),
                      device=CPU)[0]
    assert torch.equal(p2["embed"].view(torch.int16),
                       snapshot.view(torch.int16))


@pytest.mark.parametrize("arch", ["qwen3_4b", "moonshot_v1_16b_a3b"])
def test_loop_restart_bitwise_equals_one_run(tmp_path, arch):
    """6 steps with a checkpoint every 3, then a fresh ``train`` to 9 that
    resumes at 6 (no fresh init), bitwise equal to 9 uninterrupted steps;
    the optimizer's step is restored, not reset."""
    cfg = load_smoke(arch)
    d = str(tmp_path / "ck")
    seen = []
    lc = TrainLoopConfig(steps=6, ckpt_every=3, ckpt_dir=d, log_every=100)
    st1 = train(cfg, SHAPE, lc, device=CPU,
                step_hook=lambda s, m: seen.append((s, m["loss"])))
    assert st1.step == 6 and [s for s, _ in seen] == list(range(1, 7))
    assert os.path.isdir(os.path.join(d, "step_00000006"))
    assert ckpt.latest_step(d) == 6
    resumed = restore_or_init(cfg, dataclasses.replace(lc, steps=9),
                              device=CPU)
    assert resumed.step == 6 and int(resumed.opt.step) == 6
    _bitwise(resumed.params, st1.params)
    _bitwise(resumed.opt, st1.opt)
    lc2 = TrainLoopConfig(steps=9, ckpt_every=3, ckpt_dir=d, log_every=100)
    st2 = train(cfg, SHAPE, lc2, device=CPU)
    assert st2.step == 9 and int(st2.opt.step) == 9
    one = train(cfg, SHAPE, TrainLoopConfig(steps=9, log_every=100),
                device=CPU)
    _bitwise(st2.params, one.params)
    _bitwise(st2.opt, one.opt)
    assert ckpt.latest_step(d) == 9


def test_loop_post_step_and_refusals(tmp_path, capsys):
    cfg = load_smoke("qwen3_4b")
    calls = []

    def post(state, metrics):
        calls.append((state.step, metrics["loss"]))
        return None                                   # keep the state

    st = train(cfg, SHAPE, TrainLoopConfig(steps=2, log_every=1),
               post_step=post, device=CPU)
    assert st.step == 2 and [s for s, _ in calls] == [1, 2]
    assert "step     2 loss" in capsys.readouterr().out
    # sharded training exists (A8b): what is not a mesh is refused, and
    # FSDP needs one; on a one-rank mesh, with checkpoints, it is solo's
    with pytest.raises(ValueError):
        train(cfg, SHAPE, TrainLoopConfig(steps=1), mesh=object(),
              device=CPU)
    with pytest.raises(ValueError, match="mesh"):
        init_state(cfg, fsdp=True, device=CPU)
    with one_rank_world():
        mesh = make_debug_mesh(1, 1, device="cpu")
        d = str(tmp_path / "mesh")
        lc = TrainLoopConfig(steps=2, ckpt_every=1, ckpt_dir=d, fsdp=True,
                             log_every=100)
        sharded = train(cfg, SHAPE, lc, mesh=mesh, device=CPU)
        assert ckpt.latest_step(d) == 2
        full = part.gather_tree((sharded.params, sharded.opt))
    _bitwise(full[0], st.params)
    _bitwise(full[1], st.opt)


@contextlib.contextmanager
def one_rank_world():
    """A gloo world of this process alone, destroyed on the way out."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_restored_pruned_model_serves_as_in_memory(tmp_path):
    """Prune, save, restore into abstract templates, pack: the restored
    model's greedy tokens equal the in-memory model's."""
    cfg = load_smoke("qwen3_4b")
    params = M.init_params(cfg, seed=0, device=CPU)
    masks = pruning.prune_masks(params, pruning.PruneConfig(density=0.5,
                                                            min_size=512))
    params = pruning.apply_masks(params, masks)
    scfg = dataclasses.replace(cfg, sparse_ffn=True)
    reqs = [Request(rid=i, prompt=np.arange(1, 7) + i, max_new=4)
            for i in range(3)]

    def served(p):
        packed = sparsify_model(p, scfg, density=0.5, num_shards=2)
        return Scheduler(scfg, packed, num_slots=2, max_len=16).run(reqs)

    ckpt.save(str(tmp_path), 0, params)
    restored = ckpt.restore(str(tmp_path), 0, M.abstract_params(cfg),
                            device=CPU)[0]
    _bitwise(params, restored)
    assert served(restored) == served(params)
