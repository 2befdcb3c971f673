"""A gloo world of CPU ranks that runs every LM family's sharded train,
prefill and decode steps, for ``tests/test_torch_dist_families.py``.

    python tests/torch_dist_families_world.py OUT_DIR WEIGHTS_PICKLE [WORLD]

Spawns ``WORLD`` ranks (default 8; one process each, one torch thread, a
``file://`` store in ``OUT_DIR``) on a (data=4, model=2) mesh. For each
family of :data:`ARCHS` and each layout of :data:`MODES` (the baseline
rules; ``make_rules`` with SP residuals and the head-sharded cache) one
leg runs, under its own timeout (:data:`LEG_TIMEOUT_S`, an alarm in the
rank):

* the train step, solo and sharded: loss and every gradient (reduced to
  the params' placements), then one AdamW step's params;
* the last-position logits of ``make_prefill_fn``, solo and sharded;
* the cache-writing prefill of the first :data:`PROMPT` tokens into a
  zeroed cache (``init_cache_on``: placed by ``cache_shardings``), then
  :data:`STEPS` greedy steps of ``make_serve_step``, solo and sharded, with
  the logits of each step and the cache after the last.

Each rank records, per leg, ``"ok"`` and its values or the traceback in
``OUT_DIR/rank<r>.pkl``: the gathered arrays (rank 0), the leaves whose
placements are not their shardings', and the replicated leaves that
differ between the ranks holding them (every rank).

Imports the port only (no JAX): ``WEIGHTS_PICKLE`` holds the reference's
smoke weights and train batches as numpy arrays (made by the test
process), carried across with ``convert.params_from_reference``.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import signal
import sys
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

ARCHS = ("rwkv6_3b", "jamba_1_5_large_398b", "seamless_m4t_medium",
         "paligemma_3b", "qwen3_4b", "moonshot_v1_16b_a3b")
MODES = ("base", "opt")
MESH = (4, 2)                       # (data, model)
PROMPT, MAX_LEN, STEPS = 8, 16, 8
GROUP_TIMEOUT_S = 120
LEG_TIMEOUT_S = 90


def _batch_on(batch, mesh):
    """The batch placed as the reference places it: [B, S] by
    ``batch_spec``, [B, S, D] by the batch over the data dims."""
    from repro_torch.dist import partitioning as part
    from repro_torch.dist import dp_axes
    out = {}
    for k, v in batch.items():
        spec = part.batch_spec(mesh) if v.ndim == 2 else \
            part.P(tuple(dp_axes(mesh)), None, None)
        out[k] = part.distribute(v, part.NamedSharding.of(mesh, spec))
    return out


def _off(tree, shardings) -> list:
    """Keys of the leaves whose placements are not their shardings'."""
    from repro_torch.tree import flatten_tree
    want = flatten_tree(shardings)
    return [k for k, t in flatten_tree(tree).items()
            if tuple(getattr(t, "placements", ())) != want[k].placements]


def _train(cfg, params, sp, batch, sb, p_sh, o_sh, mesh, ctx):
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as T
    from torch_dist_lm_world import _np, _replicas_differ
    step = T.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0))
    out = {}
    for name, p, b in (("solo", params, batch), ("sharded", sp, sb)):
        with ctx() if name == "sharded" else contextlib.nullcontext():
            loss, _, grads = T.loss_and_grads(p, b, cfg)
            grads = adamw.reduce_grads(p, grads)
            p2, o2, m = step(p, adamw.init(p), b)
        rec = {"loss": float(loss), "grads": _np(grads), "params": _np(p2),
               "metrics": {k: float(v) for k, v in m.items()}}
        if name == "sharded":
            rec["off"] = _off(p2, p_sh) + _off(o2.mu, o_sh.mu)
            rec["replicated_mismatch"] = _replicas_differ((p2, o2, m), mesh)
        out[name] = rec
    return out


def _serve(cfg, params, sp, batch, sb, mesh, rules, ctx):
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    from torch_dist_lm_world import _np, _replicas_differ
    extras = {k: v for k, v in batch.items()
              if k in ("prefix_embeds", "src_embeds")}
    s_extras = {k: v for k, v in sb.items() if k in extras}
    fn = E.make_prefill_fn(cfg)
    with torch.no_grad():
        solo_pf = fn(params, batch["tokens"], **extras)
        with ctx():
            mesh_pf = fn(sp, sb["tokens"], **s_extras)
    enc_len = batch["src_embeds"].shape[1] if cfg.encoder_layers else 0
    B = batch["tokens"].shape[0]
    solo_c = M.init_cache(cfg, B, MAX_LEN, enc_len=enc_len, device="cpu")
    mesh_c, c_sh = E.init_cache_on(mesh, cfg, B, MAX_LEN, enc_len=enc_len,
                                   rules=rules, device="cpu")
    step = E.make_serve_step(cfg)
    prompt = batch["tokens"][:, :PROMPT].contiguous()
    rec = {"prefill": {"solo": solo_pf.numpy(),
                       "sharded": mesh_pf.full_tensor().numpy()}}
    with torch.no_grad():
        if cfg.encoder_layers:
            solo_c = M.prefill_cache(params, cfg, solo_c, M.encode(
                params, extras["src_embeds"], cfg))
            mesh_c = M.prefill_cache(sp, cfg, mesh_c, M.encode(
                sp, s_extras["src_embeds"], cfg))
        last_s, solo_c = M.prefill(params, cfg, prompt, solo_c)
        last_m, mesh_c = M.prefill(sp, cfg, _batch_on({"t": prompt},
                                                      mesh)["t"], mesh_c)
        rec["cache_prefill"] = {"solo": last_s.numpy(),
                                "sharded": last_m.full_tensor().numpy()}
        off = _off(mesh_c, c_sh)
        tok_s = torch.argmax(last_s, -1)[:, None]
        tok_m = _batch_on({"t": tok_s}, mesh)["t"]
        toks = {"solo": [], "sharded": []}
        logits = {"solo": [], "sharded": []}
        for i in range(STEPS):
            pos = torch.full((B,), PROMPT + i)
            ls, _ = M.decode_step(params, cfg, tok_s, solo_c, pos)
            lm, _ = M.decode_step(sp, cfg, tok_m, mesh_c, pos)
            tok_s, solo_c = step(params, solo_c, tok_s, pos)
            tok_m, mesh_c = step(sp, mesh_c, tok_m, pos)
            toks["solo"].append(tok_s.numpy())
            toks["sharded"].append(tok_m.full_tensor().numpy())
            logits["solo"].append(ls.numpy())
            logits["sharded"].append(lm.full_tensor().numpy())
            off += _off(mesh_c, c_sh)
        rec["decode"] = {"tokens": toks, "logits": logits,
                         "cache": _np(mesh_c), "solo_cache": _np(solo_c)}
    rec["off"] = sorted(set(off))
    rec["replicated_mismatch"] = _replicas_differ((mesh_c, tok_m), mesh)
    return rec


def leg(ctx, arch: str, mode: str):
    from repro_torch.configs.base import load_smoke
    from repro_torch.convert import params_from_reference
    from repro_torch.dist import partitioning as part
    from repro_torch.dist.act_sharding import act_sharding, sp_spec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    import torch
    cfg = load_smoke(arch)
    mesh = make_debug_mesh(MESH[1], MESH[0], device="cpu")
    w = ctx.weights[arch]
    params = params_from_reference(w["params"], device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in w["batch"].items()}
    batch["tokens"], batch["labels"] = batch["tokens"].long(), \
        batch["labels"].long()
    rules = part.make_rules(mesh, cfg.n_heads, cfg.n_kv_heads) \
        if mode == "opt" else None
    p_sh = part.param_shardings(mesh, M.abstract_params(cfg), rules=rules)
    o_sh = adamw.opt_shardings(mesh, p_sh)
    sp = part.distribute_tree(params, p_sh)
    sb = _batch_on(batch, mesh)
    def sp_ctx():
        return act_sharding(mesh, sp_spec(mesh)) if mode == "opt" \
            else contextlib.nullcontext()
    return {"train": _train(cfg, params, sp, batch, sb, p_sh, o_sh, mesh,
                            sp_ctx),
            **_serve(cfg, params, sp, batch, sb, mesh, rules, sp_ctx)}


def _timeout(signum, frame):
    raise TimeoutError(f"the leg ran past {LEG_TIMEOUT_S} s")


def _rank(rank: int, world: int, out_dir: str, weights_path: str) -> None:
    import types
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    with open(weights_path, "rb") as f:
        ctx = types.SimpleNamespace(weights=pickle.load(f))
    signal.signal(signal.SIGALRM, _timeout)
    rec = {}
    for arch in ARCHS:
        for mode in MODES:
            signal.alarm(LEG_TIMEOUT_S)
            try:
                got = leg(ctx, arch, mode)
                if rank:      # the gathered arrays are rank 0's to keep
                    got = {"off": got["off"], "train_off":
                           got["train"]["sharded"]["off"],
                           "replicated_mismatch": got["replicated_mismatch"]
                           + got["train"]["sharded"]["replicated_mismatch"]}
                rec[f"{arch}/{mode}"] = ("ok", got)
            except Exception:          # recorded for the parent to show
                rec[f"{arch}/{mode}"] = ("failed", traceback.format_exc())
            signal.alarm(0)
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
                pickle.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    import tempfile
    import torch.multiprocessing as mp
    argv = sys.argv[1:] if argv is None else argv
    out_dir = os.path.abspath(argv[0])
    weights = os.path.abspath(argv[1])
    world = int(argv[2]) if len(argv) > 2 else 8
    os.makedirs(out_dir, exist_ok=True)
    tempfile.tempdir = out_dir
    mp.spawn(_rank, args=(world, out_dir, weights), nprocs=world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
