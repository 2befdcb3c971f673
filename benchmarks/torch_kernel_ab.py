#!/usr/bin/env python3
"""Time the port's four CUDA kernels of two source trees in turns, on one
NVIDIA GPU: the A/B comparison of a kernel edit against its parent.

    python3 benchmarks/torch_kernel_ab.py [--json PATH] PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (``git archive`` of a commit,
unpacked); each is timed in its own process, which imports that root's
``src/repro_torch`` and builds its kernels into that root's build
directory. Every kernel is timed on the device: ``REPS`` calls captured in
a CUDA graph, replayed between CUDA events (a loop of calls would also time
the host, whose Python and launches take as long as a decode kernel), at
the main paths' shapes:

* K1, the walker: its tile mode at VGG16 layers 1, 8 and 10 (4 images at
  224 px, chunk pattern, fp32; 1568, 112 and 32 pairs) on the patch matrix
  and, in a tree that has it, on the tap-slab operand (the NHWC map, lazy
  im2col; a tree without it has no such rows), and both again at 32
  images (rows ending ``B32``: the benchmark's batch); its 8-row mode
  (the compact FFN schedule, bf16) on Qwen3-4B layer 0, two streams
  (in/gate, swiglu) and one stream (the out projection) at 2 and 4 decode
  rows and a 128-row prefill, and on RWKV6-3B layer 0's channel-mix (in,
  relu2; out) at 4 rows and 128 rows;
* K2, the dense-grid conv, at VGG16 layers 1, 8 and 10 (two-sided, with
  the output occupancy and the MAC counts);
* K3 and K4 on Qwen3-4B layer 0 (bf16): decode (4 live rows of a 128-row
  block) and a 128-row prefill.

Weights are random from seed 0 (density 0.35, 4 shards for the LMs; the
Table-1 filter density for VGG16), inputs from a seeded generator. Prints
one line per root and a table of the mean of each tree's runs, with the
card's name and power limit; with ``--json PATH`` it also writes every
run, with the registers and spill stores of every kernel entry the run
built, to ``PATH``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPS = 50
SEED = 0
# the images of the VGG16 rows: the 4 of the K2 rows, and the benchmark's
# batch of 32 (K1 alone)
VGG_BATCHES = (4, 32)
DENSITY, SHARDS = 0.35, 4
CHUNK, SUB_M = 128, 8


def cuda_ms(fn, reps: int = REPS, replays: int = 4) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph (after
    two calls of warm-up), replayed between CUDA events, so that the host's
    Python and launch cost, as long as a decode kernel, stays out. The
    captured launches go to a dropped tally where the tree has one (a
    capture with no tally open raises there)."""
    import contextlib
    import torch
    from repro_torch.kernels import _cuda
    tally = getattr(_cuda, "capture_tally", lambda t: contextlib.nullcontext())
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
        g = torch.cuda.CUDAGraph()
        with tally({}), torch.cuda.graph(g, stream=s):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(s)
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def vision_times(dev):
    """K1's tile mode and K2 at VGG16 layers 1, 8 and 10; K1 at 32 images
    too."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import simulator as S
    from repro_torch.kernels.sparse_conv import (extract_patches,
                                                 sparse_conv_spmm)
    from repro_torch.kernels.worklist_core import (build_worklist,
                                                   worklist_spmm)
    from repro_torch.launch.vision import blob_images
    from repro_torch.vision import build_vision_model, dense_forward
    from repro_torch.vision.model import VisionModel
    try:
        from repro_torch.kernels.sparse_conv import worklist_spmm_slabs
    except ImportError:          # a tree before the tap-slab operand
        worklist_spmm_slabs = None
    torch.backends.cudnn.allow_tf32 = False
    model = build_vision_model("VGGNet", pattern="chunk", seed=SEED,
                               device=dev)
    out = {}
    for batch in VGG_BATCHES:
        tag = "" if batch == VGG_BATCHES[0] else f" B{batch}"
        imgs = blob_images(np.random.default_rng(SEED), batch, 224,
                           S.BENCHMARKS["VGGNet"].map_density)
        for layer in (1, 8, 10):
            head = VisionModel(model.name, model.layers[:layer],
                               model.input_size, model.density, dev)
            x = dense_forward(head, torch.as_tensor(imgs, device=dev))
            lay = model.layers[layer]
            c, w = lay.conv, lay.conv.packed
            patches, (oh, ow) = extract_patches(
                x, c.kh, c.kw, lay.stride, lay.padding,
                strategy="taps" if c.layout == "tap" else "slices")
            m_pad = oh * ow + (-(oh * ow)) % 128
            flat = F.pad(patches, (0, w.shape[0] - patches.shape[-1], 0,
                                   m_pad - oh * ow)).reshape(-1, w.shape[0]) \
                .contiguous()
            del patches
            mb = flat.shape[0] // 128
            wl = build_worklist(w.host_indices(), mb,
                                mb_per_img=m_pad // 128)
            kw1 = dict(bk=w.bk, bn=w.bn, bm_rows=128, sub_m=SUB_M, act="relu",
                       emit_occupancy=True)
            out[f"K1 tile VGG16 L{layer}{tag}"] = cuda_ms(
                lambda: worklist_spmm(flat, w.vals, wl,
                                      mb_per_img=m_pad // 128, ncolors=2,
                                      **kw1))
            if worklist_spmm_slabs is not None:
                xc = x.contiguous()
                out[f"K1 tap slabs VGG16 L{layer}{tag}"] = cuda_ms(
                    lambda: worklist_spmm_slabs(
                        xc, w.vals, wl, kh=c.kh, kw=c.kw, stride=lay.stride,
                        padding=lay.padding, m_pad=m_pad, **kw1))
            if not tag:
                kw2 = dict(bk=w.bk, bn=w.bn, bm_rows=128, sub_m=SUB_M,
                           two_sided=True, emit_occupancy=True,
                           count_macs=True)
                out[f"K2 VGG16 L{layer}"] = cuda_ms(
                    lambda: sparse_conv_spmm(flat, w.indices, w.vals, **kw2))
            del flat, x
            torch.cuda.empty_cache()
    return out


def lm_leaf(arch, dev):
    """Layer 0's packed FFN (or channel-mix) of a one-layer sparse LM at
    full width, bf16, and the config."""
    from repro_torch.configs import load_config
    from repro_torch.models import model as M
    from repro_torch.sparsity.sparse_ffn import sparsify_model
    cfg = dataclasses.replace(load_config(arch), n_layers=1,
                              sparse_ffn=True)
    params = sparsify_model(M.init_params(cfg, seed=SEED, device=dev), cfg,
                            density=DENSITY, num_shards=SHARDS)
    bp = params["blocks"][0]["p0"]
    leaf = "ffn_sparse" if "ffn_sparse" in bp else "channel_mix_sparse"
    return cfg, bp[leaf]


def walk(x2, vals, idx, act, vals2=None, gidx=None):
    """One compact-schedule walker launch (schedule built once): returns
    the output and a function that launches it again."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.worklist_core import worklist_spmm
    wl = ops._worklist_for(x2, idx, gidx, SUB_M, CHUNK,
                           compact_activations=True, wl_cache=None)
    kw = dict(vals2=vals2, bk=CHUNK, bn=CHUNK, bm_rows=SUB_M, act=act)
    return worklist_spmm(x2, vals, wl, **kw)[0], \
        lambda: worklist_spmm(x2, vals, wl, **kw)


def lm_times(dev):
    """K1's 8-row mode, K3 and K4 at Qwen3-4B's and RWKV6-3B's layer 0."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitmask_spmm import bitmask_spmm
    from repro_torch.kernels.fused_ffn import fused_ffn_spmm
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg, sp = lm_leaf("qwen3_4b", dev)
    D = cfg.d_model
    for name, rows in (("D2", 2), ("D4", 4), ("P", 128)):
        x = torch.randn((rows, D), generator=gen, device=dev) \
            .to(torch.bfloat16)
        x2, _, _ = ops._pad_rows_k(x, D, SUB_M)
        h, fn = walk(x2, sp["in_vals"], sp["in_indices"], "swiglu",
                     sp["gate_vals"], sp["gate_indices"])
        out[f"K1 8-row two streams Qwen3-4B {name}"] = cuda_ms(fn)
        _, fn = walk(h, sp["out_vals"], sp["out_indices"], None)
        out[f"K1 8-row one stream Qwen3-4B out {name}"] = cuda_ms(fn)
        if name == "D2":
            continue
        xb = torch.zeros((128, D), dtype=torch.bfloat16, device=dev)
        xb[:rows] = x
        kw4 = dict(act="swiglu", bk=CHUNK, bn=CHUNK, bm=128, sub_m=SUB_M,
                   two_sided=True)
        args4 = (xb, sp["in_indices"], sp["in_vals"], sp["gate_indices"],
                 sp["gate_vals"])
        hb = fused_ffn_spmm(*args4, **kw4)
        regime = "D" if rows < 128 else "P"
        out[f"K4 Qwen3-4B {regime}"] = cuda_ms(
            lambda: fused_ffn_spmm(*args4, **kw4))
        kw3 = dict(bk=CHUNK, bn=CHUNK, bm=128, sub_m=SUB_M, two_sided=True,
                   count_macs=True)
        out[f"K3 Qwen3-4B {regime}"] = cuda_ms(
            lambda: bitmask_spmm(hb, sp["out_indices"], sp["out_vals"],
                                 **kw3))
    del sp
    torch.cuda.empty_cache()
    cfg, sp = lm_leaf("rwkv6_3b", dev)
    D = cfg.d_model
    for name, rows in (("D4", 4), ("P", 128)):
        x = torch.randn((rows, D), generator=gen, device=dev) \
            .to(torch.bfloat16)
        x2, _, _ = ops._pad_rows_k(x, D, SUB_M)
        h, fn = walk(x2, sp["in_vals"], sp["in_indices"], "relu2")
        out[f"K1 8-row one stream RWKV6-3B in {name}"] = cuda_ms(fn)
        _, fn = walk(h, sp["out_vals"], sp["out_indices"], None)
        out[f"K1 8-row one stream RWKV6-3B out {name}"] = cuda_ms(fn)
    return out


def ptxas(kernels):
    """Per kernel entry built in this process: registers and spill stores,
    from ``nvcc -Xptxas -v``."""
    import re
    out = {}
    for k in kernels:
        entry = None
        for line in k.build_log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and entry:  # the entry's own line, before its callees'
                out.setdefault(entry, {}).setdefault("spill_stores",
                                                     int(m.group(1)))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def one(root: str) -> int:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels._cuda import build_all
    from repro_torch.kernels.bitmask_spmm import BITMASK_SPMM
    from repro_torch.kernels.fused_ffn import FUSED_FFN
    from repro_torch.kernels.sparse_conv import CONV_GRID
    from repro_torch.kernels.worklist_core import WALK
    kernels = (WALK, CONV_GRID, BITMASK_SPMM, FUSED_FFN)
    build_all(kernels)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    times = vision_times(dev)
    torch.cuda.empty_cache()
    times.update(lm_times(dev))
    print(json.dumps({"root": root, "card": card(),
                      "source": repro_torch.__file__,
                      "seconds": time.perf_counter() - t0, "ms": times,
                      "ptxas": ptxas(kernels)}))
    return 0


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        return one(argv[1])
    json_out = None
    if argv[:1] == ["--json"]:
        json_out, argv = Path(argv[1]), argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for i, root in enumerate(argv):
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["run"] = i + 1
        runs.append(run)
        print(f"run {i + 1} ({root}, {run['card']}, {run['seconds']:.0f} s):"
              f" " + ", ".join(f"{k} {v:.4f}" for k, v in run["ms"].items()))
    roots = list(dict.fromkeys(argv))
    print(f"mean ms over each tree's runs [{runs[0]['card']}]")
    print("| kernel, shape | " + " | ".join(roots) + " | ratio |")
    # every tree's rows, in the order they first appear; a row a tree lacks
    # (a kernel mode it does not have) reads "-"
    keys = list(dict.fromkeys(k for r in runs for k in r["ms"]))
    for key in keys:
        means = [np.mean([r["ms"][key] for r in runs
                          if r["root"] == root and key in r["ms"]])
                 if any(r["root"] == root and key in r["ms"] for r in runs)
                 else None for root in roots]
        ratio = (f"{means[0] / means[-1]:.2f}x"
                 if len(means) > 1 and None not in means else "-")
        print(f"| {key} | " + " | ".join(
            "-" if m is None else f"{m:.4f}" for m in means)
            + f" | {ratio} |")
    if json_out is not None:
        json_out.parent.mkdir(parents=True, exist_ok=True)
        json_out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
