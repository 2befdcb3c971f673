#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU and check every kernel.

    python3 chip_smoke.py          (from the root of a checkout, one card)

Phases, each of which stops the script with a non-zero exit when it fails:

1. card identity (``nvidia-smi`` name and power limit, torch device name);
2. build both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print ``-Xptxas -v`` registers/smem/spills;
3. each kernel against its plain PyTorch version at two VGG16 layer shapes
   (layer 1 with 4 images, layer 8 with 4 images, 224 px, chunk pattern):
   max abs/rel error, exact occupancy and MAC counts, batched == per-image
   bitwise for the walker, and CUDA-event times of the kernel, the plain
   version and one dense ``F.conv2d`` (TF32 off) as a yardstick, beside the
   bound (live FLOPs at 67 TFLOP/s fp32 or bytes at 3.35 TB/s);
4. the main path, with the launch counters set to 0 first: full VGG16 at
   224 px through ``oracle_check`` (dense-grid kernel) for the chunk and
   unstructured patterns, rel err <= 1e-5 against the dense oracle; then
   ``VisionEngine`` (work-list walker) serving 8 staggered requests on 4
   slots, every output bitwise equal to the solo forward of its image.

It prints the kernels line (JSON) and the card line before the last line,
and as the last line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FP32_FLOPS = 67e12        # H100 SXM fp32 without tensor cores
HBM_BYTES = 3.35e12       # H100 SXM HBM3
TOL = 1e-5
SEED = 0
SIZE = 224


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def errors(got, ref):
    diff = float((got - ref).abs().max())
    return diff, diff / max(float(ref.abs().max()), 1e-30)


def layer_inputs(model, layer: int, imgs):
    """Activations entering ``layer`` (dense oracle over the layers before
    it), the padded im2col matrix, and the real and padded rows per image."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.sparse_conv import extract_patches
    from repro_torch.vision import dense_forward
    from repro_torch.vision.model import VisionModel
    x = torch.as_tensor(imgs, device=model.device)
    if layer:
        head = VisionModel(model.name, model.layers[:layer], model.input_size,
                           model.density, model.device)
        x = dense_forward(head, x)              # pools after each layer
    lay = model.layers[layer]
    c = lay.conv
    patches, (oh, ow) = extract_patches(
        x, c.kh, c.kw, lay.stride, lay.padding,
        strategy="taps" if c.layout == "tap" else "slices")
    m_img = oh * ow
    m_pad = m_img + (-m_img) % 128
    flat = F.pad(patches, (0, c.packed.shape[0] - patches.shape[-1], 0,
                           m_pad - m_img)).reshape(-1, c.packed.shape[0])
    return x, flat.contiguous(), m_img, m_pad


def kernel_phase(model, imgs, layer: int, card: str):
    """Both kernels vs their plain versions at one layer; returns the two
    per-kernel records."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.sparse_conv import (sparse_conv_spmm,
                                                 sparse_conv_spmm_plain)
    from repro_torch.kernels.worklist_core import (
        activation_occupancy, build_worklist, worklist_spmm,
        worklist_spmm_plain)
    lay = model.layers[layer]
    c, w = lay.conv, lay.conv.packed
    x, flat, m_img, m_pad = layer_inputs(model, layer, imgs)
    B = x.shape[0]
    M, K = flat.shape
    bm_rows, sub_m = 128, 8
    mb, mpi = M // bm_rows, m_pad // bm_rows
    idx = w.host_indices()
    stored = int((idx >= 0).sum())
    used = np.unique(idx[idx >= 0])

    # What the function needs, the same for both kernels (they compute the
    # same product): a MAC for every sub_m-row sub-block that is occupied in
    # a stored chunk (pad rows are zero, so never occupied), and each output
    # of the real rows written once.
    occ_in = activation_occupancy(flat, sub_m, w.bk)           # [M/sub_m, kb]
    per_chunk = occ_in.sum(0).cpu().numpy()
    live_macs = int(per_chunk[idx[idx >= 0]].sum())
    flops = 2.0 * sub_m * w.bk * w.bn * live_macs
    rows = B * m_img
    out_bytes = 4.0 * (rows * w.n_blocks * w.bn + rows // sub_m * w.n_blocks)
    at = (f"VGG16 layer {layer} ({c.kh}x{c.kw}x{c.cin}->{c.cout}), {B} images"
          f", {imgs.shape[1]} px, chunk pattern, bk={w.bk} bn={w.bn}")
    tag = f"[{card}]"

    # yardstick: one dense cuDNN conv of the same layer, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    xn = x.permute(0, 3, 1, 2).contiguous()
    wd = torch.as_tensor(c.w_dense, device=x.device).permute(3, 2, 0, 1) \
        .contiguous()
    lib_ms = cuda_ms(lambda: F.conv2d(xn, wd, padding=c.kh // 2), reps=10)

    # K1: the walker over the static (pack-time) schedule
    wl = build_worklist(idx, mb, mb_per_img=mpi)
    kw1 = dict(bk=w.bk, bn=w.bn, bm_rows=bm_rows, sub_m=sub_m, act="relu",
               emit_occupancy=True)
    out, occ = worklist_spmm(flat, w.vals, wl, mb_per_img=mpi, ncolors=2,
                             **kw1)
    pout, pocc = worklist_spmm_plain(flat, w.vals, wl, **kw1)
    torch.cuda.synchronize()
    abs1, rel1 = errors(out, pout)
    require(rel1 <= TOL, f"walker vs plain at layer {layer}: rel {rel1:.3e}")
    require(torch.equal(occ, pocc),
            f"walker occupancy differs from plain at layer {layer}")
    wl1 = build_worklist(idx, mpi, mb_per_img=mpi)
    per_img = torch.cat([worklist_spmm(flat[i * m_pad:(i + 1) * m_pad],
                                       w.vals, wl1, mb_per_img=mpi, ncolors=2,
                                       **kw1)[0] for i in range(B)])
    require(torch.equal(out, per_img),
            f"walker batch of {B} != per-image calls at layer {layer}")
    k1_ms = cuda_ms(lambda: worklist_spmm(flat, w.vals, wl, mb_per_img=mpi,
                                          ncolors=2, **kw1), reps=20)
    p1_ms = cuda_ms(lambda: worklist_spmm_plain(flat, w.vals, wl, **kw1),
                    reps=5)
    # the walker reads the used chunks of every real row (it has no
    # occupancy input), the stored weights and its schedule
    bytes1 = 4.0 * (rows * w.bk * used.size + stored * w.bk * w.bn
                    + wl.num_steps * 2 + wl.num_pairs + 1) + out_bytes
    b1, by1 = bound(flops, bytes1)

    # K2: the dense grid with the sub_m skip and the MAC counters
    kw2 = dict(bk=w.bk, bn=w.bn, bm_rows=bm_rows, sub_m=sub_m,
               two_sided=True, emit_occupancy=True, count_macs=True)
    out2, occ2, cnt2 = sparse_conv_spmm(flat, w.indices, w.vals, **kw2)
    pout2, pocc2, pcnt2 = sparse_conv_spmm_plain(flat, w.indices, w.vals,
                                                 fuse_relu=True, **kw2)
    torch.cuda.synchronize()
    abs2, rel2 = errors(out2, pout2)
    require(rel2 <= TOL, f"dense grid vs plain at layer {layer}: rel "
                         f"{rel2:.3e}")
    require(torch.equal(occ2, pocc2),
            f"dense-grid occupancy differs from plain at layer {layer}")
    require(torch.equal(cnt2, pcnt2),
            f"dense-grid MAC counts differ from plain at layer {layer}")
    k2_ms = cuda_ms(lambda: sparse_conv_spmm(flat, w.indices, w.vals, **kw2),
                    reps=20)
    p2_ms = cuda_ms(lambda: sparse_conv_spmm_plain(
        flat, w.indices, w.vals, fuse_relu=True, **kw2), reps=5)
    executed = int(cnt2.sum())
    require(executed == live_macs,
            f"dense grid counted {executed} sub-block MACs at layer {layer}, "
            f"the occupancy gives {live_macs}")
    # the dense grid reads only the occupied sub-blocks of the used chunks,
    # plus the occupancy map, the indices, the stored weights; it writes
    # the counts
    live_subblocks = int(per_chunk[used].sum())
    bytes2 = 4.0 * (live_subblocks * sub_m * w.bk + occ_in.numel()
                    + idx.size + stored * w.bk * w.bn
                    + w.n_blocks * mb) + out_bytes
    b2, by2 = bound(flops, bytes2)

    print(f"kernels @ {at} {tag}")
    print(f"  walker:     max abs err {abs1:.3e}, max rel err {rel1:.3e}, "
          f"occupancy equal, batch == per-image bitwise; {wl.mac_steps} live "
          f"steps of {wl.num_steps}, {live_macs} live sub-block MACs; kernel {k1_ms:.4f} ms, plain "
          f"{p1_ms:.4f} ms, bound {b1:.4f} ms ({by1}), dense conv2d "
          f"{lib_ms:.4f} ms")
    print(f"  dense grid: max abs err {abs2:.3e}, max rel err {rel2:.3e}, "
          f"occupancy and counts equal; {executed} sub-block MACs; kernel "
          f"{k2_ms:.4f} ms, plain {p2_ms:.4f} ms, bound {b2:.4f} ms ({by2}),"
          f" dense conv2d {lib_ms:.4f} ms")

    def rec(abs_, rel, k, p, b, by):
        return {"at": at, "max_abs_err": abs_, "max_rel_err": rel, "ms": k,
                "plain_ms": p, "bound_ms": b, "bound_by": by,
                "library_ms": lib_ms}
    return rec(abs1, rel1, k1_ms, p1_ms, b1, by1), \
        rec(abs2, rel2, k2_ms, p2_ms, b2, by2)


def drive(card: str):
    """Phases 3 and 4 on the card; returns the kernels-line records."""
    import torch
    from repro_torch.core import simulator as S
    from repro_torch.kernels.sparse_conv import CONV_GRID
    from repro_torch.kernels.worklist_core import WALK
    from repro_torch.launch.vision import blob_images
    from repro_torch.vision import (ImageRequest, VisionEngine,
                                    build_vision_model, compile_forward,
                                    layer_geometry, layer_table,
                                    oracle_check, schedule_summary)

    dev = torch.device("cuda")
    md = S.BENCHMARKS["VGGNet"].map_density
    imgs = blob_images(np.random.default_rng(SEED), 8, SIZE, md)
    t0 = time.perf_counter()
    chunk = build_vision_model("VGGNet", pattern="chunk", seed=SEED,
                               device=dev)
    print(f"built pruned VGG16 (chunk pattern) in "
          f"{time.perf_counter() - t0:.1f} s")
    last = layer_geometry(chunk, SIZE)[-1]     # no pool after the last conv
    out_shape = (last["oh"], last["ow"], chunk.layers[-1].conv.cout)

    # 3. kernels against their plain versions
    recs = {"walker": [], "grid": []}
    for layer in (1, 8):
        r1, r2 = kernel_phase(chunk, imgs[:4], layer, card)
        recs["walker"].append(r1)
        recs["grid"].append(r2)
    torch.cuda.empty_cache()

    # 4. the main path, counted from zero
    WALK.launches = CONV_GRID.launches = 0
    for pattern in ("chunk", "unstructured"):
        model = chunk if pattern == "chunk" else build_vision_model(
            "VGGNet", pattern=pattern, seed=SEED, device=dev)
        t0 = time.perf_counter()
        out, stats, rel = oracle_check(
            model, torch.as_tensor(imgs[:1], device=dev))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(tuple(out.shape) == (1,) + out_shape and
                bool(torch.isfinite(out).all()),
                f"{pattern}: output {tuple(out.shape)} is not finite of "
                f"shape {(1,) + out_shape}")
        print(f"VGG16 {SIZE} px pattern={pattern}: oracle_check (dense-grid "
              f"kernel, {model.num_layers} layers) rel err {rel:.3e} vs "
              f"dense F.conv2d (TF32 off), {dt:.2f} s with stats")
        require(rel <= TOL, f"{pattern}: rel err {rel:.3e} > {TOL}")
        for row in layer_table(stats):
            print(row)
        tot = schedule_summary(stats)
        print("  schedule: " + ", ".join(f"{k} {v:.4g}"
                                         for k, v in tot.items()))
    eng = VisionEngine(chunk, num_slots=4)
    reqs = [ImageRequest(rid=i, image=imgs[i], arrival=i // 3)
            for i in range(8)]
    produced = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {"walker": WALK.launches, "grid": CONV_GRID.launches}
    st = eng.stats
    forwards = st.engine_steps + 1                     # + the warm-up
    print(f"engine: {st.images} images on 4 slots in {st.engine_steps} "
          f"steps, {st.wall_s:.4f} s, {st.img_per_s:.2f} img/s steady "
          f"(first call {st.compile_s:.2f} s, util "
          f"{st.slot_utilization:.2f}) [{card}]")
    print(f"main-path launches: walker {launches['walker']} "
          f"({launches['walker'] / forwards:.0f} per engine forward), dense "
          f"grid {launches['grid']}")
    require(launches["walker"] > 0, "the engine never launched the walker")
    require(launches["grid"] > 0, "oracle_check never launched the grid")
    solo = compile_forward(chunk)
    for r in reqs:
        one = solo(torch.as_tensor(r.image[None], device=dev))[0]
        got = produced[r.rid]
        require(got.shape == out_shape and np.isfinite(got).all(),
                f"request {r.rid}: bad output")
        require(np.array_equal(got, one.cpu().numpy()),
                f"request {r.rid}: engine output != solo forward")
    print(f"engine outputs bitwise equal to the solo forward "
          f"({len(reqs)} requests)")

    meta = {
        "walker": ("worklist_spmm", "src/repro_torch/csrc/walk.cu",
                   "src/repro/kernels/worklist_core.py:622"),
        "grid": ("sparse_conv_spmm", "src/repro_torch/csrc/conv_grid.cu",
                 "src/repro/kernels/sparse_conv.py:74"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        first = recs[key][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(r["max_abs_err"] for r in recs[key]),
            "max_rel_err": max(r["max_rel_err"] for r in recs[key]),
            "ms": first["ms"], "kernel_ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "at": first["at"], "shapes": recs[key]})
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels._cuda import build_all
    from repro_torch.kernels.sparse_conv import CONV_GRID
    from repro_torch.kernels.worklist_core import WALK

    # 1. card identity
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | device 0: {kind}")

    # 2. build
    t0 = time.perf_counter()
    secs = build_all([WALK, CONV_GRID])
    print(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
          f"(per source {secs})")
    for k in (WALK, CONV_GRID):
        for line in k.build_log.splitlines():
            if any(s in line for s in ("registers", "spill", "smem")):
                print(f"  ptxas {k.source.name}: {line.strip()}")

    kernels = drive(card)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
