#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU and check every kernel.

    python3 chip_smoke.py          (from the root of a checkout, one card)

Phases, each of which stops the script with a non-zero exit when it fails:

1. card identity (``nvidia-smi`` name and power limit, torch device name);
2. (and 5.) build all four CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once) and print ``-Xptxas -v``
   registers/smem/spills of every variant;
3. the vision kernels against their plain PyTorch versions at two VGG16
   layer shapes (layer 1 with 4 images, layer 8 with 4 images, 224 px,
   chunk pattern): max abs/rel error, exact occupancy and MAC counts,
   batched == per-image bitwise for the walker (its tile mode), the dense
   grid bitwise equal to the walker, each launch's grid, and CUDA-event
   times of the kernel, the plain version and one dense ``F.conv2d`` (TF32
   off) as a yardstick, beside the bound (live FLOPs at 67 TFLOP/s fp32 or
   bytes at 3.35 TB/s) and, for the walker, the terms it executes, the
   share of them that are zero in x and their FMA roof;
4. the vision main path, with the launch counters set to 0 first: full
   VGG16 at 224 px through ``oracle_check`` (dense-grid kernel) for the
   chunk and unstructured patterns, rel err <= 1e-5 against the dense
   oracle; then ``VisionEngine`` (work-list walker) serving 8 staggered
   requests on 4 slots, every output bitwise equal to the solo forward;
   then one compiled forward of 4 images (``compile_forward``, the
   engine's path) against ``dense_forward`` (cuDNN, TF32 off), median and
   range of several windows, and one forward's kernels from a
   ``torch.profiler`` trace: the walker (each layer), pooling, the other
   kernels (im2col, pad, copies) by name, and the card's idle time;
6. the LM FFN kernels (predicated sparse matmul, fused FFN) against their
   plain versions at Qwen3-4B full-width shapes, layer 0 of the packed
   model (and, in phase 10, at RWKV6-3B's channel-mix), each with its
   launch grid (CTAs, busy CTAs at decode, column groups): decode (4 live
   rows in a 128-row block) and a 128-token prefill, each in fp32 (rel
   err <= 1e-5) and bf16 (each version's output bit for
   bit the bf16 rounding of its own fp32 sums, and more than one bf16 ulp
   from the plain version only where the two fp32 sums already differ by
   half an ulp; worst case printed), MAC counts exactly equal, every row
   bitwise independent of the other rows of its block; CUDA-event times
   beside the bound (live FLOPs at the operand type's peak, 67 TFLOP/s fp32
   or 989 TFLOP/s bf16 on the tensor cores, or bytes at 3.35 TB/s) and one
   ``torch.matmul`` yardstick;
7. the LM main path, with the launch counters set to 0 first: sparse
   Qwen3-4B at full width (bf16, density 0.35, depth cut to LM_LAYERS)
   through ``Scheduler`` (4 slots, 8 requests, prompt 128, 32 new tokens,
   arrivals every 2 steps, FFN probe on): tok/s, slot utilization, the
   probe's executed/skipped fractions, one launch of each FFN kernel per
   layer and forward, and every request's greedy tokens bitwise equal to
   the same request served alone on a scheduler of the same width; the
   admissions replayed from one captured graph (``GraphedAdmit``, the
   slot a device tensor) and the probe captured (``GraphedFfnStats``),
   its counters equal to the eager scheduler's; then the captured prefill
   (``GraphedPrefill``), admission and probe against their eager paths:
   bitwise equal, prefill and admission timed graph against eager (CUDA
   events), the probe's replay equal to the eager probe; and (Qwen3-4B
   only) a sampled ``generate`` (a seeded CUDA generator) captured and
   eager: tokens bitwise equal, tok/s of each;
8. the LM oracle: the same model in fp32, ``prefill`` and ``decode_step``
   logits through the kernels within rel err 1e-5 of the same forward with
   every FFN on its densified weights (``torch.matmul``, TF32 off);
9. the work-list FFN schedule on Qwen3-4B layer 0's packed FFN, at decode
   (2 and 4 rows) and a 128-token prefill, fp32 and bf16: the main path
   ``sparse_ffn_apply(schedule="compact")`` (the walker, two streams then
   one) counted from zero and bitwise equal to ``schedule="dense"`` (fused
   FFN then sparse matmul); its schedule counters equal to the host model,
   compaction 16x at decode; the walker's 8-row (grid) mode against its
   plain version (fp32 rel err <= 1e-5, bf16 as in phase 6), two streams
   (in/gate) then one (the out projection on that hidden), each with its
   launch grid (CTAs, busy CTAs, column groups, ring stages) and
   CUDA-event times beside the bound and one ``torch.matmul`` yardstick;
10. sparse RWKV6-3B at full width (bf16, density 0.35, depth cut to
   LM_LAYERS): phase 6's K3/K4 checks and timings at layer 0's relu2
   channel-mix (d_ff 8960, non-gated), then served through ``Scheduler``
   as in phase 7 (squared-ReLU channel-mix through the fused FFN and the
   sparse matmul, tokens bitwise equal to solo), one channel-mix through
   ``schedule="compact"`` (the
   walker's one-stream relu2 epilogue) bitwise equal to ``"dense"`` at
   decode and prefill, its two walker launches (in, relu2; out) checked and
   timed as in phase 9, and the fp32 oracle of phase 8;
11. lazy im2col, autotuning and the SLA-aware server on a fresh VGG16
   (224 px, 4 images, chunk pattern, fp32): (a) K1's tap-slab operand (the
   walker reading each live ``(tap, channel group)`` slab from the NHWC
   map with im2col tensor copies) at layers 1 and 8 against its plain
   version (rel err <= 1e-5, occupancy equal) and bitwise against K1 on the
   taps patch matrix, with its launch grid and graph-replay times beside
   its bound (bytes of the map, the weights and the output, or the needed
   FLOPs), K1 on the patch matrix, the layer call with ``taps`` (im2col +
   K1) and with ``lazy``, and one ``F.conv2d`` (TF32 off); (b) every
   tap-layout layer pinned to ``im2col="lazy"`` at 128-row blocks through
   ``autotune_conv(candidates=...)``: the ``compile_forward(use_tuned=True)``
   forward bitwise equal to the taps forward, the walker's launches of one
   forward counted from zero, both forwards timed in turns (median and
   range of 7 windows) and the lazy one split by a ``torch.profiler``
   trace; (c) ``autotune_model`` modelled, then ``measure=True``: each
   layer's modelled and measured pick with their measured times, both tuned
   forwards bitwise equal to the default, and the tuned model's oracle (K2
   at the tuned row blocks) within 1e-5; (d) ``VisionServer`` on a virtual
   clock, buckets 112 and 224, 4 slots, 12 requests of mixed sizes (the
   larger downscaled by ``fit_image``): 0 SLA misses, every output bitwise
   equal to the solo forward of its fitted image, the walker's launches of
   the served run counted from zero, the cross-request combine factor;
12. admission (the artifact verifier, ``repro_torch.analysis``), which
   launches no kernel: right after each LM build (``sparsify_model(...,
   strict=True)``), the leaves verified (0 diagnostics) and a default
   ``Scheduler`` admitted, timed, then a copy of layer 0's bf16 leaf dict
   with a non-zero tile at a -1 slot refused (``BS-PAD-VALS``); at the
   end, on a fresh VGG16: ``SMEM_BUDGET_BYTES`` equal to the card's
   per-block opt-in shared memory, ``build_sparse_chain(...,
   strict=True)`` for both patterns (0 diagnostics), ``verify_model(deep=
   True)`` of the served network (0 diagnostics), default ``VisionEngine``
   and ``VisionServer`` admitted, each timed, then a layer's cached
   ``DeviceSchedule`` with a chunk id of ``K // bk`` (``WL-STALE-CACHE``)
   and a packed conv whose card indices hold ``K // bk`` (``BS-RANGE``)
   refused by ``VisionEngine``; every refusal with ``AnalysisError`` and
   no kernel launched, and the network's output unchanged afterwards.

13. sparse SeamlessM4T-medium at full width and full depth (12 encoder +
   12 decoder layers, d_model 1024, d_ff 4096 relu, 16 heads of 64, vocab
   256206, untied head, bf16, density 0.35, 4 shards; ~0.88 B parameters)
   through ``generate``: 4 requests of 256 stub source frames (``0.02 *
   N(0, 1)`` from SEED) and a 16-token prompt, 32 new tokens each; K3's and
   K4's launches counted from zero (the encoder once, the decoder at the
   prefill and each decode step), tok/s on the host clock, every request's
   tokens bitwise equal to the request generated alone, the held step's
   captured prefill replayed by the second run; in fp32 the forward
   logits within 1e-5 of the forward with every encoder and decoder FFN on
   its densified weights, and ``prefill`` + ``decode_step`` within 1e-5 of
   the forward; K4 (relu) and K3 held to their plain versions as in phase 6
   at decode (4 rows), the decoder prefill (64) and the encoder prefill
   (1024);
14. sparse H2O-Danube3-4B at full width (fp32, 2 of 24 layers): one
   8192-token forward (twice the 4096 window) through the online-softmax
   attention in 1024-key chunks within 1e-5 of the dense masked forward,
   both timed (the second call) with their peak memory; K3 and K4 at 8192
   rows against their plain versions (fp32);
15. Moonlight-16B-A3B at full width (64 experts of d_ff 1408, top-6,
   capacity 1.25, bf16, 4 of 48 layers) through ``generate`` (4 requests
   of prompt 128, 32 new tokens; two runs bitwise equal), and layer 0's
   ``moe_ffn`` in fp32 over 512 tokens within 1e-5 of a plain per-expert
   oracle written here, with the same dropped assignments; tokens per
   expert and the placement imbalance over 4 shards before and after
   ``rebalance``;
16. one Mamba block of Jamba-1.5-large at full width (fp32, d_model 8192,
   din 16384): ``mamba_block(return_state=True)`` over 512 tokens (B = 2)
   and 8 ``mamba_decode`` steps within 1e-5 of one block over 520 tokens;
   then Jamba's smoke config on the card: ``prefill`` + ``decode_step``
   within 1e-5 of ``forward``, and a ``Scheduler`` run to completion;
17. sparse PaliGemma-3B at full width (bf16, 4 of 18 layers): a forward of
   256 stub patch embeddings (the bidirectional prefix) and 16 text tokens,
   4 images (1088 rows through K4's geglu epilogue), logits of the text
   rows only; in fp32 within 1e-5 of the densified-FFN forward; K4 (geglu)
   and K3 at decode and at 1088 rows against their plain versions.

18. sparse Yi-34B at full width (d_model 7168, d_ff 20480 swiglu, 56/8
   heads of 128, bf16, density 0.35, 4 of 60 layers; host packing seconds
   a layer printed): phase 6's K3/K4 checks at its decode and prefill
   shapes, then phase 7's traffic and checks through ``Scheduler``;
19. one full-width Arctic-480B layer (128 experts top-2 of d_ff 4864 and
   the shared dense FFN, bf16, ~27 GB of experts) through ``generate``: 4
   requests of prompt 128, 32 new tokens; the prompts' layer-0 expert load
   and its placement imbalance over 4 shards before and after
   ``rebalance``; the phase's peak memory.

20. training and the pruning pipeline on Qwen3-4B at full width (bf16,
   4 of 36 layers, ~0.79 B parameters; seq 256, batch 8, remat on): one
   step twice from one state bitwise equal (determinism); the captured
   step (``GraphedTrainStep``, one CUDA graph) bitwise equal to the eager
   donated step over 3 steps from one state; ``train`` (captured by
   default) 6 steps with a checkpoint every 3, then a fresh ``train`` to 9
   that resumes from step 6 (``opt.step`` 9), bitwise equal to 9 steps in
   one run; ``prune_masks`` at 0.35 and 3 captured fixed-mask steps
   bitwise equal to the eager ``apply_masks`` steps (every pruned weight
   exactly 0); ``save`` then ``restore`` into ``abstract_params``
   templates, bitwise (seconds and bytes); ``sparsify_model(strict=True)``
   of the restored weights served through ``Scheduler`` as in phase 7 and
   held to phase 8's fp32 oracle (K3 and K4 on the trained weights); the
   same batch 8 times at lr 1e-3, eager then captured (the same losses;
   the loss falls by more than 0.1), each step timed by CUDA events
   (median ms, tok/s, peak GiB; the graph's capture seconds and pool GiB)
   and one step of each traced (the card's idle share, the largest
   kernels); one full-width layer in fp32 (TF32 off, batch 2 x 64) against
   the same step in fp64 on the card (loss, grad norm, every gradient
   within 1e-5; the params after AdamW within 1e-5 plus lr x gradient
   error / eps; AdamW alone within 1e-5); last, the launcher's ``train``
   at all 36 layers, captured, for 5 steps (step ms and peak GiB; a depth
   that does not fit is printed and the next of 30, 24, 18 tried).
   Training launches none of the four kernels.

21. the mesh-sharded vision runtime (``repro_torch.vision.mesh``) on a
   VGG16 packed for MESH_DEVICES = 4 clusters (224 px, chunk pattern,
   seed 0; layers 8-13 carry the shard map ``[0, 1, 2, 3]``): (a) each of
   those layers walked per device through ``worklist_spmm_padded`` (K1
   over the device's local work list, one launch a device), the 4 devices
   one after another on the one card, on phase 3's 4 images; the slabs and
   occupancies concatenated in ring order bitwise equal to K1 over the
   whole list; each device's K1 ms, the whole list's, the per-shard steps,
   their imbalance and the time imbalance (max/mean - 1) of the four
   walks; (b) an NCCL world of one rank and ``data_mesh(1)``:
   ``graphed_forward(mesh=)`` on 4 images, ``VisionEngine(mesh=)`` on 8
   requests and ``VisionServer(mesh=)`` on 6, each bitwise equal to the
   solo eager forward, the walker's launches counted from zero and held
   exactly; (c) the replayed
   forward at local widths 8, 4, 2 and 1 (one rank's share of a batch of
   8 over D = 1, 2, 4, 8): ms and ``t(8) / t(8 / D)`` beside the
   step-count speed-up. One card: no traffic between cards, no speed-up
   claimed. The one-rank world stays up for phase 22.

22. sharded LM training (``repro_torch.launch.mesh``, DTensor params and
   moments) in phase 21's one-rank NCCL world, destroyed after it:
   Qwen3-4B at full width, LM_LAYERS layers, bf16, seq TRAIN_SEQ x batch
   TRAIN_BATCH, remat on, on ``make_debug_mesh(1, 1)`` with FSDP: (a)
   one eager sharded step bitwise equal to the solo step from the same
   params and batch, every leaf in its ``param_shardings`` /
   ``opt_shardings`` placements; (b) the captured sharded step over
   GRAPH_STEPS steps bitwise equal to the eager sharded step; (c) step
   ms, sharded against solo, graph and eager (CUDA events), with the
   card's idle share from one traced step each; (d) the mesh's state
   saved and restored solo bitwise, a solo save of its params the same
   bytes and restored onto the mesh bitwise (seconds, bytes); (e) the
   launcher under ``torch.distributed.run --nproc-per-node 1`` with
   ``--mesh 1,1 --fsdp`` (4 steps, its finish line). No kernel of the
   four runs on this path (the reference trains the dense model).

23. the sharded serve steps (the reference's dry-run serve step:
   ``make_prefill_fn`` and ``make_serve_step`` on DTensor params and a
   cache placed by ``cache_shardings``) in the same one-rank NCCL world,
   before it is destroyed: Qwen3-4B at full width (LM_LAYERS layers,
   bf16, dense) prefill of MESH_BATCH x LM_PROMPT (last logits, then the
   cache-writing prefill) and DECODE_STEPS greedy steps, eager and
   captured (``GraphedServeStep`` on the DTensors), tokens, logits and
   every cache leaf bitwise equal to solo, in their placements; decode
   step ms, sharded against solo, eager and graph, by CUDA events, with
   the idle share of one traced step each; RWKV6-3B (LM_LAYERS layers)
   and one full-width Jamba Mamba block, the sharded forward and
   FAMILY_STEPS decode steps bitwise equal to solo; one dry-run cell
   (``python -m repro_torch.launch.dryrun``, DRYRUN_CELL, on meta in a
   fake world of 256 ranks) on the card's host. None of the four kernels
   launches (``sharded_serve_steps_mesh``: 0 in each kernel's
   ``launches_by_path``).

24. the other Table-1 nets at full size and depth (TABLE1_NETS: AlexNet
   at 227 px and ResNet-18 at 224 px on the chunk pattern, ResNet-50 at
   224 px on the unstructured one), each through the paper's experiment
   ``examples/torch_sparse_cnn_sim.main``: built, ``oracle_check`` on one
   image (K2 once a layer, K1 never; rel err <= 1e-5 against
   ``dense_forward``, cuDNN, TF32 off; a non-zero output of the net's
   shape), the layer table against Table 1 and its Figure-7 row at the
   measured densities; then the compiled forward of 4 images (the eager
   closure, the graph's first call and a replay, bitwise equal; K1 3 x
   layers), ``VisionEngine`` on 8 staggered requests on 4 slots (outputs
   bitwise the solo forward; K1 (steps + 1) x layers) and the replayed
   forward against ``dense_forward`` (median of NET_WINDOWS windows).
   VGG16's row comes from phase 4's stats. K1/K2 against their plain
   versions (as phase 3) at AlexNet's 11x11 stride-4 stem and ResNet-50's
   1x1 layer 43 (2048 -> 512 on 7x7 maps). ResNet-50 on the chunk
   pattern (DEAD_NET: its one-tile layer 1 pruned away) through
   ``oracle_check`` alone, its output all zero. Last, the other examples
   in-process on the card: ``torch_quickstart`` (K4 then K3 once, within
   1e-5), ``torch_serve_batched --smoke --sparse`` (batch-composition
   check) and 4 pruned, checkpointed steps of ``torch_train_sparse_lm``.

Phase 24 runs right after phase 4, phases 13-19 between phases 10 and
11, phases 21 to 23 between 11 and the VGG16 half of 12, phase 20 last;
K3's and K4's ``launches_by_path`` gain the paths of 13, 14, 17, 18, 20
and 24, K1's and K2's those of 11, 21 and 24.

The serving and training paths run compiled, as the reference's
``jax.jit`` does: the LM decode step under ``Scheduler`` and ``generate``
replays a CUDA graph per batch width (greedy or sampled), their prefill
and admission one per prompt length, the FFN probe one per width, the
train step one per batch geometry, and ``VisionEngine`` and
``VisionServer`` replay the VGG16 forward captured per input shape
(``repro_torch.graphs``). Phases 4,
7, 10, 11(d), 13, 15, 18 and 19 run the graphed default and, once, the
eager path (``compiled=False``), and require their tokens or outputs
bitwise equal, and the launch counts exact: the eager launches plus the
replays times each graph's tally. Each LM phase also runs the decode step
in lockstep against ``decode_step`` (logits and tokens bitwise equal over
16 steps) and times 16 steps of each on the host clock and by CUDA events;
phase 4 times the replayed VGG16 forward against the eager one and
``dense_forward`` (in turns), phase 11 the lazy and taps forwards graph
against eager, each split by one ``torch.profiler`` trace with the card's
idle share.

Kernel and library times are device times, CUDA-graph replays of 20
calls (``graph_ms``); the plain versions, host loops, are timed by a loop
of calls (``cuda_ms``).

It prints the kernels line (JSON) and the card line before the last line,
and as the last line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FP32_FLOPS = 67e12        # H100 SXM fp32 without tensor cores
BF16_FLOPS = 989e12       # H100 SXM bf16 operands on the tensor cores, dense
HBM_BYTES = 3.35e12       # H100 SXM HBM3
TOL = 1e-5
SEED = 0
SIZE = 224
# Qwen3-4B serving: full width, depth cut to LM_LAYERS of 36 (host packing
# takes ~5 s per layer), the launcher's density and shards
LM_ARCH = "qwen3_4b"
RWKV_ARCH = "rwkv6_3b"      # the same cut: 4 of its 32 layers
LM_LAYERS = 4
LM_DENSITY = 0.35
LM_SHARDS = 4
MESH_DEVICES = 4            # phase 21: VGG16 packed for 4 clusters
LM_SLOTS, LM_REQUESTS, LM_PROMPT, LM_NEW, LM_STAGGER = 4, 8, 128, 32, 2
MODEL_NAMES = {"qwen3-4b": "Qwen3-4B", "rwkv6-3b": "RWKV6-3B",
               "seamless-m4t-medium": "SeamlessM4T-medium",
               "h2o-danube-3-4b": "H2O-Danube3-4B",
               "paligemma-3b": "PaliGemma-3B", "yi-34b": "Yi-34B"}
# phases 13-17, the remaining LM families (random weights from SEED)
SEAMLESS_ARCH = "seamless_m4t_medium"   # full width and depth
SEAMLESS_REQUESTS, SEAMLESS_FRAMES, SEAMLESS_PROMPT, SEAMLESS_NEW = \
    4, 256, 16, 32
DANUBE_ARCH, DANUBE_LAYERS = "h2o_danube_3_4b", 2        # of 24
DANUBE_TOKENS, DANUBE_FLASH = 8192, 1024                 # twice the window
MOE_ARCH, MOE_LAYERS = "moonshot_v1_16b_a3b", 4          # of 48
MOE_REQUESTS, MOE_PROMPT, MOE_NEW = 4, 128, 32
MOE_ORACLE_TOKENS, MOE_SHARDS = 512, 4
MAMBA_ARCH = "jamba_1_5_large_398b"     # one Mamba block at full width
MAMBA_BATCH, MAMBA_TOKENS, MAMBA_STEPS = 2, 512, 8
PALI_ARCH, PALI_LAYERS = "paligemma_3b", 4               # of 18
PALI_BATCH, PALI_TEXT = 4, 16
# phases 18-19, the owed full-width runs, through the replayed decode step
YI_ARCH, YI_LAYERS = "yi_34b", 4                          # of 60
ARCTIC_ARCH, ARCTIC_LAYERS = "arctic_480b", 1             # of 35
ARCTIC_REQUESTS, ARCTIC_PROMPT, ARCTIC_NEW = 4, 128, 32
# decode steps timed per model, graph against eager
DECODE_STEPS = 16
# phase 20, training and the pruning pipeline on Qwen3-4B (LM_LAYERS)
TRAIN_SEQ, TRAIN_BATCH = 256, 8
TRAIN_STEPS, TRAIN_RESUME, TRAIN_CKPT_EVERY, PRUNE_STEPS = 6, 9, 3, 3
DESCENT_STEPS, DESCENT_LR = 8, 1e-3
GRAPH_STEPS = 3                  # captured train step against eager
# the launcher's train at full depth (36 layers), captured; the depths
# tried in turn if one does not fit the card
FULL_DEPTHS, FULL_STEPS = (36, 30, 24, 18), 5
FP64_BATCH, FP64_SEQ = 2, 64                 # one full-width layer, fp32
# phase 22, sharded training on a one-rank mesh (phase 20's shape)
MESH_TIMED_STEPS = 6
# phase 23, the sharded serve steps on a one-rank mesh: Qwen3-4B (LM_LAYERS
# layers) prefill of MESH_BATCH x LM_PROMPT, then DECODE_STEPS steps;
# RWKV6-3B and a Jamba Mamba block, FAMILY_STEPS decode steps each
MESH_BATCH, FAMILY_STEPS, MAMBA_MESH_TOKENS = 4, 4, 64
DRYRUN_CELL = ("qwen3_4b", "decode_32k")
# phase 24, the other Table-1 nets at full size and depth: (bench, pattern,
# px). ResNet-50's chunk pattern prunes its one-tile layer 1 (1x1, 64 -> 64)
# away and every later map is zero, so its checks run on the unstructured
# pattern and the chunk net runs through oracle_check alone
NET_LABEL = {"VGGNet": "VGG16", "AlexNet": "AlexNet", "ResNet18": "ResNet-18",
             "ResNet50": "ResNet-50"}
TABLE1_NETS = (("AlexNet", "chunk", 227), ("ResNet18", "chunk", SIZE),
               ("ResNet50", "unstructured", SIZE))
DEAD_NET = ("ResNet50", "chunk", SIZE)
NET_WINDOWS = 5
# K1/K2 against their plain versions: AlexNet's 11x11 stride-4 stem and
# ResNet-50's first 1x1 layer with 2048 input channels (7x7 maps)
NET_KERNEL_LAYERS = {"AlexNet": (0,), "ResNet50": (43,)}


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


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph (after two calls of warm-up on the capturing stream), replayed
    ``replays`` times between CUDA events. A loop of calls (``cuda_ms``)
    also times the host's Python and launches, which at decode take as long
    as the kernel (0.05-0.09 ms a call) and made decode times jump between
    runs; the kernels and the library calls are timed so, the plain
    versions (host loops with syncs) by ``cuda_ms``. The captured launches
    go to a tally that is dropped: timing a kernel adds nothing to its
    launch count."""
    import torch
    from repro_torch.kernels._cuda import capture_tally
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
        g = torch.cuda.CUDAGraph()
        with capture_tally({}), torch.cuda.graph(g, stream=s):
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


def bound(flops: float, nbytes: float, peak: float = FP32_FLOPS):
    """The least time in ms for ``flops`` at ``peak`` FLOP/s and ``nbytes``
    at the HBM rate, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
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


# lint: ignore[EAGER-GUARD] builds its schedules eagerly, before any capture
def kernel_phase(model, imgs, layer: int, card: str):
    """Both kernels vs their plain versions at one layer; returns the two
    per-kernel records."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.sparse import resolve_pads
    from repro_torch.kernels.grid import ROW_BLOCK, ring_stages
    from repro_torch.kernels.sparse_conv import (conv_grid_geometry,
                                                 sparse_conv_spmm,
                                                 sparse_conv_spmm_plain)
    from repro_torch.kernels.worklist_core import (
        activation_occupancy, build_worklist, walk_mode, worklist_spmm,
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
    at = (f"{NET_LABEL.get(model.name, model.name)} layer {layer} "
          f"({c.kh}x{c.kw}x{c.cin}->{c.cout}"
          f"{', stride %d' % lay.stride[0] if lay.stride[0] > 1 else ''}), "
          f"{B} images, {imgs.shape[1]} px, {c.pattern} pattern, "
          f"bk={w.bk} bn={w.bn}")
    tag = f"[{card}]"

    # yardstick: one dense cuDNN conv of the same layer, TF32 off (the
    # layer's stride and pads; an odd SAME pad split pre-pads x once)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    xn = x.permute(0, 3, 1, 2).contiguous()
    wd = torch.as_tensor(c.w_dense, device=x.device).permute(3, 2, 0, 1) \
        .contiguous()
    (ph0, ph1), (pw0, pw1) = resolve_pads(tuple(xn.shape[2:]), c.kh, c.kw,
                                          lay.stride, lay.padding)
    if (ph0, pw0) != (ph1, pw1):
        xn = F.pad(xn, (pw0, pw1, ph0, ph1))
        ph0 = pw0 = 0
    lib_ms = graph_ms(lambda: F.conv2d(xn, wd, stride=lay.stride,
                                       padding=(ph0, pw0)), reps=10)

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
    k1_ms = graph_ms(lambda: worklist_spmm(flat, w.vals, wl, mb_per_img=mpi,
                                          ncolors=2, **kw1), reps=20)
    p1_ms = cuda_ms(lambda: worklist_spmm_plain(flat, w.vals, wl, **kw1),
                    reps=5)
    # the walker reads the used chunks of every real row (it has no
    # occupancy input), the stored weights and its schedule
    bytes1 = 4.0 * (rows * w.bk * used.size + stored * w.bk * w.bn
                    + wl.num_steps * 2 + wl.num_pairs + 1) + out_bytes
    b1, by1 = bound(flops, bytes1)
    # the gap to the bound: the sub_m-row terms the pack-time list schedules
    # (every row block, live or not), the share of them that are zero in x
    # (which the tile mode's warps skip where their band is zero), and
    # their FMA roof
    terms = wl.mac_steps * bm_rows // sub_m
    zero_share = 1.0 - live_macs / terms
    roof1 = 2.0 * sub_m * w.bk * w.bn * terms / FP32_FLOPS * 1e3

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
    require(torch.equal(out2, out),
            f"dense grid != walker bitwise at layer {layer}")
    k2_ms = graph_ms(lambda: sparse_conv_spmm(flat, w.indices, w.vals, **kw2),
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

    # the launches: the walker's tile mode (CTA tiles of a pair); the grid
    # conv's CTAs, busy where some sub-block of their rows is occupied in a
    # stored chunk
    g2 = conv_grid_geometry(M, w.n_blocks, bm_rows=bm_rows, bn=w.bn)
    stored_occ = occ_in[:, torch.as_tensor(used, device=occ_in.device)]
    busy = int(stored_occ.reshape(-1, ROW_BLOCK // sub_m, used.size)
               .any(2).any(1).sum()) * w.n_blocks * g2.groups
    wide2, one2 = ring_stages(4, g2.col_group, w.bk)
    grid1 = walk_mode(flat, w.vals, None, wl, bk=w.bk, bn=w.bn,
                      bm_rows=bm_rows).describe()
    grid2 = (f"{g2.blocks} CTAs of 64 threads, {busy} busy, "
             f"{g2.col_group}-column groups, ring {wide2} whole-chunk "
             f"stages ({one2} in the one-tile layout)")
    print(f"kernels @ {at} {tag}")
    print(f"  walker:     max abs err {abs1:.3e}, max rel err {rel1:.3e}, "
          f"occupancy equal, batch == per-image bitwise; {wl.mac_steps} live "
          f"steps of {wl.num_steps}, {live_macs} live sub-block MACs; "
          f"{terms} executed {sub_m}-row terms, {zero_share:.4f} of them "
          f"zero in x; {grid1}; kernel {k1_ms:.4f} ms, plain "
          f"{p1_ms:.4f} ms, bound {b1:.4f} ms ({by1}), FMA roof of the "
          f"executed terms {roof1:.4f} ms, dense conv2d {lib_ms:.4f} ms")
    print(f"  dense grid: max abs err {abs2:.3e}, max rel err {rel2:.3e}, "
          f"occupancy and counts equal, bitwise equal to the walker; "
          f"{executed} sub-block MACs; {grid2}; kernel "
          f"{k2_ms:.4f} ms, plain {p2_ms:.4f} ms, bound {b2:.4f} ms ({by2}),"
          f" dense conv2d {lib_ms:.4f} ms")

    def rec(abs_, rel, k, p, b, by, grid, mode):
        return {"at": at, "mode": mode, "max_abs_err": abs_,
                "max_rel_err": rel, "ms": k, "plain_ms": p, "bound_ms": b,
                "bound_by": by, "library_ms": lib_ms, "grid": grid}
    return rec(abs1, rel1, k1_ms, p1_ms, b1, by1, grid1, "tile"), \
        rec(abs2, rel2, k2_ms, p2_ms, b2, by2, grid2, "grid")


def trace_kernels(fn):
    """[(name, device ms)] of the card's activity during one call of
    ``fn``, traced by ``torch.profiler`` (CUPTI; the second of two traces,
    the first pays the profiler's set-up). The program's spans
    (:mod:`repro_torch.obs`) reach the card's row as user annotations
    and are left out: they are ranges of the host, not work of the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in
            prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def by_name(kernels):
    """{name: (launches, ms)} of a trace."""
    out = {}
    for n, t in kernels:
        k, ms = out.get(n, (0, 0.0))
        out[n] = (k + 1, ms + t)
    return out


def forward_trace(fn):
    """One traced call of ``fn`` (:func:`trace_kernels`): the walker's
    launches in order, pooling, every other kernel by name (launches, ms)
    and the card's busy ms."""
    kernels = trace_kernels(fn)
    other = by_name((n, t) for n, t in kernels
                    if "tile_kernel" not in n and "max_pool" not in n)
    return {"walker": [t for n, t in kernels if "tile_kernel" in n],
            "pool": sum(t for n, t in kernels if "max_pool" in n),
            "other": other, "busy": sum(t for _, t in kernels),
            "kernels": len(kernels)}


def forwards_compared(fns, x0, card: str, windows: int = 7, calls: int = 5,
                      traced=None, net: str = "VGG16"):
    """Phases 4, 11 and 24: the ``net`` forwards ``fns`` ({name: fn(x)}) timed in
    turns, ``windows`` CUDA-event windows of ``calls`` calls each (median
    and range), and those named in ``traced`` split by one
    ``torch.profiler`` trace: the walker by layer, pooling, the other
    kernels by name, and the card's idle ms and share of the median (the
    host's gaps). Returns {name: record}."""
    import torch
    for f in fns.values():
        f(x0)
    wins = {name: [] for name in fns}
    for _ in range(windows):
        for name, f in fns.items():
            wins[name].append(cuda_ms(lambda: f(x0), reps=calls, warmup=0))
    B = x0.shape[0]
    out = {}
    for name, w in wins.items():
        med = float(np.median(w))
        require(all(np.isfinite(w)), f"forward {name}: a time is not finite")
        torch_sync()
        torch.cuda.reset_peak_memory_stats()
        fns[name](x0)
        torch_sync()
        peak = torch.cuda.max_memory_allocated() / 2**30
        pools = [g.pool_bytes for g in
                 getattr(fns[name], "graphs", {}).values()]
        rec = {"forward_ms": med, "forward_ms_range": [min(w), max(w)],
               "img_per_s": B / med * 1e3, "peak_gib": peak, "card": card}
        pool = f" (its graph's pool {pools[0] / 2**30:.3f} GiB reserved " \
            f"beside)" if pools else ""
        if pools:
            rec["pool_gib"] = pools[0] / 2**30
        print(f"{net} forward, {B} images at {x0.shape[1]} px, {name}: "
              f"median {med:.4f} ms (range {min(w):.4f}-{max(w):.4f}; "
              f"{B / med * 1e3:.2f} img/s) of {windows} windows of {calls} "
              f"calls in turns; peak memory allocated during a call "
              f"{peak:.3f} GiB{pool} [{card}]")
        if name in (traced or ()):
            t = forward_trace(lambda: fns[name](x0))
            if not t["kernels"]:
                print(f"  {name} split: the profiler saw no kernel on the "
                      f"card (not measured)")
            else:
                idle = med - t["busy"]
                rest = sum(ms for _, ms in t["other"].values())
                rec.update({"walker_ms_by_layer": t["walker"],
                            "pool_ms": t["pool"], "busy_ms": t["busy"],
                            "idle_ms": idle, "idle_share": idle / med,
                            "other_kernels_ms": {n: ms for n, (_, ms) in
                                                 t["other"].items()}})
                print(f"  {name} split of one traced forward "
                      f"(torch.profiler, kernel device times): walker "
                      f"{sum(t['walker']):.4f} ms ({len(t['walker'])} "
                      f"launches), pooling {t['pool']:.4f} ms, other "
                      f"kernels {rest:.4f} ms; the card busy "
                      f"{t['busy']:.4f} ms, idle {idle:.4f} ms "
                      f"({idle / med:.1%}) of the median")
                print("  walker by layer (ms): " + ", ".join(
                    f"L{i} {ms:.4f}" for i, ms in enumerate(t["walker"])))
                print("  other kernels (launches, ms): " + "; ".join(
                    f"{n[:60]} ({k}, {ms:.4f})" for n, (k, ms) in
                    sorted(t["other"].items(), key=lambda kv: -kv[1][1])))
        out[name] = rec
    return out


def forward_split(model, imgs, card: str):
    """Phase 4's timing of one VGG16 forward of ``imgs`` (the engine's
    path): the replayed graph (the default) against the eager forward and
    ``dense_forward`` (cuDNN, TF32 off), the first two traced. Returns the
    record."""
    import torch
    from repro_torch.vision import (compile_forward, dense_forward,
                                    graphed_forward)
    torch.backends.cudnn.allow_tf32 = False
    x0 = torch.as_tensor(imgs, device=model.device)
    recs = forwards_compared(
        {"graph (taps)": graphed_forward(model),
         "eager (taps)": compile_forward(model),
         "dense_forward (cuDNN, TF32 off)":
             lambda x: dense_forward(model, x)},
        x0, card, traced=("graph (taps)", "eager (taps)"))
    return {"images": x0.shape[0], **recs}


def drive(card: str):
    """Phases 3 and 4 on the card; returns the kernels-line records and the
    chunk net's per-layer stats."""
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
        if pattern == "chunk":
            chunk_stats = stats
    reqs = [ImageRequest(rid=i, image=imgs[i], arrival=i // 3)
            for i in range(8)]
    grid_launches = CONV_GRID.launches
    engines = {}
    for compiled in (True, False):
        WALK.launches = 0
        eng = VisionEngine(chunk, num_slots=4, compiled=compiled)
        engines[compiled] = (eng, eng.run(reqs))
        torch.cuda.synchronize()
        engines[compiled] += (WALK.launches,)
    eng, produced, walker = engines[True]
    eager_eng, eager_out, eager_walker = engines[False]
    launches = {"walker": walker, "grid": grid_launches}
    st = eng.stats
    forwards = st.engine_steps + 1                     # + the warm-up
    print(f"engine: {st.images} images on 4 slots in {st.engine_steps} "
          f"steps, {st.wall_s:.4f} s, {st.img_per_s:.2f} img/s steady on "
          f"the replayed forward (first call and capture "
          f"{st.compile_s:.2f} s, util {st.slot_utilization:.2f}); eager "
          f"{eager_eng.stats.wall_s:.4f} s, "
          f"{eager_eng.stats.img_per_s:.2f} img/s [{card}]")
    print(f"main-path launches: walker {walker} ({walker / forwards:.0f} "
          f"per engine forward: {chunk.num_layers} eager at the warm-up + "
          f"{st.engine_steps} replays x {chunk.num_layers}; the eager "
          f"engine {eager_walker}), dense grid {launches['grid']}")
    require(walker == forwards * chunk.num_layers == eager_walker,
            f"the engine launched the walker {walker} times (eager "
            f"{eager_walker}), expected {forwards * chunk.num_layers}")
    require(launches["grid"] > 0, "oracle_check never launched the grid")
    solo = compile_forward(chunk)
    for r in reqs:
        one = solo(torch.as_tensor(r.image[None], device=dev))[0]
        got = produced[r.rid]
        require(got.shape == out_shape and np.isfinite(got).all(),
                f"request {r.rid}: bad output")
        require(np.array_equal(got, one.cpu().numpy()) and
                np.array_equal(got, eager_out[r.rid]),
                f"request {r.rid}: engine output != solo eager forward")
    print(f"engine outputs (graph and eager) bitwise equal to the solo "
          f"eager forward ({len(reqs)} requests)")
    split = forward_split(chunk, imgs[:4], card)

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
    kernels[0]["vgg16_forward"] = split
    return kernels, chunk_stats


def bf16_ulps(got, ref):
    """Per-element distance in bf16 ulps: the number of bf16 values
    between the two (+0 and -0 are one value)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(got) - ordered(ref)).abs()


def check_bf16(name, kb, pb, k32, p32):
    """bf16 outputs ``kb`` (kernel) and ``pb`` (plain) against the same
    functions' fp32 outputs ``k32``/``p32`` on the same (widened) inputs.

    Both versions widen bf16 to fp32, sum in fp32 and round once, so each
    bf16 output must be the bf16 rounding of its own fp32 output, bit for
    bit. Two fp32 sums within one bf16 ulp of each other round at most one
    ulp apart; an element further apart is one where the two fp32 sum orders
    already differ by an ulp or more (a nearly cancelled sum), which the
    fp32 gate bounds. Returns (worst ulps, elements beyond one ulp)."""
    import torch
    require(torch.equal(kb, k32.to(torch.bfloat16)),
            f"{name}: bf16 kernel output is not the rounding of its fp32 sums")
    require(torch.equal(pb, p32.to(torch.bfloat16)),
            f"{name}: bf16 plain output is not the rounding of its fp32 sums")
    u = bf16_ulps(kb, pb)
    over = u > 1
    # one ulp at pb: the gap from |pb| to the next bf16 value up
    mag = pb.abs()
    step = (mag.view(torch.int16) + 1).view(torch.bfloat16).float() \
        - mag.float()
    explained = (k32 - p32).abs() >= 0.5 * step
    require(bool(explained[over].all()),
            f"{name}: {int((over & ~explained).sum())} elements beyond one "
            f"bf16 ulp whose fp32 sums agree within an ulp")
    return int(u.max()), int(over.sum())


def ulp_note(ulps) -> str:
    if ulps is None:
        return ""
    worst, over = ulps
    return (f", worst {worst} bf16 ulp ({over} elements beyond 1, all "
            f"nearly cancelled fp32 sums)")


def ffn_kernel_phase(params, cfg, card,
                     regimes=(("decode", LM_SLOTS), ("prefill", LM_PROMPT)),
                     stack="blocks", dtypes=("float32", "bfloat16")):
    """Phases 6, 10, 13, 14 and 17: the predicated sparse matmul (K3) and
    the fused FFN (K4) against their plain versions at layer 0's packed
    weights of ``params[stack]`` (Qwen3-4B's gated FFN, RWKV6-3B's relu2
    channel-mix, seamless's relu FFN, danube's swiglu, PaliGemma's geglu)
    for each (regime, live rows) in ``regimes`` (rows padded to whole
    128-row blocks) and each of ``dtypes``; returns the per-regime records
    of both kernels."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitmask_spmm import (bitmask_spmm,
                                                  bitmask_spmm_plain)
    from repro_torch.kernels.grid import grid_geometry, sm_count
    from repro_torch.kernels.fused_ffn import (fused_ffn_spmm,
                                               fused_ffn_spmm_plain)
    from repro_torch.sparsity.sparse_ffn import densify
    torch.backends.cuda.matmul.allow_tf32 = False
    _, leaf = sparse_leaf(params[stack][0]["p0"])
    sp = params[stack][0]["p0"][leaf]
    gated = "gate_indices" in sp
    dev = sp["in_vals"].device
    chunk, sub_m, bm = 128, 8, 128
    nb_in, mnz = sp["in_indices"].shape
    nb_out, mnz_out = sp["out_indices"].shape
    D, Fp = cfg.d_model, nb_in * chunk
    Dp = nb_out * chunk
    gen = torch.Generator(device=dev).manual_seed(SEED)
    streams = ("in", "gate") if gated else ("in",)

    w_lib = {"in_gate": torch.cat([densify(sp, r, D, chunk) for r in streams],
                                  1),
             "out": densify(sp, "out", Fp, chunk)}
    recs = {"k3": [], "k4": []}
    for regime, rows in regimes:
        Mp = -(-rows // bm) * bm
        # the launch geometry: blocks, and the busy ones (those of the
        # 32-row tiles holding live rows); the gated FFN runs CTA pairs
        grids = {}
        for key, nb in (("k4", nb_in), ("k3", nb_out)):
            g = grid_geometry(Mp, nb, bm=bm, bn=chunk, sms=sm_count(dev))
            pairs = 2 if key == "k4" and gated else 1
            busy = nb * g.groups * pairs * -(-rows // 32)
            grids[key] = (f"{g.blocks * pairs} CTAs of 64 threads, {busy} "
                          f"busy{' at decode' if rows <= 32 else ''}, "
                          f"{g.col_group}-column groups")
        x16 = torch.zeros((Mp, D), dtype=torch.bfloat16, device=dev)
        x16[:rows] = torch.randn((rows, D), generator=gen, device=dev) \
            .to(torch.bfloat16)
        for dtype in (getattr(torch, d) for d in dtypes):
            tag = (f"{regime} ({rows} live rows of {Mp}), "
                   f"{str(dtype).split('.')[-1]}")
            v = {k: (t.to(dtype) if t.is_floating_point() else t)
                 for k, t in sp.items()}
            x = x16.to(dtype)
            kw4 = dict(act=cfg.act, bk=chunk, bn=chunk, bm=bm, sub_m=sub_m,
                       two_sided=True)
            args4 = (x, v["in_indices"], v["in_vals"], v.get("gate_indices"),
                     v.get("gate_vals"))
            h = fused_ffn_spmm(*args4, **kw4)
            ph = fused_ffn_spmm_plain(*args4, **kw4)
            torch_sync()
            require(bool((h[rows:] == 0).all()),
                    f"K4 {tag}: padded rows are not exact zeros")
            if dtype == torch.float32:
                h32, ph32 = h, ph
                # K3's input in both types: K4's output rounded to bf16
                h16 = ph.to(torch.bfloat16)
            kw3 = dict(bk=chunk, bn=chunk, bm=bm, sub_m=sub_m,
                       two_sided=True, count_macs=True)
            args3 = (h16.to(dtype), v["out_indices"], v["out_vals"])
            o, cnt = bitmask_spmm(*args3, **kw3)
            po, pcnt = bitmask_spmm_plain(*args3, **kw3)
            torch_sync()
            require(torch.equal(cnt, pcnt), f"K3 {tag}: MAC counts differ")
            stats3 = ops.sparse_matmul_tile_stats(
                args3[0], v["out_indices"], k_total=Fp, bk=chunk,
                sub_m=sub_m)
            require(int(cnt.sum()) == int(stats3["executed"]),
                    f"K3 {tag}: counted {int(cnt.sum())} sub-block MACs, the "
                    f"occupancy gives {int(stats3['executed'])}")
            ulps = {}
            if dtype == torch.float32:
                a4, r4 = errors(h, ph)
                a3, r3 = errors(o, po)
                require(r4 <= TOL, f"K4 {tag}: rel err {r4:.3e}")
                require(r3 <= TOL, f"K3 {tag}: rel err {r3:.3e}")
                o32, po32 = o, po
            else:
                a4, r4 = errors(h.float(), ph.float())
                a3, r3 = errors(o.float(), po.float())
                ulps["k4"] = check_bf16(f"K4 {tag}", h, ph, h32, ph32)
                ulps["k3"] = check_bf16(f"K3 {tag}", o, po, o32, po32)
            # each row alone, at row 0 of an otherwise zero block
            for i in range(min(rows, LM_SLOTS)):
                xi = torch.zeros_like(x)
                xi[0] = x[i]
                hi = fused_ffn_spmm(xi, *args4[1:], **kw4)
                require(torch.equal(hi[0], h[i]),
                        f"K4 {tag}: row {i} alone != row {i} in the block")
                hi = torch.zeros_like(args3[0])
                hi[0] = args3[0][i]
                oi = bitmask_spmm(hi, *args3[1:], **kw3)[0]
                require(torch.equal(oi[0], o[i]),
                        f"K3 {tag}: row {i} alone != row {i} in the block")
            eb = x.element_size()

            # the bound: live sub-block MACs, each input read once
            stats4 = [ops.sparse_matmul_tile_stats(
                x, v[f"{r}_indices"], k_total=D, bk=chunk, sub_m=sub_m)
                for r in streams]
            flops4 = 2.0 * sub_m * chunk * chunk * sum(
                float(s["executed"]) for s in stats4)
            stored4 = sum(int((v[f"{r}_indices"] >= 0).sum())
                          for r in streams)
            bytes4 = (eb * (rows * D + stored4 * chunk * chunk + rows * Fp)
                      + 4.0 * (len(streams) * nb_in * mnz
                               + Mp // sub_m * D // chunk))
            flops3 = 2.0 * sub_m * chunk * chunk * float(stats3["executed"])
            stored3 = int((v["out_indices"] >= 0).sum())
            bytes3 = (eb * (rows * Fp + stored3 * chunk * chunk + rows * Dp)
                      + 4.0 * (nb_out * mnz_out + Mp // sub_m * Fp // chunk
                               + nb_out))
            # the function's peak for its operand type: bf16 products are
            # exact in fp32, so bf16 tiles could run on the tensor cores
            peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
            b4, by4 = bound(flops4, bytes4, peak)
            b3, by3 = bound(flops3, bytes3, peak)
            k4_ms = graph_ms(lambda: fused_ffn_spmm(*args4, **kw4), reps=20)
            p4_ms = cuda_ms(lambda: fused_ffn_spmm_plain(*args4, **kw4),
                            reps=5)
            wl4 = w_lib["in_gate"].to(dtype)
            l4_ms = graph_ms(lambda: torch.matmul(x, wl4), reps=20)
            k3_ms = graph_ms(lambda: bitmask_spmm(*args3, **kw3), reps=20)
            p3_ms = cuda_ms(lambda: bitmask_spmm_plain(*args3, **kw3),
                            reps=5)
            wl3 = w_lib["out"].to(dtype)
            l3_ms = graph_ms(lambda: torch.matmul(args3[0], wl3), reps=20)
            at = (f"{MODEL_NAMES.get(cfg.name, cfg.name)} "
                  f"{'encoder ' if stack == 'enc_blocks' else ''}layer 0 "
                  f"{'channel-mix' if leaf == 'channel_mix_sparse' else 'FFN'}"
                  f", "
                  f"{tag}, bk=bn={chunk} sub_m={sub_m}, density "
                  f"{LM_DENSITY}")
            print(f"FFN kernels @ {at} [{card}]")
            print(f"  fused FFN (K4, {cfg.act}): max abs err {a4:.3e}, max "
                  f"rel err {r4:.3e}{ulp_note(ulps.get('k4'))}; pad rows "
                  f"exact zeros; rows independent; kernel {k4_ms:.4f} ms "
                  f"({grids['k4']}), plain {p4_ms:.4f} ms, bound {b4:.4f} "
                  f"ms ({by4}), matmul [W_in{'|W_gate' if gated else ''}] "
                  f"{l4_ms:.4f} ms (no activation)")
            print(f"  sparse matmul (K3): max abs err {a3:.3e}, max rel err "
                  f"{r3:.3e}{ulp_note(ulps.get('k3'))}; counts equal "
                  f"({int(cnt.sum())} sub-block MACs); rows independent; "
                  f"kernel {k3_ms:.4f} ms ({grids['k3']}), plain "
                  f"{p3_ms:.4f} ms, bound {b3:.4f} ms ({by3}), matmul "
                  f"{l3_ms:.4f} ms")

            def rec(a, r, k, p, b, by, lib, u):
                return {"at": at, "max_abs_err": a, "max_rel_err": r,
                        "bf16_worst_ulps": u[0] if u else None, "ms": k,
                        "plain_ms": p, "bound_ms": b, "bound_by": by,
                        "library_ms": lib}
            recs["k4"].append(rec(a4, r4, k4_ms, p4_ms, b4, by4, l4_ms,
                                  ulps.get("k4")))
            recs["k3"].append(rec(a3, r3, k3_ms, p3_ms, b3, by3, l3_ms,
                                  ulps.get("k3")))
    return recs


def sparse_leaf(bp):
    """(dense key, packed key) of a block's FFN: a transformer block's
    ``ffn`` or an RWKV block's ``channel_mix``."""
    return ("ffn", "ffn_sparse") if "ffn_sparse" in bp \
        else ("channel_mix", "channel_mix_sparse")


def ffn_counts(reset: bool = False):
    """K3's and K4's launch counters ({"k3": n, "k4": n}); ``reset`` sets
    both to 0 first."""
    from repro_torch.kernels.bitmask_spmm import BITMASK_SPMM
    from repro_torch.kernels.fused_ffn import FUSED_FFN
    if reset:
        BITMASK_SPMM.launches = FUSED_FFN.launches = 0
    return {"k3": BITMASK_SPMM.launches, "k4": FUSED_FFN.launches}


def dense_size(tree):
    """(parameters, bytes) of a params tree, its packed FFN leaves (copies
    of the dense weights) left out."""
    if isinstance(tree, dict):
        parts = [dense_size(v) for k, v in tree.items()
                 if not k.endswith("_sparse")]
    elif isinstance(tree, list):
        parts = [dense_size(v) for v in tree]
    else:
        return tree.numel(), tree.numel() * tree.element_size()
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def build_family(dev, arch, *, layers=None, dtype=None, sparse=True):
    """A model of ``arch`` at full width from SEED, depth cut to ``layers``
    (None: full depth), optionally in ``dtype``; with ``sparse`` every FFN
    (the encoder's too) packed at LM_DENSITY with strict=True."""
    import dataclasses
    from repro_torch.configs import load_config
    from repro_torch.models import model as M
    from repro_torch.sparsity.sparse_ffn import sparsify_model
    full = load_config(arch)
    cfg = dataclasses.replace(
        full, n_layers=layers or full.n_layers, dtype=dtype or full.dtype,
        sparse_ffn=sparse or full.sparse_ffn)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev)
    torch_sync()
    t1 = time.perf_counter()
    if sparse:
        params = sparsify_model(params, cfg, density=LM_DENSITY,
                                num_shards=LM_SHARDS, strict=True)
        torch_sync()
    n, nbytes = dense_size(params)
    enc = f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else ""
    pack_s = time.perf_counter() - t1
    n_ffn = cfg.n_layers + cfg.encoder_layers
    print(f"built {full.name} ({cfg.family}): d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff} {cfg.act}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, vocab {cfg.vocab} (padded {cfg.padded_vocab}), "
          f"{cfg.dtype}; {cfg.n_layers}{enc} of {full.n_layers}{enc} layers;"
          f" {n / 1e9:.3f} B parameters, {nbytes / 1e9:.3f} GB; init "
          f"{t1 - t0:.1f} s" + (f", host packing with strict=True "
                                f"{pack_s:.1f} s = {pack_s / n_ffn:.2f} s a "
                                f"layer (density {LM_DENSITY}, {LM_SHARDS} "
                                f"shards)" if sparse else ""))
    return cfg, params


def build_lm(dev, arch=LM_ARCH):
    """A sparse LM at full width, bf16, depth cut to LM_LAYERS."""
    cfg, params = build_family(dev, arch, layers=LM_LAYERS)
    src, leaf = sparse_leaf(params["blocks"][0]["p0"])
    sp = params["blocks"][0]["p0"][leaf]
    print(f"  {'+'.join(cfg.block_pattern)} blocks, layer 0 {src}: in"
          f"{'/gate' if 'gate_indices' in sp else ''} indices "
          f"{list(sp['in_indices'].shape)}, out indices "
          f"{list(sp['out_indices'].shape)}")
    return cfg, params


def refused(make, rule: str) -> float:
    """Seconds until ``make()`` is refused with ``AnalysisError`` naming
    ``rule``; fails if it is admitted or refused for another reason."""
    from repro_torch.analysis import AnalysisError
    t0 = time.perf_counter()
    try:
        make()
    except AnalysisError as e:
        rules = {d.rule for d in e.diags}
        require(rule in rules, f"refused with {sorted(rules)}, not {rule}")
        return time.perf_counter() - t0
    raise SmokeFailure(f"a corrupt artifact ({rule}) was admitted")


def lm_admission_phase(cfg, params, card):
    """Phase 12, LM half: the strict-packed leaves verify clean, a default
    ``Scheduler`` admits them, and a copy of layer 0's leaf dict with a
    non-zero tile at a -1 slot is refused before any launch."""
    from repro_torch.analysis import render_text, verify_param_leaves
    from repro_torch.kernels.bitmask_spmm import BITMASK_SPMM
    from repro_torch.kernels.fused_ffn import FUSED_FFN
    from repro_torch.serve import Scheduler
    max_len = LM_PROMPT + LM_NEW
    torch_sync()
    t0 = time.perf_counter()
    diags = verify_param_leaves(params, d_model=cfg.d_model)
    torch_sync()
    t_verify = time.perf_counter() - t0
    require(not diags, f"{cfg.name} leaves: {render_text(diags)}")
    BITMASK_SPMM.launches = FUSED_FFN.launches = 0
    t0 = time.perf_counter()
    Scheduler(cfg, params, num_slots=LM_SLOTS, max_len=max_len)
    torch_sync()
    t_admit = time.perf_counter() - t0
    bp = params["blocks"][0]["p0"]
    _, leaf = sparse_leaf(bp)
    sp = dict(bp[leaf])
    idx = sp["in_indices"].clone()
    require(int(idx[0, -1]) >= 0 and bool(sp["in_vals"][0, -1].ne(0).any()),
            "layer 0's last in slot of n-block 0 holds no live tile")
    idx[0, -1] = -1                  # the slot's non-zero tile stays
    sp["in_indices"] = idx
    blocks = [dict(params["blocks"][0], p0=dict(bp, **{leaf: sp}))] + \
        params["blocks"][1:]
    t_bad = refused(lambda: Scheduler(cfg, dict(params, blocks=blocks),
                                      num_slots=LM_SLOTS, max_len=max_len),
                    "BS-PAD-VALS")
    launched = BITMASK_SPMM.launches + FUSED_FFN.launches
    require(launched == 0, f"admission launched {launched} kernels")
    print(f"admission {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}): "
          f"verify_param_leaves {t_verify:.4f} s (0 diagnostics), default "
          f"Scheduler constructed in {t_admit:.4f} s, a {cfg.dtype} leaf "
          f"copy with a non-zero tile at a -1 slot refused (BS-PAD-VALS) "
          f"in {t_bad:.4f} s, 0 kernel launches [{card}]")


def vgg16_filters():
    """The dense VGG16 filters ``build_vision_model`` draws for SEED."""
    from repro_torch.core import simulator as S
    rng = np.random.default_rng(SEED)
    return [(rng.normal(size=(s.k, s.k, s.d, s.n))
             * np.sqrt(2.0 / (s.k * s.k * s.d))).astype(np.float32)
            for s in S.BENCHMARKS["VGGNet"].layers]


def vision_admission_phase(card, dev):
    """Phase 12, vision half, on a fresh VGG16 (chunk pattern, 224 px):
    the card's budget, strict packing, the deep verify of the served
    network, the default engine and server admitted, and two corrupt
    artifacts refused before any launch."""
    import dataclasses
    import torch
    from repro_torch.analysis import (SMEM_BUDGET_BYTES, render_text,
                                      verify_model)
    from repro_torch.core import simulator as S
    from repro_torch.kernels.sparse_conv import CONV_GRID
    from repro_torch.kernels.worklist_core import WALK
    from repro_torch.launch.vision import blob_images
    from repro_torch.serve.vision import VirtualClock, VisionServer
    from repro_torch.sparsity.conv import build_sparse_chain
    from repro_torch.vision import (VisionEngine, build_vision_model,
                                    compile_forward)
    optin = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    require(SMEM_BUDGET_BYTES == optin,
            f"SMEM_BUDGET_BYTES {SMEM_BUDGET_BYTES} != the card's "
            f"{optin} bytes a block")
    print(f"admission: SMEM_BUDGET_BYTES {SMEM_BUDGET_BYTES} == "
          f"shared_memory_per_block_optin {optin} [{card}]")
    density = S.BENCHMARKS["VGGNet"].filter_density
    chains = {}
    for pattern in ("chunk", "unstructured"):
        t0 = time.perf_counter()
        chains[pattern] = build_sparse_chain(vgg16_filters(), density=density,
                                             pattern=pattern, strict=True,
                                             device=dev)
        torch_sync()
        print(f"admission: build_sparse_chain(strict=True) VGG16 "
              f"{pattern}: {len(chains[pattern])} layers, 0 diagnostics, "
              f"{time.perf_counter() - t0:.3f} s packing and verifying "
              f"[{card}]")
    model = build_vision_model("VGGNet", pattern="chunk", seed=SEED,
                               device=dev)
    require(all(np.array_equal(a.packed.host_indices(),
                               layer.conv.packed.host_indices())
                for a, layer in zip(chains["chunk"], model.layers)),
            "the strict chain differs from build_vision_model's")
    imgs = blob_images(np.random.default_rng(SEED), 4, SIZE,
                       S.BENCHMARKS["VGGNet"].map_density)
    x = torch.as_tensor(imgs, device=dev)
    out = compile_forward(model)(x)   # caches each layer's schedule on card
    torch_sync()
    t0 = time.perf_counter()
    diags = verify_model(model, deep=True)
    torch_sync()
    t_deep = time.perf_counter() - t0
    require(not diags, f"VGG16: {render_text(diags)}")
    copies = sum(len(wl._device) for layer in model.layers
                 for wl in layer.conv.wl_cache.values())
    WALK.launches = CONV_GRID.launches = 0
    t0 = time.perf_counter()
    VisionEngine(model, num_slots=4)
    t_engine = time.perf_counter() - t0
    t0 = time.perf_counter()
    VisionServer(model, num_slots=4, buckets=(112, 224),
                 clock=VirtualClock(), step_cost_s={112: 0.01, 224: 0.03})
    t_server = time.perf_counter() - t0

    # a device schedule the walker would read out of range
    conv = model.layers[8].conv
    kb = conv.packed.shape[0] // conv.packed.bk
    wl = next(iter(conv.wl_cache.values()))
    good = wl.on_device(x.device)     # the copy the forward's walker read
    key = str(x.device)
    bad_k = good.k.clone()
    bad_k[int(np.nonzero(wl.k >= 0)[0][0])] = kb
    # lint: ignore[CACHE-MUTATE] the seeded defect, restored below
    wl._device[key] = dataclasses.replace(good, k=bad_k)
    try:
        t_stale = refused(lambda: VisionEngine(model, num_slots=4),
                          "WL-STALE-CACHE")
    finally:
        # lint: ignore[CACHE-MUTATE] puts the schedule's true copy back
        wl._device[key] = good
    # a packed conv whose card indices name chunk K // bk
    idx = conv.packed.indices.clone()
    idx[0, 0] = kb
    layers = list(model.layers)
    layers[8] = dataclasses.replace(layers[8], conv=dataclasses.replace(
        conv, packed=dataclasses.replace(conv.packed, indices=idx),
        wl_cache={}))
    corrupt = dataclasses.replace(model, layers=layers, _fwd_cache={})
    t_range = refused(lambda: VisionEngine(corrupt, num_slots=4), "BS-RANGE")
    launched = WALK.launches + CONV_GRID.launches
    require(launched == 0, f"admission launched {launched} kernels")
    again = compile_forward(model)(x)
    torch_sync()
    require(torch.equal(again, out), "the forward changed after the "
                                     "refusals")
    print(f"admission VGG16 {SIZE} px (chunk pattern, {model.num_layers} "
          f"layers, {copies} cached device schedules): verify_model(deep="
          f"True) {t_deep:.4f} s (0 diagnostics); default VisionEngine "
          f"{t_engine:.4f} s, VisionServer {t_server:.4f} s; refused: layer "
          f"8's DeviceSchedule with chunk {kb} (WL-STALE-CACHE) in "
          f"{t_stale:.4f} s, its card indices with chunk {kb} (BS-RANGE) in "
          f"{t_range:.4f} s; 0 kernel launches, the forward unchanged after "
          f"[{card}]")


def torch_sync():
    import torch
    torch.cuda.synchronize()


def lm_requests(cfg):
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(1, cfg.vocab, (LM_REQUESTS, LM_PROMPT))
    return [Request(rid=i, prompt=prompts[i], max_new=LM_NEW,
                    arrival=i * LM_STAGGER) for i in range(LM_REQUESTS)]


def lm_serving_phase(cfg, params, card):
    """Phases 7, 10 and 18, the LM main path: ``Scheduler`` on its replayed
    decode step (the default), then once on the eager step
    (``compiled=False``): tokens and K3/K4 launches equal, each tok/s;
    the graphed tokens bitwise equal to each request served alone.
    Returns {kernel: launches} of the graphed run."""
    from repro_torch.kernels.bitmask_spmm import BITMASK_SPMM
    from repro_torch.kernels.fused_ffn import FUSED_FFN
    from repro_torch.serve import Request, Scheduler
    max_len = LM_PROMPT + LM_NEW
    reqs = lm_requests(cfg)
    runs = {}
    for compiled in (True, False):
        BITMASK_SPMM.launches = FUSED_FFN.launches = 0
        sch = Scheduler(cfg, params, num_slots=LM_SLOTS, max_len=max_len,
                        compiled=compiled)
        produced = sch.run(reqs, probe_ffn=True)
        torch_sync()
        runs[compiled] = (sch, produced, {"k3": BITMASK_SPMM.launches,
                                          "k4": FUSED_FFN.launches})
    sch, produced, launches = runs[True]
    eager_sch, eager_out, eager_launches = runs[False]
    require(eager_out == produced, f"{cfg.name}: the graphed Scheduler's "
                                   f"tokens != the eager one's")
    require(eager_launches == launches, f"{cfg.name}: graphed launches "
            f"{launches} != eager {eager_launches}")
    require(sch.ffn_probe == eager_sch.ffn_probe, f"{cfg.name}: the "
            f"captured probe's counters != the eager probe's")
    st, probe = sch.stats, sch.ffn_probe
    g, = sch._step_fn.graphs.values()
    adm, = sch._admit_fn.graphs.values()       # one prompt length
    every = sch.captured_graphs()              # step, admission, probe
    require(len(every) == 3 and adm.replays == st.prefills - 1,
            f"{cfg.name}: {len(every)} graphs, admission replayed "
            f"{adm.replays} times for {st.prefills} admissions")
    require(probe is not None, "the FFN probe found no sparse leaves")
    forwards = st.prefills + st.engine_steps + 1          # + the probe
    print(f"serving sparse {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}):"
          f" {len(reqs)} requests on {LM_SLOTS} slots, prompt {LM_PROMPT}, "
          f"{LM_NEW} new tokens each, arrivals every {LM_STAGGER} steps: "
          f"{st.tokens} tokens in {st.wall_s:.3f} s = {st.tok_per_s:.2f} "
          f"tok/s on the replayed decode step (first calls and the capture "
          f"included; eager step {eager_sch.stats.wall_s:.3f} s = "
          f"{eager_sch.stats.tok_per_s:.2f} tok/s, tokens bitwise equal), "
          f"{st.prefills} admissions ({adm.replays} replays of one graph, "
          f"capture {adm.capture_s:.3f} s) + {st.engine_steps} decode steps "
          f"({g.replays} replays of one graph, capture "
          f"{g.capture_s:.3f} s), slot utilization "
          f"{st.slot_utilization:.3f} [{card}]")
    print(f"  FFN probe (first live batch): executed_frac "
          f"{probe['executed_frac']:.4f}, skipped_frac "
          f"{probe['skipped_frac']:.4f}, weight-tile density "
          f"{probe['weight_tile_macs'] / probe['dense_tile_macs']:.4f}, "
          f"decode compaction {probe['decode_compaction']:.2f}x")
    # each graph's first call (the eager warm-up of the decode step, the
    # admission and the probe), then every replay adds its tally
    eager_part = len(every)
    replays = sum(x.replays for x in every)
    print(f"  main-path launches: fused FFN {launches['k4']}, sparse matmul "
          f"{launches['k3']} ({cfg.n_layers} layers x {forwards} forwards "
          f"= {cfg.n_layers * forwards}: {cfg.n_layers} x {eager_part} eager"
          f" (the first call of the step, admission and probe graphs) + "
          f"{g.replays} step and {adm.replays} admission replays x a tally "
          f"of {g.tally.get(BITMASK_SPMM)} / {g.tally.get(FUSED_FFN)}), "
          f"equal to the eager paths'")
    for key, name, kernel in (("k4", "fused FFN", FUSED_FFN),
                              ("k3", "sparse matmul", BITMASK_SPMM)):
        require(launches[key] == cfg.n_layers * forwards,
                f"{name} launched {launches[key]} times, expected one per "
                f"layer and forward ({cfg.n_layers * forwards})")
        require(all(x.tally.get(kernel) == cfg.n_layers for x in every)
                and launches[key] == cfg.n_layers * eager_part + sum(
                    x.replays * x.tally[kernel] for x in every),
                f"{name}: launches != eager + replays x tally "
                f"({replays} replays)")
    for r in reqs:
        got = produced[r.rid]
        require(len(got) == LM_NEW and all(0 <= t < cfg.padded_vocab
                                           for t in got),
                f"request {r.rid}: bad tokens {got[:8]}")
        solo = Scheduler(cfg, params, num_slots=LM_SLOTS, max_len=max_len)
        one = solo.run([Request(r.rid, r.prompt, r.max_new)])[r.rid]
        require(one == got, f"request {r.rid}: batched tokens != solo "
                            f"({got[:8]} vs {one[:8]})")
    print(f"  greedy tokens bitwise equal to each request served alone on "
          f"{LM_SLOTS} slots ({len(reqs)} requests); request 0: "
          f"{produced[0][:12]}")
    decode_phase(cfg, params, card, LM_SLOTS, LM_PROMPT)
    captured_serving_phase(cfg, params, card)
    return launches


def timed_pair(graph_fn, eager_fn, reps: int):
    """(graph ms, eager ms) a call by CUDA events: after one call of each
    (the graph's warm-up and capture), ``reps`` calls of the graphed then
    the eager function, in turns, 3 windows; the median window."""
    import torch
    graph_fn()
    eager_fn()
    torch_sync()
    out = {"graph": [], "eager": []}
    for _ in range(3):
        for name, fn in (("graph", graph_fn), ("eager", eager_fn)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch_sync()
            out[name].append(start.elapsed_time(end) / reps)
    return float(np.median(out["graph"])), float(np.median(out["eager"]))


def captured_serving_phase(cfg, params, card, reps: int = 5):
    """The captured prefill, admission and probe of phases 7, 10 and 18
    against their eager paths: bitwise equal (tokens, logits, caches,
    counters), then each timed graph against eager (CUDA events,
    :func:`timed_pair`): the prefill of LM_SLOTS prompts of LM_PROMPT
    (``GraphedPrefill`` / ``prefill``) and one admission
    (``GraphedAdmit`` with a device slot / ``prefill_lane`` +
    ``write_lane``); the probe replayed (its second call) equal to the
    eager probe on the same live batch. Runs after the main path's
    counters were read."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import (GraphedAdmit, GraphedFfnStats,
                                   GraphedPrefill)
    from repro_torch.serve.engine import (make_ffn_stats_fn, prefill_lane,
                                          write_lane)
    dev = params["embed"].device
    max_len = LM_PROMPT + LM_NEW
    rng = np.random.default_rng(SEED + 7)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (LM_SLOTS, LM_PROMPT)),
                           device=dev)
    pre = GraphedPrefill(cfg)
    for i in range(2):                         # the warm-up, then a replay
        # a zeroed cache each time (the prefill writes into the one given,
        # and an SSM's state carries on from it)
        mine = M.init_cache(cfg, LM_SLOTS, max_len, device=dev)
        last, got = pre(params, toks, mine)
        wl, wc = M.prefill(params, cfg, toks, M.init_cache(
            cfg, LM_SLOTS, max_len, device=dev))
        require(torch.equal(last, wl) and all(torch.equal(a, b) for a, b in
                zip(graph_leaves(got), graph_leaves(wc))),
                f"{cfg.name}: the graphed prefill != prefill (call {i})")
    gp, = pre.graphs.values()
    p_ms = timed_pair(lambda: pre(params, toks, mine),
                      lambda: M.prefill(params, cfg, toks, mine), reps)
    admit = GraphedAdmit(cfg, max_len)
    cache = M.init_cache(cfg, LM_SLOTS, max_len, device=dev)
    want = M.map_tree(torch.clone, cache)
    for i in range(LM_SLOTS + 2):
        slot = i % LM_SLOTS
        prompt = rng.integers(1, cfg.vocab, LM_PROMPT)
        first, cache = admit(params, cache, prompt,
                             torch.tensor(slot, device=dev))
        tok, lane = prefill_lane(params, cfg, max_len,
                                 torch.as_tensor(prompt, device=dev)[None])
        write_lane(want, lane, slot)
        require(torch.equal(first, tok) and all(
            torch.equal(a, b) for a, b in zip(graph_leaves(cache),
                                              graph_leaves(want))),
            f"{cfg.name}: the graphed admission != prefill_lane + "
            f"write_lane (admission {i})")
    ga, = admit.graphs.values()
    slot_t = torch.tensor(1, device=dev)
    a_ms = timed_pair(
        lambda: admit(params, cache, prompt, slot_t),
        lambda: write_lane(want, prefill_lane(
            params, cfg, max_len, torch.as_tensor(prompt, device=dev)[None])
            [1], 1), reps)
    probe = GraphedFfnStats(cfg)
    live = np.array([True] * (LM_SLOTS - 1) + [False])
    tok = rng.integers(1, cfg.vocab, (LM_SLOTS, 1))
    pos = np.full(LM_SLOTS, LM_PROMPT)
    eager_stats = make_ffn_stats_fn(cfg)(
        params, cache, torch.as_tensor(tok, device=dev),
        torch.as_tensor(pos, device=dev), torch.as_tensor(live, device=dev))
    eager_stats = {k: float(v) for k, v in eager_stats.items()}
    runs = [{k: float(v) for k, v in probe(params, cache, tok, pos,
                                           live).items()} for _ in range(2)]
    gs, = probe.graphs.values()
    require(gs.replays == 1 and runs[0] == runs[1] == eager_stats,
            f"{cfg.name}: the replayed probe's counters != the eager "
            f"probe's")
    print(f"  captured prefill ({LM_SLOTS} x {LM_PROMPT} tokens, "
          f"{gp.replays} replays so far, capture {gp.capture_s:.3f} s, pool "
          f"{gp.pool_bytes / 2**30:.3f} GiB): graph {p_ms[0]:.4f} ms, eager "
          f"{p_ms[1]:.4f} ms ({p_ms[1] / p_ms[0]:.2f}x); admission (1 x "
          f"{LM_PROMPT}, the slot a device tensor, capture "
          f"{ga.capture_s:.3f} s): graph {a_ms[0]:.4f} ms, eager "
          f"{a_ms[1]:.4f} ms ({a_ms[1] / a_ms[0]:.2f}x), by CUDA events, "
          f"median of 3 windows of {reps}; both bitwise equal to eager "
          f"({LM_SLOTS + 2} admissions); the probe replayed, its "
          f"{len(eager_stats)} counters equal to the eager probe's "
          f"[{card}]")
    return {"prefill_ms": p_ms, "admit_ms": a_ms}


def graph_leaves(tree):
    from repro_torch.graphs import leaves
    return leaves(tree)


def sampled_generate_phase(cfg, params, card):
    """Sampling on the graphed path: ``generate`` of LM_SLOTS prompts of
    LM_PROMPT, LM_NEW new tokens, ``greedy=False`` with a CUDA generator
    seeded SEED, captured (prefill and decode graphs, the generator
    registered with the decode graph) and eager: tokens bitwise equal and
    the generators' states equal after; tok/s of each on the host
    clock (a first call of each before, so the timed graphed run replays a
    held step's graphs)."""
    import torch
    from repro_torch.serve import GraphedServeStep, generate
    dev = params["embed"].device
    prompt = torch.as_tensor(np.random.default_rng(SEED + 11).integers(
        1, cfg.vocab, (LM_SLOTS, LM_PROMPT)), device=dev)
    step = GraphedServeStep(cfg, greedy=False)
    out, secs, gens = {}, {}, {}
    for name in ("graph", "eager"):
        kw = {"step": step} if name == "graph" else {"compiled": False}
        # one generator each (the graph is registered with it): a first
        # run, then re-seeded for the timed one
        gens[name] = torch.Generator(device=dev).manual_seed(SEED + 1)
        generate(params, cfg, prompt, LM_NEW, greedy=False, rng=gens[name],
                 **kw)
        gens[name].manual_seed(SEED)
        torch_sync()
        t0 = time.perf_counter()
        out[name] = generate(params, cfg, prompt, LM_NEW, greedy=False,
                             rng=gens[name], **kw)
        torch_sync()
        secs[name] = time.perf_counter() - t0
    require(torch.equal(out["graph"], out["eager"]) and torch.equal(
        gens["graph"].get_state(), gens["eager"].get_state()),
        f"{cfg.name}: sampled tokens of the graphed generate != eager on "
        f"one seed")
    g, = step.graphs.values()
    greedy = generate(params, cfg, prompt, LM_NEW)
    differs = int((greedy[:, LM_PROMPT:] != out["graph"][:, LM_PROMPT:])
                  .sum())
    n = LM_SLOTS * LM_NEW
    print(f"  sampled generate ({LM_SLOTS} x {LM_PROMPT} prompt, {LM_NEW} "
          f"new, seed {SEED}): graph {n / secs['graph']:.2f} tok/s "
          f"({secs['graph']:.3f} s, {g.replays} decode replays in all), "
          f"eager {n / secs['eager']:.2f} tok/s ({secs['eager']:.3f} s), "
          f"host clock; tokens bitwise equal and the generators at one "
          f"state after; {differs} of {n} tokens differ from greedy "
          f"[{card}]")
    require(differs > 0, "sampling drew the greedy tokens everywhere")


def decode_phase(cfg, params, card, B, S, steps=DECODE_STEPS, src=None):
    """The captured decode step against the eager one from one prefilled
    cache (B lanes, prompt S; ``src`` the encoder frames of an
    encoder-decoder): in lockstep, every step's logits and tokens bitwise
    equal; then each timed over ``steps`` steps after a warm-up step (the
    graph's capture), on the host clock (ending in a synchronize) and by
    CUDA events around the same steps. Returns the record."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import GraphedServeStep, make_serve_step
    dev = params["embed"].device
    toks = torch.as_tensor(np.random.default_rng(SEED + 5).integers(
        1, cfg.vocab, (B, S)), device=dev)
    enc = 0 if src is None else src.shape[1]
    cache0 = M.init_cache(cfg, B, S + 2 * steps + 4, enc_len=enc,
                          device=dev)
    if src is not None:
        cache0 = M.prefill_cache(params, cfg, cache0,
                                 M.encode(params, src, cfg))
    last, cache0 = M.prefill(params, cfg, toks, cache0)
    tok0 = torch.argmax(last, -1)[:, None]
    graphed = GraphedServeStep(cfg)
    # lockstep: the graph's logits against decode_step's, every step
    gc, ec, tok = M.map_tree(torch.clone, cache0), cache0, tok0
    for i in range(steps):
        pos = torch.full((B,), S + i, dtype=torch.long, device=dev)
        el, ec = M.decode_step(params, cfg, tok, ec, pos)
        nxt, gc = graphed(params, gc, tok, pos)
        require(torch.equal(graphed.last_logits, el[:, 0]) and torch.equal(
            nxt, torch.argmax(el[:, 0], -1)[:, None]),
            f"{cfg.name}: graphed decode step {i} != eager (logits or "
            f"token)")
        tok = nxt
    del gc, ec
    rec = {"lanes": B, "position": S, "steps": steps, "card": card}
    for name, step in (("graph", graphed), ("eager", make_serve_step(cfg))):
        cache, tok = M.map_tree(torch.clone, cache0), tok0
        pos = torch.full((B,), S, dtype=torch.long, device=dev)
        tok, cache = step(params, cache, tok, pos)        # warm-up
        torch_sync()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for i in range(steps):
            tok, cache = step(params, cache, tok, pos + 1 + i)
        end.record()
        torch_sync()
        rec[name] = {"host_ms": (time.perf_counter() - t0) * 1e3 / steps,
                     "cuda_ms": start.elapsed_time(end) / steps,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        require(np.isfinite(list(rec[name].values())).all(),
                f"{cfg.name}: decode step time not finite")
        kernels = trace_kernels(lambda: step(params, cache, tok,
                                             pos + 1 + steps))
        rec[name]["kernels"] = len(kernels)
        rec[name]["busy_ms"] = sum(t for _, t in kernels)
        rec[name]["top"] = sorted(by_name(kernels).items(),
                                  key=lambda kv: -kv[1][1])[:4]
    g, = graphed.graphs.values()
    gr, ea = rec["graph"], rec["eager"]
    print(f"  decode step ({B} lanes from position {S}, {steps} steps): "
          f"graph {gr['host_ms']:.4f} ms host / {gr['cuda_ms']:.4f} ms CUDA "
          f"events, eager {ea['host_ms']:.4f} / {ea['cuda_ms']:.4f} ms "
          f"({ea['cuda_ms'] / gr['cuda_ms']:.2f}x), "
          f"{B / gr['cuda_ms'] * 1e3:.1f} / {B / ea['cuda_ms'] * 1e3:.1f} "
          f"tok/s of decode; logits and tokens bitwise equal over {steps} "
          f"steps in lockstep; capture {g.capture_s:.3f} s; peak memory "
          f"over the timed steps {gr['peak_gib']:.3f} GiB allocated graph "
          f"(its pool {g.pool_bytes / 2**30:.3f} GiB reserved beside), "
          f"{ea['peak_gib']:.3f} GiB eager [{card}]")
    rec["pool_gib"] = g.pool_bytes / 2**30
    for name in ("graph", "eager"):
        r = rec[name]
        if not r["kernels"]:
            print(f"  {name} step trace: the profiler saw no kernel on the "
                  f"card (not measured)")
            continue
        idle = r["cuda_ms"] - r["busy_ms"]
        print(f"  {name} step, one traced (torch.profiler): {r['kernels']} "
              f"kernels, the card busy {r['busy_ms']:.4f} ms, idle "
              f"{idle:.4f} ms ({idle / r['cuda_ms']:.1%}) of the timed step;"
              f" top: " + "; ".join(f"{n[:48]} ({k}, {ms:.4f})" for n, (
                  k, ms) in r["top"]))
    return rec


def densified_fp32(cfg, params):
    """(fp32 config, fp32 params through the kernels, the oracle's params,
    the oracle's config): the oracle is the same model in fp32 with every
    encoder and decoder FFN on its densified weights (torch.matmul)."""
    import dataclasses
    import torch
    from repro_torch.models import model as M
    from repro_torch.sparsity.sparse_ffn import densify
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = M.map_tree(lambda t: t.float() if t.is_floating_point() else t,
                     params)
    D, chunk = cfg.d_model, 128
    oracle = dict(p32)
    for stack in ("blocks", "enc_blocks"):
        if stack not in p32:
            continue
        oracle[stack] = []
        for period in p32[stack]:
            new = {}
            for key, bp in period.items():
                src, leaf = sparse_leaf(bp)
                sp = bp[leaf]
                Fp = sp["in_indices"].shape[0] * chunk
                dense = {"w_in": densify(sp, "in", D, chunk)[:D],
                         "w_out": densify(sp, "out", Fp, chunk)[:, :D]}
                if "gate_indices" in sp:
                    dense["w_gate"] = densify(sp, "gate", D, chunk)[:D]
                new[key] = dict(bp, **{src: dict(bp[src], **dense)})
                del new[key][leaf]
            oracle[stack].append(new)
    return cfg32, p32, oracle, dataclasses.replace(cfg32, sparse_ffn=False)


def lm_oracle_phase(cfg, params):
    """Phase 8: fp32 logits through the kernels against the same forward
    with every FFN on its densified weights (torch.matmul, TF32 off)."""
    import torch
    from repro_torch.models import model as M
    cfg32, p32, oracle, cfg_dense = densified_fp32(cfg, params)
    dev = params["embed"].device
    toks = torch.as_tensor(np.stack([r.prompt for r in lm_requests(cfg)[:4]]),
                           device=dev)
    B, S = toks.shape
    cache = M.init_cache(cfg32, B, S + 1, device=dev)
    ls, _ = M.prefill(p32, cfg32, toks, cache)
    lo, cache_o = M.prefill(oracle, cfg_dense, toks, cache)
    _, rel_p = errors(ls, lo)
    nxt = torch.argmax(lo, -1)[:, None]
    pos = torch.full((B,), S, dtype=torch.long, device=dev)
    ds, _ = M.decode_step(p32, cfg32, nxt, cache_o, pos)
    do, _ = M.decode_step(oracle, cfg_dense, nxt, cache_o, pos)
    _, rel_d = errors(ds, do)
    torch_sync()
    print(f"oracle ({cfg.name}, fp32, {cfg.n_layers} layers, {B} prompts "
          f"of {S}): "
          f"prefill logits rel err {rel_p:.3e}, decode_step logits rel err "
          f"{rel_d:.3e} vs densified-weight FFNs (torch.matmul, TF32 off)")
    require(rel_p <= TOL and rel_d <= TOL,
            f"LM oracle: rel err {rel_p:.3e} / {rel_d:.3e} > {TOL}")
    require(bool(torch.isfinite(ls).all() and torch.isfinite(ds).all())
            and tuple(ds.shape) == (B, 1, cfg.padded_vocab),
            "LM oracle: logits not finite or of the wrong shape")


def walker_grid(wl, M, bn, bm_rows, elem_bytes):
    """The walker's grid-mode launch for one work list: CTAs, the busy ones
    (some pair with a live step: the host model of the merged lists),
    column groups and ring stages."""
    import torch
    from repro_torch.kernels.grid import (grid_geometry, ring_stages,
                                          sm_count, walk_lists)
    g = grid_geometry(M, wl.nb, bm=bm_rows, bn=bn,
                      sms=sm_count(torch.device("cuda")))
    ptr, js = torch.as_tensor(wl.pair_ptr()), torch.as_tensor(wl.j)
    streams = [wl.k] + ([] if wl.k2 is None else [wl.k2])
    busy = set()
    for ks in streams:
        busy |= set(walk_lists(ptr, torch.as_tensor(ks), js, nb=wl.nb,
                               mb=wl.mb, bm_rows=bm_rows))
    n = len(streams)
    wide, one = ring_stages(elem_bytes, g.col_group, 128)
    return (f"{g.blocks * n} CTAs of 64 threads{' (pairs)' if n == 2 else ''}"
            f", {len(busy) * g.groups * n} busy, {g.col_group}-column groups,"
            f" ring {wide} whole-chunk stages ({one} in the one-tile layout)")


def walker_one_stream(x2, vals, indices, w_dense, rows, act, at, card,
                      vals32=None):
    """K1's one-stream grid mode on a compact schedule built from ``x2``
    (rows padded to 8): against its plain version (fp32 rel err, or in
    bf16 the rounding identity against the fp32 run on the widened inputs,
    ``vals32``), timed beside its bound and one ``torch.matmul`` on the
    densified weights. Returns (output, record)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.worklist_core import (worklist_spmm,
                                                   worklist_spmm_plain)
    chunk, sub_m = 128, 8
    Kp = x2.shape[1]
    nb = indices.shape[0]
    wl = ops._worklist_for(x2, indices, None, sub_m, chunk,
                           compact_activations=True, wl_cache=None)
    kw = dict(bk=chunk, bn=chunk, bm_rows=sub_m, act=act)
    pkw = dict(sub_m=sub_m, emit_occupancy=False, **kw)
    o = worklist_spmm(x2, vals, wl, **kw)[0]
    po = worklist_spmm_plain(x2, vals, wl, **pkw)[0]
    torch_sync()
    require(bool((o[rows:] == 0).all()),
            f"K1 {at}: padded rows are not exact zeros")
    ulps = None
    if x2.dtype == torch.float32:
        a1, r1 = errors(o, po)
        require(r1 <= TOL, f"K1 {at}: rel err {r1:.3e}")
    else:
        a1, r1 = errors(o.float(), po.float())
        x32 = x2.float()
        ulps = check_bf16(f"K1 {at}", o, po,
                          worklist_spmm(x32, vals32, wl, **kw)[0],
                          worklist_spmm_plain(x32, vals32, wl, **pkw)[0])
    executed = float(ops.sparse_matmul_tile_stats(
        x2, indices, k_total=Kp, bk=chunk, sub_m=sub_m)["executed"])
    require(int((wl.k >= 0).sum()) == int(executed),
            f"K1 {at}: live steps != occupied sub-block MACs {executed}")
    eb = x2.element_size()
    stored = int((indices >= 0).sum())
    nbytes = (eb * (rows * Kp + stored * chunk * chunk + rows * nb * chunk)
              + 4.0 * (2 * wl.num_steps + wl.num_pairs + 1))
    peak = BF16_FLOPS if x2.dtype == torch.bfloat16 else FP32_FLOPS
    b1, by1 = bound(2.0 * sub_m * chunk * chunk * executed, nbytes, peak)
    k_ms = graph_ms(lambda: worklist_spmm(x2, vals, wl, **kw), reps=20)
    p_ms = cuda_ms(lambda: worklist_spmm_plain(x2, vals, wl, **pkw), reps=5)
    xr, wd = x2[:rows], w_dense.to(x2.dtype)
    l_ms = graph_ms(lambda: torch.matmul(xr, wd), reps=20)
    grid = walker_grid(wl, x2.shape[0], chunk, sub_m, eb)
    print(f"work-list FFN @ {at} [{card}]")
    print(f"  walker (K1, one stream, {act}): max abs err {a1:.3e}, max rel "
          f"err {r1:.3e}{ulp_note(ulps)}; {wl.mac_steps} live steps of "
          f"{wl.num_steps}; {grid}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
          f"ms, bound {b1:.4f} ms ({by1}), matmul {l_ms:.4f} ms"
          f"{' (no activation)' if act else ''}")
    return o, {"at": at, "mode": "grid, one stream", "max_abs_err": a1,
               "max_rel_err": r1, "bf16_worst_ulps": ulps[0] if ulps else None,
               "ms": k_ms, "plain_ms": p_ms, "bound_ms": b1, "bound_by": by1,
               "library_ms": l_ms, "grid": grid}


def walker_ffn_phase(params, cfg, card):
    """Phase 9: the work-list FFN schedule on layer 0's packed FFN. Returns
    the walker's two-stream records and its main-path launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.worklist_core import (WALK, schedule_counters,
                                                   worklist_spmm,
                                                   worklist_spmm_plain)
    from repro_torch.sparsity.sparse_ffn import densify, sparse_ffn_apply
    torch.backends.cuda.matmul.allow_tf32 = False
    sp = params["blocks"][0]["p0"]["ffn_sparse"]
    dev = sp["in_vals"].device
    chunk, sub_m = 128, 8
    nb_in, mnz = sp["in_indices"].shape
    D, Fp = cfg.d_model, nb_in * chunk
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    w_lib = torch.cat([densify(sp, "in", D, chunk),
                       densify(sp, "gate", D, chunk)], 1)
    w_out = densify(sp, "out", Fp, chunk)
    recs, main_launches = [], 0
    for regime, rows in (("decode", 2), ("decode", LM_SLOTS),
                         ("prefill", LM_PROMPT)):
        x16 = torch.randn((rows, D), generator=gen, device=dev) \
            .to(torch.bfloat16)
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{regime} ({rows} rows), {str(dtype).split('.')[-1]}"
            v = {k: (t.to(dtype) if t.is_floating_point() else t)
                 for k, t in sp.items()}
            x = x16.to(dtype)
            # the main path, through the user's entry point, counted from 0
            WALK.launches = 0
            out_c = sparse_ffn_apply(v, x, cfg.act, schedule="compact")
            torch_sync()
            require(WALK.launches == 2, f"compact FFN {tag}: the walker "
                    f"launched {WALK.launches} times, expected 2")
            main_launches += WALK.launches
            out_d = sparse_ffn_apply(v, x, cfg.act)
            torch_sync()
            diff = float((out_c.float() - out_d.float()).abs().max())
            require(torch.equal(out_c, out_d), f"compact FFN {tag} != dense "
                    f"grid: max abs diff {diff:.3e}")
            # the schedule against the host model of its step counts
            x2, _, _ = ops._pad_rows_k(x, D, sub_m)
            occ = ops.activation_occupancy(x2, sub_m, chunk).bool()
            wl = ops._worklist_for(x2, v["in_indices"], v["gate_indices"],
                                   sub_m, chunk, compact_activations=True,
                                   wl_cache=None)
            sched = schedule_counters(wl, predicated_steps=ops.
                                      _predicated_steps(rows, nb_in, mnz,
                                                        sub_m))
            model = ops.schedule_stats(None, v["in_indices"], bk=chunk,
                                       occ=occ,
                                       gate_indices=v["gate_indices"])
            for key, src in (("scheduled_steps", "scheduled_steps"),
                             ("live_chunk_steps", "live_chunk_steps"),
                             ("flush_only_steps", "dead_pairs"),
                             ("dense_grid_steps", "dense_grid_steps")):
                require(sched[key] == int(model[src]),
                        f"schedule {tag}: {key} {sched[key]} != host model "
                        f"{int(model[src])}")
            if regime == "decode":
                require(sched["compaction_factor"] == 16.0,
                        f"schedule {tag}: compaction "
                        f"{sched['compaction_factor']:.2f}, expected 16.00")
            # the walker's two-stream mode against its plain version
            kw = dict(vals2=v["gate_vals"], bk=chunk, bn=chunk,
                      bm_rows=sub_m, act=cfg.act)
            args = (x2, v["in_vals"], wl)
            h = worklist_spmm(*args, **kw)[0]
            ph = worklist_spmm_plain(*args, sub_m=sub_m,
                                     emit_occupancy=False, **kw)[0]
            torch_sync()
            require(bool((h[rows:] == 0).all()),
                    f"K1 {tag}: padded rows are not exact zeros")
            ulps = None
            if dtype == torch.float32:
                a1, r1 = errors(h, ph)
                require(r1 <= TOL, f"K1 {tag}: rel err {r1:.3e}")
                h32, ph32 = h, ph
            else:
                a1, r1 = errors(h.float(), ph.float())
                ulps = check_bf16(f"K1 {tag}", h, ph, h32, ph32)
            # the bound: the live sub-block MACs of both streams (at 8-row
            # blocks the walker MACs exactly those), each input read once
            executed = [float(ops.sparse_matmul_tile_stats(
                x2, v[f"{r}_indices"], k_total=D, bk=chunk,
                sub_m=sub_m)["executed"]) for r in ("in", "gate")]
            live = [int((wl.k >= 0).sum()), int((wl.k2 >= 0).sum())]
            require(live == [int(e) for e in executed],
                    f"K1 {tag}: live steps {live} != occupied sub-block "
                    f"MACs {executed}")
            eb = x.element_size()
            flops = 2.0 * sub_m * chunk * chunk * sum(executed)
            stored = sum(int((v[f"{r}_indices"] >= 0).sum())
                         for r in ("in", "gate"))
            nbytes = (eb * (rows * D + stored * chunk * chunk + rows * Fp)
                      + 4.0 * (3 * wl.num_steps + wl.num_pairs + 1))
            peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
            b1, by1 = bound(flops, nbytes, peak)
            k_ms = graph_ms(lambda: worklist_spmm(*args, **kw), reps=20)
            p_ms = cuda_ms(lambda: worklist_spmm_plain(
                *args, sub_m=sub_m, emit_occupancy=False, **kw), reps=5)
            wd = w_lib.to(dtype)
            l_ms = graph_ms(lambda: torch.matmul(x, wd), reps=20)
            grid = walker_grid(wl, x2.shape[0], chunk, sub_m, eb)
            at = (f"Qwen3-4B layer 0 FFN in/gate, two streams, {tag}, "
                  f"bk=bn={chunk} bm_rows=sub_m={sub_m}, density "
                  f"{LM_DENSITY}")
            print(f"work-list FFN @ {at} [{card}]")
            print(f"  compact schedule bitwise equal to the dense grid (fused"
                  f" FFN, sparse matmul); walker launched 2 times; schedule "
                  f"{sched['scheduled_steps']} steps "
                  f"({sched['live_chunk_steps']} live, "
                  f"{sched['flush_only_steps']} flush-only) = host "
                  f"model, predicated {sched['predicated_grid_steps']}, "
                  f"compaction {sched['compaction_factor']:.2f}x")
            print(f"  walker (K1, two streams, {cfg.act}): max abs err "
                  f"{a1:.3e}, max rel err {r1:.3e}{ulp_note(ulps)}; {grid};"
                  f" kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                  f"{b1:.4f} ms "
                  f"({by1}), matmul [W_in|W_gate] {l_ms:.4f} ms (no "
                  f"activation)")
            recs.append({"at": at, "mode": "grid, two streams",
                         "max_abs_err": a1, "max_rel_err": r1,
                         "bf16_worst_ulps": ulps[0] if ulps else None,
                         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b1,
                         "bound_by": by1, "library_ms": l_ms, "grid": grid,
                         "compaction_factor": sched["compaction_factor"]})
            # the compact out projection on that hidden: one stream
            recs.append(walker_one_stream(
                h, v["out_vals"], v["out_indices"], w_out, rows, None,
                f"Qwen3-4B layer 0 FFN out projection, one stream, {tag}, "
                f"bk=bn={chunk} bm_rows=sub_m={sub_m}, density "
                f"{LM_DENSITY}", card,
                vals32=sp["out_vals"].float())[1])
    return recs, main_launches


def channel_mix_compact_phase(params, cfg, card):
    """Phase 10's compact schedule: one RWKV channel-mix (layer 0, relu2)
    through the work-list schedule, the walker's one-stream mode with its
    relu2 epilogue then without one, bitwise equal to the dense grid at
    decode and prefill; each of the two walker launches checked and timed.
    Returns the walker's main-path launches and its records."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.worklist_core import WALK
    from repro_torch.sparsity.sparse_ffn import densify, sparse_ffn_apply
    sp = params["blocks"][0]["p0"]["channel_mix_sparse"]
    dev = sp["in_vals"].device
    chunk, sub_m = 128, 8
    D, Fp = cfg.d_model, sp["in_indices"].shape[0] * chunk
    w_in, w_out = densify(sp, "in", D, chunk), densify(sp, "out", Fp, chunk)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    launches, recs = 0, []
    for regime, rows in (("decode", LM_SLOTS), ("prefill", LM_PROMPT)):
        x16 = torch.randn((rows, cfg.d_model), generator=gen, device=dev) \
            .to(torch.bfloat16)
        for dtype in (torch.float32, torch.bfloat16):
            v = {k: (t.to(dtype) if t.is_floating_point() else t)
                 for k, t in sp.items()}
            x = x16.to(dtype)
            tag = f"{regime} ({rows} rows), {str(dtype).split('.')[-1]}"
            WALK.launches = 0
            out_c = sparse_ffn_apply(v, x, "relu2", schedule="compact")
            torch_sync()
            require(WALK.launches == 2, f"compact channel-mix {tag}: the "
                    f"walker launched {WALK.launches} times, expected 2")
            launches += WALK.launches
            out_d = sparse_ffn_apply(v, x, "relu2")
            torch_sync()
            diff = float((out_c.float() - out_d.float()).abs().max())
            require(torch.equal(out_c, out_d), f"compact channel-mix {tag} "
                    f"!= dense grid: max abs diff {diff:.3e}")
            print(f"  channel-mix (layer 0, relu2) {tag}: compact schedule "
                  f"bitwise equal to the dense grid")
            # its two walker launches, checked and timed
            x2, _, _ = ops._pad_rows_k(x, D, sub_m)
            at = (f"RWKV6-3B layer 0 channel-mix {{}}, one stream, {tag}, "
                  f"bk=bn={chunk} bm_rows=sub_m={sub_m}, density "
                  f"{LM_DENSITY}")
            h, rec = walker_one_stream(
                x2, v["in_vals"], v["in_indices"], w_in, rows, "relu2",
                at.format("in projection"), card,
                vals32=sp["in_vals"].float())
            recs.append(rec)
            recs.append(walker_one_stream(
                h, v["out_vals"], v["out_indices"], w_out, rows, None,
                at.format("out projection"), card,
                vals32=sp["out_vals"].float())[1])
    return launches, recs


# ---------------------------------------------------------------------------
# phases 13-17: the remaining LM families
# ---------------------------------------------------------------------------
def seamless_phase(dev, card):
    """Phase 13: sparse SeamlessM4T-medium at full width and depth (12
    encoder + 12 decoder layers, bf16) through ``generate``: 4 requests of
    256 stub source frames and a 16-token prompt, 32 new tokens each.
    Returns (K3/K4 launches of that run, kernel records)."""
    import torch
    from repro_torch.analysis import verify_param_leaves
    from repro_torch.models import model as M
    from repro_torch.serve import GraphedServeStep, generate
    t_phase = time.perf_counter()
    cfg, params = build_family(dev, SEAMLESS_ARCH)
    n_enc = sum("ffn_sparse" in period["p0"]
                for period in params["enc_blocks"])
    require(n_enc == cfg.encoder_layers,
            f"seamless: {n_enc} of {cfg.encoder_layers} encoder FFNs packed")
    require(not verify_param_leaves(params, d_model=cfg.d_model),
            "seamless: the packed leaves do not verify")
    R, S_src, S0, new = (SEAMLESS_REQUESTS, SEAMLESS_FRAMES, SEAMLESS_PROMPT,
                         SEAMLESS_NEW)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    src = 0.02 * torch.randn((R, S_src, cfg.d_model), generator=gen,
                             device=dev)
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
        1, cfg.vocab, (R, S0)), device=dev)

    ffn_counts(reset=True)
    step = GraphedServeStep(cfg)        # held: the second run replays
    torch_sync()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, new, src_embeds=src, step=step)
    torch_sync()
    dt = time.perf_counter() - t0
    launches = ffn_counts()
    # the encoder once, the decoder at the prefill and new - 1 steps: the
    # first step eager (the warm-up before the capture), new - 2 replays
    want = cfg.encoder_layers + cfg.n_layers * new
    g, = step.graphs.values()
    for key, name in (("k4", "fused FFN"), ("k3", "sparse matmul")):
        require(launches[key] == want,
                f"seamless: {name} launched {launches[key]} times, "
                f"expected {want}")
    replays = g.replays
    require(replays == new - 2 and sorted(g.tally.values()) ==
            [cfg.n_layers] * 2, f"seamless: {replays} replays, tally "
                                f"{list(g.tally.values())}")
    require(tuple(out.shape) == (R, S0 + new)
            and torch.equal(out[:, :S0], prompt)
            and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
            "seamless: bad generated tokens")
    t0 = time.perf_counter()
    again = generate(params, cfg, prompt, new, src_embeds=src, step=step)
    torch_sync()
    dt2 = time.perf_counter() - t0
    require(torch.equal(again, out), "seamless: a second run differs")
    gp, = step.prefill.graphs.values()
    require(gp.replays == 1, f"seamless: the held step's prefill graph "
                             f"replayed {gp.replays} times, expected 1")
    t0 = time.perf_counter()
    eager = generate(params, cfg, prompt, new, src_embeds=src,
                     compiled=False)
    torch_sync()
    dt_e = time.perf_counter() - t0
    require(torch.equal(eager, out), "seamless: the graphed generate's "
                                     "tokens != the eager one's")
    for i in range(R):
        one = generate(params, cfg, prompt[i:i + 1], new,
                       src_embeds=src[i:i + 1])
        require(torch.equal(one[0], out[i]),
                f"seamless: request {i} batched != alone")
    print(f"serving sparse {cfg.name} ({cfg.encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers, {cfg.dtype}) through generate: "
          f"{R} requests of {S_src} source frames and a {S0}-token prompt,"
          f" {new} new tokens each, on the replayed decode step: "
          f"{R * new} tokens in {dt:.3f} s = {R * new / dt:.2f} tok/s "
          f"(first calls and the capture in), again {dt2:.3f} s = "
          f"{R * new / dt2:.2f} tok/s (its prefill replayed: capture "
          f"{gp.capture_s:.3f} s); the eager step {dt_e:.3f} s = "
          f"{R * new / dt_e:.2f} tok/s; tokens bitwise the same [{card}]")
    print(f"  main-path launches: fused FFN (relu) {launches['k4']}, sparse "
          f"matmul {launches['k3']} ({cfg.encoder_layers} encoder layers + "
          f"{cfg.n_layers} decoder layers x {new} forwards = {want}: "
          f"{cfg.encoder_layers} + {cfg.n_layers} x 2 eager + {replays} "
          f"replays x a tally of {cfg.n_layers}, capture "
          f"{g.capture_s:.3f} s); "
          f"tokens bitwise equal to each request generated alone "
          f"({R} requests); request 0: {out[0, S0:S0 + 12].tolist()}")
    decode_phase(cfg, params, card, R, S0, src=src)
    del step                            # its graphs and their pools

    # (a) the fp32 oracle, (c) prefill + decode_step against forward
    cfg32, p32, oracle, cfg_dense = densified_fp32(cfg, params)
    ls, _ = M.forward(p32, prompt, cfg32, src_embeds=src)
    lo, _ = M.forward(oracle, prompt, cfg_dense, src_embeds=src)
    _, rel_f = errors(ls, lo)
    cache = M.init_cache(cfg32, R, S0, enc_len=S_src, device=dev)
    cache = M.prefill_cache(p32, cfg32, cache, M.encode(p32, src, cfg32))
    lp, cache = M.prefill(p32, cfg32, prompt[:, :-1], cache)
    ld, _ = M.decode_step(p32, cfg32, prompt[:, -1:], cache,
                          torch.full((R,), S0 - 1, dtype=torch.long,
                                     device=dev))
    _, rel_p = errors(lp, ls[:, -2])
    _, rel_d = errors(ld[:, 0], ls[:, -1])
    torch_sync()
    print(f"oracle ({cfg.name}, fp32, {cfg.encoder_layers} + {cfg.n_layers} "
          f"layers, {R} x {S_src} frames, "
          f"{R} x {S0} tokens): forward logits rel err {rel_f:.3e} vs "
          f"densified-weight FFNs in the encoder and the decoder "
          f"(torch.matmul, TF32 off); prefill {rel_p:.3e} and decode_step "
          f"{rel_d:.3e} vs forward")
    require(rel_f <= TOL and rel_p <= TOL and rel_d <= TOL,
            f"seamless oracle: rel err {rel_f:.3e} / {rel_p:.3e} / "
            f"{rel_d:.3e} > {TOL}")
    require(bool(torch.isfinite(ls).all()) and tuple(ls.shape) ==
            (R, S0, cfg.padded_vocab), "seamless: logits not finite or of "
                                       "the wrong shape")
    del p32, oracle, cache, ls, lo
    torch.cuda.empty_cache()

    # (d) K4 (relu) and K3 at the shapes of this path
    recs = ffn_kernel_phase(params, cfg, card, regimes=(
        ("decode", R), ("decoder prefill", R * S0)))
    for key, more in ffn_kernel_phase(params, cfg, card, regimes=(
            ("encoder prefill", R * S_src),), stack="enc_blocks").items():
        recs[key] += more
    print(f"phase 13 (SeamlessM4T-medium) {time.perf_counter() - t_phase:.1f}"
          f" s")
    return launches, recs


def danube_phase(dev, card):
    """Phase 14: sparse H2O-Danube3-4B at full width (fp32, 2 of 24
    layers), one 8192-token prefill (twice the 4096 window) through the
    online-softmax attention in 1024-key chunks, against the dense masked
    path. Returns (K3/K4 launches of the flash forward, kernel records)."""
    import torch
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    cfg, params = build_family(dev, DANUBE_ARCH, layers=DANUBE_LAYERS,
                               dtype="float32")
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        1, cfg.vocab, (1, DANUBE_TOKENS)), device=dev)
    runs = {}
    for name, chunk in (("flash", DANUBE_FLASH), ("dense", None)):
        for _ in range(2):              # the second call is reported
            ffn_counts(reset=True)
            torch_sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, _ = M.forward(params, toks, cfg, flash_chunk=chunk)
            torch_sync()
            runs[name] = (logits, time.perf_counter() - t0,
                          torch.cuda.max_memory_allocated(), ffn_counts())
            del logits
    (lf, tf, mf, launches), (ld, td, md, _) = runs["flash"], runs["dense"]
    a, r = errors(lf, ld)
    print(f"flash attention ({cfg.name}, fp32, {cfg.n_layers} layers, "
          f"window {cfg.window}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.d_head}): one {DANUBE_TOKENS}-token forward in "
          f"{DANUBE_FLASH}-key chunks {tf:.3f} s, peak {mf / 2**30:.2f} GiB; "
          f"dense masked {td:.3f} s, peak {md / 2**30:.2f} GiB; logits max "
          f"abs err {a:.3e}, rel err {r:.3e}; launches fused FFN "
          f"{launches['k4']}, sparse matmul {launches['k3']} at "
          f"{DANUBE_TOKENS} rows [{card}]")
    require(r <= TOL, f"danube: flash vs dense rel err {r:.3e} > {TOL}")
    require(bool(torch.isfinite(lf).all()) and tuple(lf.shape) ==
            (1, DANUBE_TOKENS, cfg.padded_vocab), "danube: bad logits")
    require(launches == {"k3": cfg.n_layers, "k4": cfg.n_layers},
            f"danube: launches {launches}, expected one each a layer")
    del runs, lf, ld
    torch.cuda.empty_cache()
    recs = ffn_kernel_phase(params, cfg, card,
                            regimes=(("prefill", DANUBE_TOKENS),),
                            dtypes=("float32",))
    print(f"phase 14 (H2O-Danube3-4B) {time.perf_counter() - t_phase:.1f} s")
    return launches, recs


def moe_oracle(p, x, cfg, perm):
    """A plain per-expert MoE: the router as the model's, then for each
    expert its first ``cap`` assignments in (t, k) order, each token's
    output the sum of gate x FFN (torch.matmul) over its kept assignments.
    Returns (out, dropped assignments, tokens per expert)."""
    import torch
    import torch.nn.functional as F
    mc = cfg.moe
    require(cfg.act == "swiglu", f"the MoE oracle runs swiglu, not {cfg.act}")
    xt = x.reshape(-1, cfg.d_model)
    T, E, K = xt.shape[0], mc.num_experts, mc.top_k
    probs = torch.softmax((xt @ p["router"])[:, perm.long()], dim=-1)
    gates, ids = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = int(T * K / E * mc.capacity_factor) + 1
    ids_h = ids.cpu().numpy()
    taken = np.zeros(E, np.int64)
    kept = np.zeros((T, K), bool)
    for t in range(T):
        for k in range(K):
            e = ids_h[t, k]
            if taken[e] < cap:
                kept[t, k] = True
                taken[e] += 1
    contrib = torch.zeros((T, K, cfg.d_model), device=x.device)
    for e in range(E):
        ti, ki = np.nonzero((ids_h == e) & kept)
        if len(ti):
            xe = xt[ti]
            h = torch.matmul(F.silu(xe @ p["w_gate"][e]) * (xe @ p["w_in"][e]),
                             p["w_out"][e])
            contrib[ti, ki] = h * gates[ti, ki][:, None]
    return (contrib.sum(1).reshape(x.shape), int((~kept).sum()),
            np.bincount(ids_h.reshape(-1), minlength=E))


def moe_phase(dev, card):
    """Phase 15: Moonlight-16B-A3B at full width (64 experts of d_ff 1408,
    top-6, bf16, 4 of 48 layers) through ``generate``, and layer 0's
    ``moe_ffn`` in fp32 against a plain per-expert oracle."""
    import dataclasses
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve import GraphedServeStep, generate
    from repro_torch.sparsity import expert_balance as eb
    t_phase = time.perf_counter()
    cfg, params = build_family(dev, MOE_ARCH, layers=MOE_LAYERS,
                               sparse=False)
    mc = cfg.moe
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
        1, cfg.vocab, (MOE_REQUESTS, MOE_PROMPT)), device=dev)
    times, outs = [], []
    step = GraphedServeStep(cfg)        # held: the second run replays
    for run in (step, step, None):
        torch_sync()
        t0 = time.perf_counter()
        outs.append(generate(params, cfg, prompt, MOE_NEW,
                             compiled=run is not None, step=run))
        torch_sync()
        times.append(time.perf_counter() - t0)
    out = outs[0]
    require(torch.equal(outs[0], outs[1]), "moe: two runs differ")
    require(torch.equal(outs[0], outs[2]), "moe: the graphed generate's "
                                           "tokens != the eager one's")
    require(tuple(out.shape) == (MOE_REQUESTS, MOE_PROMPT + MOE_NEW)
            and bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
            "moe: bad generated tokens")
    toks = MOE_REQUESTS * MOE_NEW
    print(f"serving {cfg.name} ({mc.num_experts} experts of d_ff "
          f"{mc.d_ff_expert}, top-{mc.top_k}, capacity "
          f"{mc.capacity_factor}; {cfg.n_layers} layers, {cfg.dtype}) "
          f"through generate: {MOE_REQUESTS} requests, prompt {MOE_PROMPT}, "
          f"{MOE_NEW} new tokens, on the replayed decode step: "
          f"{toks / times[0]:.2f} tok/s (first calls and the capture in), "
          f"{toks / times[1]:.2f} tok/s the second run; the eager step "
          f"{toks / times[2]:.2f} tok/s; tokens bitwise the same; request "
          f"0: {out[0, MOE_PROMPT:MOE_PROMPT + 12].tolist()} [{card}]")
    decode_phase(cfg, params, card, MOE_REQUESTS, MOE_PROMPT)
    del step                            # its graphs and their pools

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p0 = M.map_tree(lambda t: t.float(), params["blocks"][0]["p0"]["moe"])
    perm = params["expert_perm"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((1, MOE_ORACLE_TOKENS, cfg.d_model), generator=gen,
                    device=dev)
    ya, _ = L.moe_ffn(p0, x, cfg32, perm)
    yb, _ = L.moe_ffn(p0, x, cfg32, perm)
    yo, dropped, per_expert = moe_oracle(p0, x, cfg32, perm)
    _, _, ids = L.moe_route(p0, x[0], cfg32, perm)
    counts = eb.expert_counts(ids, mc.num_experts).cpu().numpy()
    cap = L.moe_capacity(MOE_ORACLE_TOKENS, cfg32)
    port_dropped = int(np.maximum(counts - cap, 0).sum())
    a, r = errors(ya, yo)
    tracker = eb.ExpertLoadTracker(mc.num_experts)
    tracker.update(counts)
    new_perm = eb.rebalance(tracker, MOE_SHARDS)
    before = tracker.imbalance(MOE_SHARDS)
    after = eb.placement_imbalance(tracker.load, new_perm, MOE_SHARDS)
    print(f"  layer 0 moe_ffn, fp32, {MOE_ORACLE_TOKENS} tokens: max abs err "
          f"{a:.3e}, rel err {r:.3e} vs the per-expert oracle "
          f"(torch.matmul, TF32 off); two runs bitwise equal; capacity "
          f"{cap}, dropped {port_dropped} of "
          f"{MOE_ORACLE_TOKENS * mc.top_k} assignments (oracle {dropped}); "
          f"tokens per expert max {counts.max()} / mean "
          f"{counts.mean():.2f}; placement imbalance over {MOE_SHARDS} "
          f"shards {before:.4f} before rebalance, {after:.4f} after")
    require(r <= TOL, f"moe oracle: rel err {r:.3e} > {TOL}")
    require(torch.equal(ya, yb), "moe: moe_ffn differs between two runs")
    require(port_dropped == dropped and np.array_equal(counts, per_expert),
            f"moe: dropped {port_dropped} vs the oracle's {dropped}")
    require(after <= before + 1e-9, "moe: rebalance did not help")
    print(f"phase 15 (Moonlight-16B-A3B) {time.perf_counter() - t_phase:.1f}"
          f" s")


def mamba_phase(dev, card):
    """Phase 16: one Mamba block of Jamba-1.5-large at full width (fp32):
    the prefill handoff (``return_state``) and 8 decode steps against one
    block over all the tokens; then Jamba's smoke config end to end."""
    import dataclasses
    import torch
    from repro_torch.configs import load_config, load_smoke
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve import Request, Scheduler
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(load_config(MAMBA_ARCH), dtype="float32")
    m = cfg.mamba
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = L.init_mamba(gen, cfg, torch.float32)
    T, n = MAMBA_TOKENS, MAMBA_STEPS
    x = torch.randn((MAMBA_BATCH, T + n, cfg.d_model), generator=gen,
                    device=dev)
    torch_sync()
    t0 = time.perf_counter()
    whole = L.mamba_block(p, x, cfg)
    torch_sync()
    t_whole = time.perf_counter() - t0
    out, conv, h = L.mamba_block(p, x[:, :T], cfg, return_state=True)
    ys = []
    torch_sync()
    t0 = time.perf_counter()
    for t in range(T, T + n):
        y, conv, h = L.mamba_decode(p, x[:, t:t + 1], cfg, conv, h)
        ys.append(y)
    torch_sync()
    t_dec = (time.perf_counter() - t0) / n
    _, r_pre = errors(out, whole[:, :T])
    a, r_dec = errors(torch.cat(ys, 1), whole[:, T:])
    print(f"mamba ({cfg.name} block, fp32, d_model {cfg.d_model}, din "
          f"{m.expand * cfg.d_model}, d_state {m.d_state}, d_conv "
          f"{m.d_conv}, B {MAMBA_BATCH}): mamba_block over {T} tokens with "
          f"return_state then {n} mamba_decode steps vs one block over "
          f"{T + n}: prefill rel err {r_pre:.3e}, decode max abs err "
          f"{a:.3e}, rel err {r_dec:.3e}; {T + n}-token block {t_whole:.3f} "
          f"s, a decode step {t_dec * 1e3:.3f} ms (host clock) [{card}]")
    require(r_pre <= TOL and r_dec <= TOL,
            f"mamba handoff: rel err {r_pre:.3e} / {r_dec:.3e} > {TOL}")
    del p, x, whole
    torch.cuda.empty_cache()

    scfg = load_smoke(MAMBA_ARCH)
    sp = M.init_params(scfg, seed=SEED, device=dev)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        1, scfg.vocab, (2, 8)), device=dev)
    lf, _ = M.forward(sp, toks, scfg)
    cache = M.init_cache(scfg, 2, 8, device=dev)
    lp, cache = M.prefill(sp, scfg, toks[:, :7], cache)
    ld, _ = M.decode_step(sp, scfg, toks[:, 7:], cache, 7)
    _, r_p = errors(lp, lf[:, 6])
    _, r_d = errors(ld[:, 0], lf[:, 7])
    rng = np.random.default_rng(SEED)
    reqs = [Request(i, rng.integers(1, scfg.vocab, 6), 5, arrival=i)
            for i in range(3)]
    sch = Scheduler(scfg, sp, num_slots=2, max_len=16)
    got = sch.run(reqs)
    print(f"  {scfg.name} ({'+'.join(scfg.block_pattern)}, MoE every "
          f"{scfg.moe.every}) on the card: prefill rel err {r_p:.3e}, "
          f"decode_step {r_d:.3e} vs forward; Scheduler served "
          f"{sch.stats.tokens} tokens of {len(reqs)} requests on 2 slots")
    require(r_p <= TOL and r_d <= TOL,
            f"jamba smoke: rel err {r_p:.3e} / {r_d:.3e} > {TOL}")
    require(sch.idle and all(len(got[r.rid]) == 5 for r in reqs),
            "jamba smoke: the scheduler did not complete")
    print(f"phase 16 (Mamba) {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phases 18-19: the owed full-width runs, on the replayed decode step
# ---------------------------------------------------------------------------
def yi_phase(dev, card):
    """Phase 18: sparse Yi-34B at full width (d_model 7168, d_ff 20480
    swiglu, 56/8 heads of 128, bf16, density 0.35, 4 shards), 4 of 60
    layers: K3/K4 against their plain versions at its decode and prefill
    shapes (as phase 6), then phase 7's traffic through ``Scheduler`` on
    the replayed step (phase 7's checks). Returns (K3/K4 launches of the
    served run, kernel records)."""
    t_phase = time.perf_counter()
    cfg, params = build_family(dev, YI_ARCH, layers=YI_LAYERS)
    recs = ffn_kernel_phase(params, cfg, card)
    launches = lm_serving_phase(cfg, params, card)
    print(f"phase 18 (Yi-34B) {time.perf_counter() - t_phase:.1f} s")
    return launches, recs


def arctic_phase(dev, card):
    """Phase 19: one full-width Arctic-480B layer (128 experts top-2 of
    d_ff 4864 beside the shared dense FFN, bf16; ~27 GB of experts)
    through ``generate`` on the replayed step: 4 requests of prompt 128 +
    32 new tokens, tokens bitwise equal to the eager step's; the decode
    step graph against eager; the prompts' expert load at layer 0 and its
    placement imbalance over 4 shards before and after ``rebalance``; the
    phase's peak memory."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve import GraphedServeStep, generate
    from repro_torch.sparsity import expert_balance as eb
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = build_family(dev, ARCTIC_ARCH, layers=ARCTIC_LAYERS,
                               sparse=False)
    peak_build = torch.cuda.max_memory_allocated()
    mc = cfg.moe
    R, S0, new = ARCTIC_REQUESTS, ARCTIC_PROMPT, ARCTIC_NEW
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
        1, cfg.vocab, (R, S0)), device=dev)
    times, outs = [], []
    step = GraphedServeStep(cfg)        # held: the second run replays
    for run in (step, step, None):
        torch_sync()
        t0 = time.perf_counter()
        outs.append(generate(params, cfg, prompt, new,
                             compiled=run is not None, step=run))
        torch_sync()
        times.append(time.perf_counter() - t0)
    out = outs[0]
    require(torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2]),
            "arctic: graphed runs and the eager run differ")
    require(tuple(out.shape) == (R, S0 + new) and bool(
        ((out >= 0) & (out < cfg.padded_vocab)).all()),
        "arctic: bad generated tokens")
    toks = R * new
    print(f"serving {cfg.name} ({mc.num_experts} experts of d_ff "
          f"{mc.d_ff_expert}, top-{mc.top_k}, shared dense FFN "
          f"{mc.shared_dense_ff}; {cfg.n_layers} of 35 layers, {cfg.dtype}) "
          f"through generate: {R} requests, prompt {S0}, {new} new tokens, "
          f"on the replayed decode step: {toks / times[0]:.2f} tok/s (first "
          f"calls and the capture in), {toks / times[1]:.2f} the second run;"
          f" the eager step {toks / times[2]:.2f} tok/s; tokens bitwise the "
          f"same; request 0: {out[0, S0:S0 + 12].tolist()} [{card}]")
    decode_phase(cfg, params, card, R, S0)
    del step                            # its graphs and their pools
    # the prompts' routing at layer 0: its MoE input after the attention
    bp = params["blocks"][0]["p0"]
    x = params["embed"][prompt].to(cfg.torch_dtype)
    pos = torch.arange(S0, device=dev)[None].expand(R, S0)
    x = x + L.attention(bp["attn"], L.rmsnorm(x, bp["ln1"], cfg.norm_eps),
                        cfg, positions=pos,
                        mask=L.causal_mask(S0, S0, cfg.window, device=dev))
    h2 = L.rmsnorm(x, bp["ln2"], cfg.norm_eps).reshape(R * S0, -1)
    _, _, ids = L.moe_route(bp["moe"], h2, cfg, params["expert_perm"])
    counts = eb.expert_counts(ids, mc.num_experts).cpu().numpy()
    tracker = eb.ExpertLoadTracker(mc.num_experts)
    tracker.update(counts)
    new_perm = eb.rebalance(tracker, MOE_SHARDS)
    before = tracker.imbalance(MOE_SHARDS)
    after = eb.placement_imbalance(tracker.load, new_perm, MOE_SHARDS)
    peak = torch.cuda.max_memory_allocated()
    print(f"  layer 0 expert load of the {R} x {S0} prompt tokens (top-"
          f"{mc.top_k}): max {counts.max()} / mean {counts.mean():.2f} / "
          f"min {counts.min()} tokens per expert, {int((counts == 0).sum())}"
          f" experts idle; placement imbalance over {MOE_SHARDS} shards "
          f"{before:.4f} before rebalance, {after:.4f} after; peak memory "
          f"{peak_build / 2**30:.2f} GiB at the build, {peak / 2**30:.2f} "
          f"GiB over the phase")
    require(counts.sum() == R * S0 * mc.top_k, "arctic: routed counts")
    require(after <= before + 1e-9, "arctic: rebalance did not help")
    print(f"phase 19 (Arctic-480B) {time.perf_counter() - t_phase:.1f} s")


def pali_phase(dev, card):
    """Phase 17: sparse PaliGemma-3B at full width (bf16, 4 of 18 layers):
    a forward of 256 stub patch embeddings as the prefix plus 16 text
    tokens, 4 images, against the densified-FFN forward in fp32. Returns
    (K3/K4 launches of the bf16 forward, kernel records)."""
    import torch
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    cfg, params = build_family(dev, PALI_ARCH, layers=PALI_LAYERS)
    B, P = PALI_BATCH, cfg.frontend_len
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prefix = 0.02 * torch.randn((B, P, cfg.d_model), generator=gen,
                                device=dev)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        1, cfg.vocab, (B, PALI_TEXT)), device=dev)
    ffn_counts(reset=True)
    torch_sync()
    t0 = time.perf_counter()
    logits, _ = M.forward(params, toks, cfg, prefix_embeds=prefix)
    torch_sync()
    dt = time.perf_counter() - t0
    launches = ffn_counts()
    require(launches == {"k3": cfg.n_layers, "k4": cfg.n_layers},
            f"paligemma: launches {launches}, expected one each a layer")
    require(tuple(logits.shape) == (B, PALI_TEXT, cfg.padded_vocab)
            and bool(torch.isfinite(logits).all()),
            f"paligemma: logits {tuple(logits.shape)}, not the text rows")
    cfg32, p32, oracle, cfg_dense = densified_fp32(cfg, params)
    ls, _ = M.forward(p32, toks, cfg32, prefix_embeds=prefix)
    lo, _ = M.forward(oracle, toks, cfg_dense, prefix_embeds=prefix)
    _, rel = errors(ls, lo)
    torch_sync()
    print(f"prefix forward ({cfg.name}, {cfg.n_layers} layers, {cfg.dtype}): "
          f"{B} x ({P} patch embeddings + {PALI_TEXT} tokens) = "
          f"{B * (P + PALI_TEXT)} rows through the geglu FFN kernels in "
          f"{dt:.3f} s (host clock, first call); logits {tuple(logits.shape)}"
          f" (prefix stripped); launches fused FFN {launches['k4']}, sparse "
          f"matmul {launches['k3']}; fp32 logits rel err {rel:.3e} vs "
          f"densified-weight FFNs (TF32 off) [{card}]")
    require(rel <= TOL, f"paligemma oracle: rel err {rel:.3e} > {TOL}")
    del p32, oracle, ls, lo
    torch.cuda.empty_cache()
    recs = ffn_kernel_phase(params, cfg, card, regimes=(
        ("decode", LM_SLOTS), ("prefix forward", B * (P + PALI_TEXT))))
    print(f"phase 17 (PaliGemma-3B) {time.perf_counter() - t_phase:.1f} s")
    return launches, recs


# ---------------------------------------------------------------------------
# phase 11: lazy im2col (K1's tap-slab operand), autotuning, VisionServer
# ---------------------------------------------------------------------------
# lint: ignore[EAGER-GUARD] builds its schedules eagerly, before any capture
def tap_slab_phase(model, imgs, layer: int, card: str):
    """K1 reading the tap slabs straight from the NHWC map at one VGG16
    layer: against its plain version and, bitwise, against K1 on the taps
    patch matrix; timed beside its bound, the taps path (im2col and K1),
    and one dense ``F.conv2d``. Returns the record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.grid import tap_geometry
    from repro_torch.kernels.sparse_conv import (sparse_conv2d_nhwc,
                                                 worklist_spmm_slabs,
                                                 worklist_spmm_slabs_plain)
    from repro_torch.kernels.worklist_core import (activation_occupancy,
                                                   build_worklist, walk_mode,
                                                   worklist_spmm)
    lay = model.layers[layer]
    c, w = lay.conv, lay.conv.packed
    x, flat, m_img, m_pad = layer_inputs(model, layer, imgs)
    x = x.contiguous()
    B = x.shape[0]
    bm_rows, sub_m = 128, 8
    mpi = m_pad // bm_rows
    wl = build_worklist(w.host_indices(), B * mpi, mb_per_img=mpi)
    kw = dict(kh=c.kh, kw=c.kw, stride=lay.stride, padding=lay.padding,
              bk=w.bk, bn=w.bn, bm_rows=bm_rows, sub_m=sub_m, m_pad=m_pad,
              act="relu", emit_occupancy=True)
    out, occ = worklist_spmm_slabs(x, w.vals, wl, **kw)
    pout, pocc = worklist_spmm_slabs_plain(x, w.vals, wl, **kw)
    kw1 = dict(bk=w.bk, bn=w.bn, bm_rows=bm_rows, sub_m=sub_m, act="relu",
               emit_occupancy=True)
    tout, tocc = worklist_spmm(flat, w.vals, wl, mb_per_img=mpi, ncolors=2,
                               **kw1)
    torch.cuda.synchronize()
    abs_, rel = errors(out, pout)
    at = (f"VGG16 layer {layer} ({c.kh}x{c.kw}x{c.cin}->{c.cout}), {B} "
          f"images, {imgs.shape[1]} px, chunk pattern, bk={w.bk} bn={w.bn}")
    require(rel <= TOL, f"tap slabs vs plain at layer {layer}: rel "
                        f"{rel:.3e}")
    require(torch.equal(occ, pocc),
            f"tap-slab occupancy differs from plain at layer {layer}")
    require(torch.equal(out, tout) and torch.equal(occ, tocc),
            f"tap slabs != K1 on the patch matrix bitwise at layer {layer}")
    geom = tap_geometry(x.shape, c.kh, c.kw, lay.stride, lay.padding,
                        m_pad=m_pad)
    grid = walk_mode(x, w.vals, None, wl, bk=w.bk, bn=w.bn, bm_rows=bm_rows,
                     taps=geom).describe()
    k_ms = graph_ms(lambda: worklist_spmm_slabs(x, w.vals, wl, **kw),
                    reps=20)
    p_ms = cuda_ms(lambda: worklist_spmm_slabs_plain(x, w.vals, wl, **kw),
                   reps=3)
    k1_ms = graph_ms(lambda: worklist_spmm(flat, w.vals, wl, mb_per_img=mpi,
                                          ncolors=2, **kw1), reps=20)
    # the layer call either way: im2col (stack, pad), K1 and the output copy
    # for taps; K1 on the map and the output copy for lazy
    layer_kw = dict(stride=lay.stride, padding=lay.padding, sub_m=sub_m,
                    bm_rows=bm_rows, layout=c.layout, emit_occupancy=True,
                    wl_cache={B * mpi: wl})
    taps_ms = graph_ms(lambda: sparse_conv2d_nhwc(
        x, w, c.kh, c.kw, c.cout, im2col="taps", **layer_kw), reps=10)
    lazy_ms = graph_ms(lambda: sparse_conv2d_nhwc(
        x, w, c.kh, c.kw, c.cout, im2col="lazy", **layer_kw), reps=10)
    torch.backends.cudnn.allow_tf32 = False
    xn = x.permute(0, 3, 1, 2).contiguous()
    wd = torch.as_tensor(c.w_dense, device=x.device).permute(3, 2, 0, 1) \
        .contiguous()
    lib_ms = graph_ms(lambda: F.conv2d(xn, wd, padding=c.kh // 2), reps=10)
    # the function's needs: a MAC for every occupied sub_m-row sub-block of
    # a stored chunk; the map, the stored weights and the output of the
    # real rows moved once
    idx = w.host_indices()
    per_chunk = activation_occupancy(flat, sub_m, w.bk).sum(0).cpu().numpy()
    live_macs = int(per_chunk[idx[idx >= 0]].sum())
    rows = B * m_img
    nbytes = 4.0 * (x.numel() + int((idx >= 0).sum()) * w.bk * w.bn
                    + rows * w.n_blocks * w.bn + rows // sub_m * w.n_blocks)
    b_ms, b_by = bound(2.0 * sub_m * w.bk * w.bn * live_macs, nbytes)
    print(f"tap slabs @ {at} [{card}]")
    print(f"  walker, tap-slab operand: max abs err {abs_:.3e}, max rel err "
          f"{rel:.3e}, occupancy equal to the plain version, bitwise equal "
          f"to K1 on the taps patch matrix (output and occupancy); {grid}; "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}); K1 on the patch matrix {k1_ms:.4f} ms; the layer call "
          f"with taps (im2col + K1) {taps_ms:.4f} ms, lazy {lazy_ms:.4f} ms;"
          f" dense conv2d {lib_ms:.4f} ms")
    return {"at": at, "mode": "tile, tap slabs", "max_abs_err": abs_,
            "max_rel_err": rel, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "grid": grid, "patch_matrix_k1_ms": k1_ms,
            "taps_layer_ms": taps_ms, "lazy_layer_ms": lazy_ms}


def pin_lazy(model):
    """Every tap-layout layer tuned to the lazy operand at 128-row blocks
    and its pack-time bn (the stem keeps the global knobs)."""
    from repro_torch.kernels.autotune import ConvTileConfig, autotune_conv
    from repro_torch.vision import layer_geometry
    for layer, g in zip(model.layers, layer_geometry(model, SIZE)):
        c = layer.conv
        if c.layout == "tap":
            autotune_conv(c, g["m_img"], batch=4, candidates=[ConvTileConfig(
                bm_rows=128, bn=c.packed.bn, sub_m=8, im2col="lazy")])


def lazy_forward_split(model, x0, card: str):
    """The lazy forward against the taps (default) one, each replayed from
    its graph and eager, in turns, each traced once. Returns the record."""
    from repro_torch.vision import compile_forward, graphed_forward
    n_lazy = sum(1 for layer in model.layers if layer.conv.tuned is not None
                 and layer.conv.tuned.config.im2col == "lazy")
    print(f"lazy forward: tap slabs at {n_lazy} layers")
    fns = {"graph (lazy)": graphed_forward(model, use_tuned=True),
           "eager (lazy)": compile_forward(model, use_tuned=True),
           "graph (taps)": graphed_forward(model),
           "eager (taps)": compile_forward(model)}
    return {"images": x0.shape[0], "lazy_layers": n_lazy,
            **forwards_compared(fns, x0, card, traced=tuple(fns))}


def tuned_oracle(model, x, card: str):
    """``oracle_check`` of a tuned model: every layer through the dense
    grid (K2) at its tuned row block and ``sub_m`` (lazy demotes to taps
    there), held to the dense oracle. Returns the rel err."""
    import torch
    from repro_torch.kernels.sparse_conv import sparse_conv2d_nhwc
    from repro_torch.vision import dense_forward, max_pool
    h = x
    with torch.no_grad():
        for layer in model.layers:
            c, cfg = layer.conv, layer.conv.tuned.config
            h, _ = sparse_conv2d_nhwc(
                h, c.packed, c.kh, c.kw, c.cout, stride=layer.stride,
                padding=layer.padding, sub_m=cfg.sub_m, bm_rows=cfg.bm_rows,
                im2col=cfg.im2col, layout=c.layout, schedule="dense",
                emit_occupancy=True, count_macs=True, wl_cache=c.wl_cache)
            if layer.pool_after is not None:
                h = max_pool(h, *layer.pool_after)
        ref = dense_forward(model, x)
    _, rel = errors(h, ref)
    return rel


def autotune_phase(model, x0, default, card: str):
    """``autotune_model`` modelled, then ``measure=True``: the per-layer
    picks and their measured times, the tuned forwards bitwise equal to the
    default, and the tuned oracle. Returns the table."""
    import torch
    from repro_torch.kernels.autotune import autotune_model
    from repro_torch.kernels.sparse_conv import CONV_GRID
    from repro_torch.vision import compile_forward
    t0 = time.perf_counter()
    modelled = autotune_model(model, SIZE, batch=x0.shape[0])
    t_mod = time.perf_counter() - t0
    out = compile_forward(model, use_tuned=True)(x0)
    torch.cuda.synchronize()
    require(torch.equal(out, default),
            "the modelled tuned forward != the default forward bitwise")
    grid_before = CONV_GRID.launches
    rel_mod = tuned_oracle(model, x0[:1], card)
    require(CONV_GRID.launches > grid_before,
            "the tuned oracle never launched the dense grid")
    require(rel_mod <= TOL, f"tuned (modelled) oracle rel err {rel_mod:.3e}")
    t0 = time.perf_counter()
    measured = autotune_model(model, SIZE, batch=x0.shape[0], measure=True,
                              x=x0)
    t_meas = time.perf_counter() - t0
    out = compile_forward(model, use_tuned=True)(x0)
    torch.cuda.synchronize()
    require(torch.equal(out, default),
            "the measured tuned forward != the default forward bitwise")
    rel_meas = tuned_oracle(model, x0[:1], card)
    require(rel_meas <= TOL, f"tuned (measured) oracle rel err "
                             f"{rel_meas:.3e}")
    rows, agree = [], 0
    print(f"autotune, VGG16 at {SIZE} px, batch {x0.shape[0]}: modelled "
          f"{t_mod:.1f} s, measured {t_meas:.1f} s (each candidate a layer "
          f"call, CUDA events over 5 calls) [{card}]")
    print("  layer | modelled pick (bm, bn, im2col): its measured ms | "
          "measured pick: ms")
    for i in sorted(measured):
        m_cfg = modelled[i].config
        by_key = {cfg.key(): cost for cfg, cost, _ in measured[i].table}
        m_ms = by_key[m_cfg.key()] * 1e3
        w_cfg, w_ms = measured[i].config, measured[i].cost * 1e3
        agree += m_cfg.key() == w_cfg.key()
        rows.append({"layer": i,
                     "modelled": [m_cfg.bm_rows, m_cfg.bn, m_cfg.im2col],
                     "modelled_ms": m_ms,
                     "measured": [w_cfg.bm_rows, w_cfg.bn, w_cfg.im2col],
                     "measured_ms": w_ms})
        print(f"  L{i} | ({m_cfg.bm_rows}, {m_cfg.bn}, {m_cfg.im2col}): "
              f"{m_ms:.4f} | ({w_cfg.bm_rows}, {w_cfg.bn}, {w_cfg.im2col})"
              f": {w_ms:.4f}")
    print(f"  the picks agree at {agree} of {len(rows)} layers; the tuned "
          f"forwards (modelled, measured) bitwise equal to the default; "
          f"tuned oracle (K2 at the tuned row blocks) rel err {rel_mod:.3e} "
          f"/ {rel_meas:.3e}")
    return {"layers": rows, "agree": agree, "oracle_rel_err":
            [rel_mod, rel_meas], "card": card}


def server_phase(model, card: str):
    """``VisionServer`` on a virtual clock: 12 requests of mixed sizes into
    buckets of 112 and 224 px on 4 slots (the larger ones downscaled), 0
    SLA misses, every output bitwise equal to the solo forward of its
    fitted image. Returns the walker's launches of the served run."""
    import torch
    from repro_torch.kernels.worklist_core import WALK
    from repro_torch.launch.vision import blob_images
    from repro_torch.serve.vision import VirtualClock, VisionServer
    from repro_torch.vision import (ImageRequest, compile_forward, fit_image,
                                    route_bucket)
    from repro_torch.core import simulator as S
    rng = np.random.default_rng(SEED + 11)
    big = blob_images(rng, 12, 300, S.BENCHMARKS["VGGNet"].map_density)
    sizes = [(100, 90), (112, 112), (150, 120), (224, 200), (300, 260),
             (80, 112), (224, 224), (240, 224), (112, 60), (180, 224),
             (260, 300), (64, 64)]
    reqs = [ImageRequest(rid=i, image=big[i, :h, :w], arrival_s=0.004 * i,
                         deadline_s=0.004 * i + 0.5)
            for i, (h, w) in enumerate(sizes)]
    runs = {}
    for compiled in (True, False):
        srv = VisionServer(model, num_slots=4, buckets=(112, 224),
                           clock=VirtualClock(), step_cost_s={112: 0.01,
                                                              224: 0.03},
                           compiled=compiled)
        srv.warmup()
        WALK.launches = 0
        produced = srv.run(reqs)
        torch.cuda.synchronize()
        runs[compiled] = (srv, produced, WALK.launches)
    srv, produced, launches = runs[True]
    eager_srv, eager_out, eager_launches = runs[False]
    st = srv.stats
    require(st.images == len(reqs) and st.sla_misses == 0,
            f"server: {st.sla_misses} SLA misses of {st.images}")
    require(launches == st.engine_steps * model.num_layers == eager_launches,
            f"the server launched the walker {launches} times (eager "
            f"{eager_launches}), expected {model.num_layers} a step")
    solo = compile_forward(model)
    for r in reqs:
        canon = fit_image(r.image, route_bucket(srv.buckets,
                                                *r.image.shape[:2]))
        one = solo(torch.as_tensor(canon[None], device=model.device))[0]
        got = produced[r.rid]
        require(np.isfinite(got).all() and np.array_equal(
            got, one.cpu().numpy()) and np.array_equal(got, eager_out[r.rid]),
            f"server request {r.rid}: output != the solo eager forward of "
            f"its fitted image")
    sc = srv.schedule_counters()
    lat = st.latency_percentiles()
    print(f"VisionServer (virtual clock, step costs 0.01 / 0.03 s, SLA 0.5 "
          f"s): {st.images} requests on 4 slots into buckets "
          f"{dict(sorted(st.bucket_steps.items()))} steps, {st.sla_misses} "
          f"SLA misses, latency p50 {lat['p50']:.3f} / p95 {lat['p95']:.3f} "
          f"s (virtual), slot utilization {st.slot_utilization:.3f}, "
          f"cross-request combine factor "
          f"{sc['cross_request_combine_factor']:.2f}x; every output (graph "
          f"and eager) bitwise equal to the solo eager forward of its fitted"
          f" image; walker launches {launches} "
          f"({launches / st.engine_steps:.0f} a step, all replays; eager "
          f"{eager_launches}); host clock {st.wall_s:.4f} s = "
          f"{st.img_per_s:.2f} img/s replayed, eager "
          f"{eager_srv.stats.wall_s:.4f} s = "
          f"{eager_srv.stats.img_per_s:.2f} img/s (compile_s "
          f"{st.compile_s:.3f} / {eager_srv.stats.compile_s:.3f} s) [{card}]")
    return launches


def lazy_phase(card: str):
    """Phase 11 on a fresh VGG16 (chunk pattern): the tap-slab operand at
    layers 1 and 8, the lazy forward, autotuning, and the server. Returns
    the walker's tap-slab records and its launches by path."""
    import torch
    from repro_torch.core import simulator as S
    from repro_torch.kernels.worklist_core import WALK
    from repro_torch.launch.vision import blob_images
    from repro_torch.vision import (build_vision_model, compile_forward,
                                    graphed_forward)
    dev = torch.device("cuda")
    md = S.BENCHMARKS["VGGNet"].map_density
    imgs = blob_images(np.random.default_rng(SEED), 4, SIZE, md)
    model = build_vision_model("VGGNet", pattern="chunk", seed=SEED,
                               device=dev)
    recs = [tap_slab_phase(model, imgs, layer, card) for layer in (1, 8)]
    x0 = torch.as_tensor(imgs, device=dev)
    default = compile_forward(model)(x0)
    pin_lazy(model)
    WALK.launches = 0
    lazy = compile_forward(model, use_tuned=True)(x0)
    torch.cuda.synchronize()
    lazy_launches = WALK.launches
    require(lazy_launches == model.num_layers,
            f"the lazy forward launched the walker {lazy_launches} times")
    require(torch.equal(lazy, default),
            "the lazy forward != the taps forward bitwise")
    glazy = graphed_forward(model, use_tuned=True)
    require(all(torch.equal(glazy(x0), default) for _ in range(2)),
            "the replayed lazy forward != the taps forward bitwise")
    print(f"lazy forward ({model.num_layers - 1} tap-layout layers on the "
          f"tap-slab operand): eager and replayed bitwise equal to the taps "
          f"forward, {lazy_launches} walker launches")
    split = lazy_forward_split(model, x0, card)
    tune = autotune_phase(model, x0, default, card)
    server = server_phase(model, card)
    recs[0]["lazy_forward"] = split
    recs[0]["autotune"] = tune
    return recs, {"vgg16_lazy_forward": lazy_launches,
                  "vgg16_vision_server": server}


# lint: ignore[EAGER-GUARD] builds its schedules eagerly, before any capture
def sharded_walks(model, imgs, card: str):
    """Phase 21(a): each cout-sharded VGG16 layer (its shard map the
    contiguous equal-count form at MESH_DEVICES) walked per device through
    ``worklist_spmm_padded`` (K1 over the device's local work list), one
    device after another on the one card, concatenated in ring order and
    held bitwise to K1 over the whole list (output and occupancy), and
    within TOL of the plain walk of the whole list (occupancy exactly).
    Returns the per-layer records and the walker's launches of the
    per-device walks."""
    import torch
    from repro_torch.kernels.worklist_core import (WALK, build_worklist,
                                                   per_shard_steps,
                                                   shard_imbalance,
                                                   worklist_spmm,
                                                   worklist_spmm_padded,
                                                   worklist_spmm_plain)
    d = MESH_DEVICES
    recs, launches = [], 0
    for layer, lay in enumerate(model.layers):
        w = lay.conv.packed
        expect = np.repeat(np.arange(d), w.n_blocks // d)
        if w.shard_of is None or w.n_blocks % d or \
                not np.array_equal(w.shard_of, expect):
            continue
        x, flat, m_img, m_pad = layer_inputs(model, layer, imgs)
        mpi = m_pad // 128
        wl = build_worklist(w.host_indices(), flat.shape[0] // 128,
                            mb_per_img=mpi, shard_of=w.shard_of)
        kw = dict(bk=w.bk, bn=w.bn, bm_rows=128, sub_m=8, mb_per_img=mpi,
                  ncolors=2, act="relu", emit_occupancy=True)
        whole, wocc = worklist_spmm(flat, w.vals, wl, **kw)
        nbl = w.n_blocks // d
        parts = [w.vals[i * nbl:(i + 1) * nbl] for i in range(d)]
        WALK.launches = 0
        slabs = [worklist_spmm_padded(flat, parts[i], wl, i, d, **kw)
                 for i in range(d)]
        torch.cuda.synchronize()
        launches += WALK.launches
        require(WALK.launches == d, f"layer {layer + 1}: {WALK.launches} "
                                    f"walker launches for {d} devices")
        cat_out = torch.cat([s[0] for s in slabs], dim=1)
        cat_occ = torch.cat([s[1] for s in slabs], dim=1)
        require(torch.equal(cat_out, whole) and torch.equal(cat_occ, wocc),
                f"layer {layer + 1}: the per-device walks != K1 over the "
                f"whole list")
        pout, pocc = worklist_spmm_plain(flat, w.vals, wl, bk=w.bk, bn=w.bn,
                                         bm_rows=128, sub_m=8, act="relu",
                                         emit_occupancy=True)
        abs_err, rel_err = errors(cat_out, pout)
        require(rel_err <= TOL, f"layer {layer + 1}: the per-device walks vs "
                                f"the plain walk: rel {rel_err:.3e}")
        require(torch.equal(cat_occ, pocc),
                f"layer {layer + 1}: the per-device occupancy differs from "
                f"the plain walk's")
        dev_ms = [graph_ms(lambda i=i: worklist_spmm_padded(
            flat, parts[i], wl, i, d, **kw), reps=20) for i in range(d)]
        whole_ms = graph_ms(lambda: worklist_spmm(flat, w.vals, wl, **kw),
                            reps=20)
        steps = per_shard_steps(wl, num_shards=d)
        t_imb = max(dev_ms) / (sum(dev_ms) / d) - 1.0
        rec = {"layer": layer + 1, "shard_of": [int(s) for s in w.shard_of],
               "device_ms": dev_ms, "whole_ms": whole_ms,
               "per_shard_steps": [int(s) for s in steps],
               "step_imbalance": shard_imbalance(steps),
               "time_imbalance": t_imb, "max_abs_err": abs_err,
               "rel_err": rel_err}
        recs.append(rec)
        print(f"cout-sharded VGG16 layer {layer + 1} "
              f"({lay.conv.cin}->{lay.conv.cout}, {imgs.shape[0]} images, "
              f"{d} devices walked in turn on one card): per-device K1 ms "
              f"{[round(t, 4) for t in dev_ms]}, whole list {whole_ms:.4f} "
              f"ms, per-shard steps {rec['per_shard_steps']}, step "
              f"imbalance {rec['step_imbalance']:.4f}, time imbalance "
              f"{t_imb:.4f}; concatenated slabs and occupancy bitwise equal "
              f"to K1 over the whole list, vs plain max abs {abs_err:.3e} "
              f"rel {rel_err:.3e} (tol {TOL}) [{card}]")
    require(len(recs) == 6, f"{len(recs)} layers carry the 4-way shard map,"
                            f" expected layers 8-13")
    return recs, launches


def one_rank_mesh(model, imgs, card: str):
    """Phase 21(b): a one-rank NCCL world and ``data_mesh(1)``: the replayed
    forward on 4 images, ``VisionEngine`` on 8 requests and ``VisionServer``
    on 6, each through the mesh, bitwise equal to the solo eager forward,
    with the walker's launches counted from zero and held exactly. Returns
    the launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.worklist_core import WALK
    from repro_torch.serve.vision import VirtualClock, VisionServer
    from repro_torch.vision import (ImageRequest, VisionEngine,
                                    compile_forward, graphed_forward)
    from repro_torch.vision.mesh import data_mesh
    dev = model.device
    mesh = data_mesh(1, device=dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    require(dist.get_backend() == backend and
            dist.get_world_size() == 1,
            f"the one-rank world is not {backend} of size 1")
    solo = compile_forward(model)
    x4 = torch.as_tensor(imgs[:4], device=dev)
    want = solo(x4)
    layers = model.num_layers
    WALK.launches = 0
    fwd = graphed_forward(model, mesh=mesh)
    got = [fwd(x4) for _ in range(3)]           # eager + capture, replays
    torch.cuda.synchronize()
    fwd_launches = WALK.launches
    require(all(torch.equal(g, want) for g in got),
            "graphed_forward(mesh=) != the solo forward bitwise")
    require(fwd_launches == 3 * layers,
            f"graphed_forward(mesh=) launched the walker {fwd_launches} "
            f"times, expected {3 * layers}")
    reqs = [ImageRequest(rid=i, image=imgs[i], arrival=i // 3)
            for i in range(8)]
    WALK.launches = 0
    eng = VisionEngine(model, num_slots=4, mesh=mesh)
    produced = eng.run(reqs)
    torch.cuda.synchronize()
    eng_launches = WALK.launches
    forwards = eng.stats.engine_steps + 1
    require(eng_launches == forwards * layers,
            f"the mesh engine launched the walker {eng_launches} times, "
            f"expected {forwards * layers}")
    for r in reqs:
        one = solo(torch.as_tensor(r.image[None], device=dev))[0]
        require(np.array_equal(produced[r.rid], one.cpu().numpy()),
                f"mesh engine request {r.rid} != the solo forward")
    sc = eng.schedule_counters()
    require(sc["num_devices"] == 1 and sc["step_imbalance"] == 0.0,
            f"mesh engine counters {sc}")
    sreqs = [ImageRequest(rid=i, image=imgs[i], arrival_s=0.004 * i,
                          deadline_s=0.004 * i + 0.5) for i in range(6)]
    srv = VisionServer(model, num_slots=4, buckets=(SIZE,),
                       clock=VirtualClock(), step_cost_s=0.03, mesh=mesh)
    srv.warmup()
    WALK.launches = 0
    served = srv.run(sreqs)
    torch.cuda.synchronize()
    srv_launches = WALK.launches
    require(srv_launches == srv.stats.engine_steps * layers and
            srv.stats.sla_misses == 0,
            f"the mesh server launched the walker {srv_launches} times "
            f"in {srv.stats.engine_steps} steps, "
            f"{srv.stats.sla_misses} SLA misses")
    for r in sreqs:
        one = solo(torch.as_tensor(r.image[None], device=dev))[0]
        require(np.array_equal(served[r.rid], one.cpu().numpy()),
                f"mesh server request {r.rid} != the solo forward")
    print(f"one-rank NCCL data mesh: graphed_forward(mesh=) on 4 images "
          f"(3 calls, {fwd_launches} walker launches), VisionEngine("
          f"mesh=) 8 requests in {eng.stats.engine_steps} steps "
          f"({eng_launches} launches, per-device steps "
          f"{sc['per_device_steps']}), VisionServer(mesh=) 6 requests "
          f"in {srv.stats.engine_steps} steps ({srv_launches} launches):"
          f" every output bitwise equal to the solo eager forward "
          f"[{card}]")
    return fwd_launches + eng_launches + srv_launches


# lint: ignore[EAGER-GUARD] counts the schedules' steps on the host
def local_width_times(model, imgs, card: str):
    """Phase 21(c): one rank's share of a data-parallel batch of 8: the
    replayed VGG16 forward at local widths 8, 4, 2 and 1 (D = 1, 2, 4, 8),
    its ms (CUDA-graph replays) and ``t(8) / t(8 / D)`` beside the
    step-count speed-up. One card: no traffic between cards."""
    import torch
    from repro_torch.kernels.worklist_core import build_worklist
    from repro_torch.vision import compile_forward, layer_geometry
    fwd = compile_forward(model)
    x8 = torch.as_tensor(imgs, device=model.device)
    geo = layer_geometry(model, SIZE)
    rows = []
    for d in (1, 2, 4, 8):
        b = 8 // d
        x = x8[:b].contiguous()
        ms = graph_ms(lambda: fwd(x), reps=3)
        steps = sum(build_worklist(lay.conv.packed.host_indices(),
                                   b * g["mb_per_img"]).num_steps
                    for lay, g in zip(model.layers, geo))
        rows.append({"devices": d, "local_images": b, "ms": ms,
                     "per_device_steps": steps})
    for r in rows:
        r["time_speedup"] = rows[0]["ms"] / r["ms"]
        r["device_step_speedup"] = rows[0]["per_device_steps"] / \
            r["per_device_steps"]
        print(f"data-parallel share D={r['devices']}: {r['local_images']} "
              f"images a rank, replayed forward {r['ms']:.4f} ms, "
              f"t(8)/t(8/D) {r['time_speedup']:.3f} vs step-count speed-up "
              f"{r['device_step_speedup']:.3f} ({r['per_device_steps']} "
              f"steps a device) [{card}]")
    return rows


def mesh_phase(dev, card: str):
    """Phase 21 on VGG16 packed for MESH_DEVICES clusters: the per-device
    walks of its cout-sharded layers, the one-rank NCCL data mesh, and one
    rank's share of a data-parallel batch. Returns the record and the
    walker's launches by path."""
    from repro_torch.core import simulator as S
    from repro_torch.launch.vision import blob_images
    from repro_torch.vision import build_vision_model
    t0 = time.perf_counter()
    md = S.BENCHMARKS["VGGNet"].map_density
    imgs = blob_images(np.random.default_rng(SEED), 8, SIZE, md)
    model = build_vision_model("VGGNet", pattern="chunk", seed=SEED,
                               mesh_devices=MESH_DEVICES, device=dev)
    walks, walk_launches = sharded_walks(model, imgs[:4], card)
    mesh_launches = one_rank_mesh(model, imgs, card)
    widths = local_width_times(model, imgs, card)
    print(f"phase 21 took {time.perf_counter() - t0:.1f} s")
    return {"cout_sharded_layers": walks, "local_widths": widths}, \
        {"vgg16_cout_sharded_walks": walk_launches,
         "vgg16_data_mesh": mesh_launches}



def leaves_bitwise(a, b) -> list:
    """Keys of the leaves of two trees (params, an OptState, metrics) whose
    bits differ."""
    import torch
    from repro_torch.models import model as M
    fa, fb = M.flatten_tree(a), M.flatten_tree(b)
    require(list(fa) == list(fb), "trees of different structure")
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 \
        else t                                               # noqa: E731
    return [k for k in fa if fa[k].dtype != fb[k].dtype
            or not torch.equal(bits(fa[k]), bits(fb[k]))]


def train_fp64_gate(dev, card):
    """Phase 20's fp64 gate: one full-width Qwen3-4B layer in fp32 (TF32
    off), batch FP64_BATCH x FP64_SEQ: the card's step (remat on) against
    the same step on fp64 params under ``promote_fp64`` (its gradients
    with remat off, then AdamW). The loss, the grad norm and every gradient
    leaf within rel err TOL.

    The params after the AdamW step are held to TOL plus what AdamW makes
    of the gradients' own rounding: at step 1 the update is ``lr * g / (|g|
    + eps)``, so a gradient error e at |g| ~ eps moves a param by up to
    ``lr * e / eps`` (e taken per leaf from this run's two gradients); and
    AdamW's own fp32 arithmetic (the same gradients, rounded to fp32, into
    both) within rel err TOL."""
    import dataclasses
    import torch
    from repro_torch.configs import ShapeConfig, load_config
    from repro_torch.data.pipeline import batch_for
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (loss_and_grads,
                                              make_train_step, promote_fp64)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(load_config(LM_ARCH), n_layers=1,
                              dtype="float32")
    c64 = dataclasses.replace(cfg, dtype="float64")
    params = M.init_params(cfg, seed=SEED, device=dev)
    p64 = M.map_tree(lambda t: t.double() if t.is_floating_point() else t,
                     params)
    batch = batch_for(cfg, ShapeConfig("fp64", FP64_SEQ, FP64_BATCH,
                                       "train"), 0, seed=SEED, device=dev)
    opt_cfg = adamw.AdamWConfig(warmup_steps=0)
    l32, _, g32 = loss_and_grads(params, batch, cfg)
    n32, _, m32 = make_train_step(cfg, opt_cfg)(params, adamw.init(params),
                                                batch)
    with promote_fp64():
        l64, _, g64 = loss_and_grads(p64, batch, c64, remat=False)
        n64, _, m64 = adamw.apply(opt_cfg, p64, g64, adamw.init(p64))
    # AdamW alone: the fp64 gradients rounded to fp32, into both
    g_q = M.map_tree(lambda g: g.float(), g64)
    nq32 = adamw.apply(opt_cfg, params, g_q, adamw.init(params))[0]
    with promote_fp64():
        nq64 = adamw.apply(opt_cfg, p64, M.map_tree(torch.Tensor.double, g_q),
                           adamw.init(p64))[0]
    torch_sync()
    lr = float(m64["lr"])
    rel = {"loss": errors(l32.double(), l64)[1],
           "grad_norm": errors(m32["grad_norm"].double(),
                               m64["grad_norm"])[1]}
    fg32, fg64 = M.flatten_tree(g32), M.flatten_tree(g64)
    per = {k: errors(fg32[k].double(), fg64[k])[1] for k in fg64}
    rel["gradient"] = max(per.values())
    per_q = {k: errors(a.double(), b)[1] for (k, a), b in zip(
        M.flatten_tree(nq32).items(), M.flatten_tree(nq64).values())}
    rel["AdamW alone"] = max(per_q.values())
    over, raw = {}, {}
    for (k, a), b in zip(M.flatten_tree(n32).items(),
                         M.flatten_tree(n64).values()):
        d = float((a.double() - b).abs().max())
        raw[k] = d / float(b.abs().max())
        allow = TOL * float(b.abs().max()) + lr * float(
            (fg32[k].double() - fg64[k]).abs().max()) / opt_cfg.eps
        over[k] = d / allow
    require(all(t.dtype == torch.float64 for t in
                M.flatten_tree(n64).values()), "the fp64 step left fp64")
    worst = max(raw, key=raw.get)
    print(f"  fp32 step vs fp64 on the card (one full-width layer, batch "
          f"{FP64_BATCH} x {FP64_SEQ}, TF32 off, {len(per)} leaves): loss "
          f"{float(l32):.6f} / {float(l64):.6f} rel err {rel['loss']:.3e}, "
          f"grad norm {rel['grad_norm']:.3e}, gradients worst "
          f"{rel['gradient']:.3e} ({max(per, key=per.get)}); AdamW alone "
          f"on shared gradients worst {rel['AdamW alone']:.3e}; params "
          f"after the step worst {raw[worst]:.3e} ({worst}), "
          f"{max(over.values()):.3f} of TOL + lr x gradient error / eps "
          f"(lr {lr:.3e}) [{card}]")
    bad = {k: v for k, v in rel.items() if not v <= TOL}
    bad.update({k: v for k, v in over.items() if not v <= 1.0})
    require(not bad, f"fp32 train step vs fp64: {bad} over the gate")
    return rel


def train_phase(dev, card):
    """Phase 20: train, resume, prune and restore sparse-to-be Qwen3-4B at
    full width (LM_LAYERS layers, bf16), then serve it through K3/K4.

    (a) determinism: one step twice from one state, every bit equal;
    (b) ``train`` TRAIN_STEPS steps (seq TRAIN_SEQ, batch TRAIN_BATCH,
    remat on, a checkpoint every TRAIN_CKPT_EVERY), a fresh ``train`` to
    TRAIN_RESUME that resumes from the newest checkpoint, bitwise equal to
    TRAIN_RESUME steps in one run, its optimizer step restored; (c)
    ``prune_masks`` at LM_DENSITY, PRUNE_STEPS fixed-mask steps, every
    pruned weight exactly 0; (d) ``save`` then ``restore`` into
    ``abstract_params`` templates, bitwise; (e) ``sparsify_model(strict=
    True)`` of the restored weights and phases 7/8 on them (``Scheduler``,
    tokens == solo, launches exact; the fp32 oracle); (f) the same batch
    DESCENT_STEPS times at DESCENT_LR: the loss falls by more than 0.1, each
    step timed by CUDA events, peak memory, one step traced; (g) the fp64
    gate. The training launches none of the four kernels (the reference
    trains the dense forward). Returns {kernel: launches} of (e)."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import ShapeConfig, load_config
    from repro_torch.core.sparse import prune_by_magnitude
    from repro_torch.data.pipeline import batch_for
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.sparsity import pruning
    from repro_torch.sparsity.sparse_ffn import sparsify_model
    from repro_torch.train.loop import TrainLoopConfig, init_state, train
    from repro_torch.train.train_step import GraphedTrainStep, \
        make_train_step
    t_phase = time.perf_counter()
    full = load_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=LM_LAYERS)
    shape = ShapeConfig("phase20", TRAIN_SEQ, TRAIN_BATCH, "train")
    tokens = TRAIN_SEQ * TRAIN_BATCH
    total = TRAIN_RESUME + PRUNE_STEPS
    opt_cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=total)
    (ROOT / "build").mkdir(exist_ok=True)
    ck = tempfile.mkdtemp(prefix="phase20_ckpt_", dir=ROOT / "build")
    free_gb = shutil.disk_usage(ck).free / 1e9
    ffn_counts(reset=True)
    try:
        # (a) determinism of one step
        state = init_state(cfg, seed=SEED, device=dev)
        n, nbytes = dense_size(state.params)
        print(f"phase 20: {full.name} at full width, {cfg.n_layers} of "
              f"{full.n_layers} layers, {cfg.dtype}: {n / 1e9:.3f} B "
              f"parameters ({nbytes / 1e9:.3f} GB, AdamW's fp32 moments "
              f"{8 * n / 1e9:.3f} GB beside); seq {TRAIN_SEQ} x batch "
              f"{TRAIN_BATCH}, remat on; disk free {free_gb:.1f} GB [{card}]")
        step = make_train_step(cfg, opt_cfg)
        batch = batch_for(cfg, shape, 0, seed=SEED, device=dev)
        runs = [step(state.params, state.opt, batch) for _ in range(2)]
        torch_sync()
        diff = leaves_bitwise(runs[0], runs[1])
        require(not diff, f"train step not deterministic: {diff[:6]}")
        print(f"  determinism: one step twice from one state, params, "
              f"moments and metrics bitwise equal "
              f"({len(M.flatten_tree(runs[0]))} leaves) [{card}]")
        del runs

        # (a2) the captured step against the eager donated step
        estep = make_train_step(cfg, opt_cfg, donate=True)
        gstep = GraphedTrainStep(cfg, opt_cfg)
        ep = M.map_tree(torch.clone, state.params)
        eo = adamw.init(ep)
        gp, go = state.params, state.opt
        del state
        for i in range(GRAPH_STEPS):
            b = batch_for(cfg, shape, i, seed=SEED, device=dev)
            ep, eo, em = estep(ep, eo, b)
            gp, go, gm = gstep(gp, go, b)
            diff = leaves_bitwise((gp, go, gm), (ep, eo, em))
            require(not diff, f"captured train step {i + 1} != eager: "
                              f"{diff[:6]}")
        g, = gstep.graphs.values()
        require(g.replays == GRAPH_STEPS - 1, "the train step did not "
                                              "replay its graph")
        print(f"  captured train step (GraphedTrainStep: forward, remat's "
              f"recompute, gradients and AdamW in one CUDA graph): "
              f"{GRAPH_STEPS} steps from one state bitwise equal to the "
              f"eager donated step (params, moments, counter, metrics; "
              f"the first eager, then {g.replays} replays), capture "
              f"{g.capture_s:.3f} s, pool {g.pool_bytes / 2**30:.3f} GiB "
              f"[{card}]")
        del ep, eo, gp, go, gstep, g
        torch.cuda.empty_cache()

        # (b) train, resume, and the uninterrupted run
        seen = {}
        hook = lambda s, m: seen.__setitem__(s, m)           # noqa: E731
        lc = TrainLoopConfig(steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                             ckpt_dir=ck, log_every=10 ** 9, seed=SEED)
        t0 = time.perf_counter()
        first = train(cfg, shape, lc, opt_cfg, step_hook=hook, device=dev)
        t1 = time.perf_counter()
        require(first.step == TRAIN_STEPS and ckpt.latest_step(ck) ==
                TRAIN_STEPS, "the first run did not checkpoint its end")
        del first
        resumed = train(cfg, shape, dataclasses.replace(
            lc, steps=TRAIN_RESUME), opt_cfg, step_hook=hook, device=dev)
        t2 = time.perf_counter()
        require(resumed.step == TRAIN_RESUME and
                int(resumed.opt.step) == TRAIN_RESUME,
                f"resume: step {resumed.step}, opt.step "
                f"{int(resumed.opt.step)}, expected {TRAIN_RESUME}")
        one = train(cfg, shape, TrainLoopConfig(
            steps=TRAIN_RESUME, log_every=10 ** 9, seed=SEED), opt_cfg,
            device=dev)
        diff = leaves_bitwise((resumed.params, resumed.opt),
                              (one.params, one.opt))
        require(not diff, f"restart != uninterrupted run: {diff[:6]}")
        del one
        losses = [seen[s]["loss"] for s in sorted(seen)]
        secs = [seen[s]["sec"] for s in sorted(seen)]
        print(f"  train {TRAIN_STEPS} steps (checkpoints every "
              f"{TRAIN_CKPT_EVERY}) {t1 - t0:.2f} s, a fresh train to "
              f"{TRAIN_RESUME} resumed at {TRAIN_STEPS} {t2 - t1:.2f} s "
              f"(opt.step {int(resumed.opt.step)}), bitwise equal to "
              f"{TRAIN_RESUME} steps in one run; loss by step "
              f"{[round(x, 4) for x in losses]}; host s a step "
              f"{[round(x, 3) for x in secs]} [{card}]")
        require(all(np.isfinite(losses)), "train: loss not finite")

        # (c) prune, then fixed-mask steps
        t0 = time.perf_counter()
        masks = pruning.prune_masks(resumed.params, pruning.PruneConfig(
            density=LM_DENSITY))
        prune_s = time.perf_counter() - t0
        rep = pruning.density_report(resumed.params, masks)
        require(len(rep) == 3 * cfg.n_layers and all(
            abs(d - LM_DENSITY) < 0.01 for d in rep.values()),
            f"prune_masks: densities {rep}")
        params = pruning.apply_masks(resumed.params, masks)
        opt = resumed.opt
        del resumed
        # the captured fixed-mask step (masks multiplied in place in the
        # graph) against the eager one (apply_masks), from copies
        pstep = pruning.make_pruned_train_step(
            GraphedTrainStep(cfg, opt_cfg), masks)
        estep = pruning.make_pruned_train_step(make_train_step(cfg, opt_cfg),
                                               masks)
        ep = M.map_tree(torch.clone, params)
        eo = adamw.OptState(opt.step.clone(), M.map_tree(torch.clone, opt.mu),
                            M.map_tree(torch.clone, opt.nu))
        ptrs = [t.data_ptr() for t in graph_leaves(params)]
        plosses = []
        for i in range(PRUNE_STEPS):
            b = batch_for(cfg, shape, TRAIN_RESUME + i, seed=SEED, device=dev)
            ep, eo, em = estep(ep, eo, b)
            params, opt, m = pstep(params, opt, b)
            diff = leaves_bitwise((params, opt, m), (ep, eo, em))
            require(not diff, f"captured fixed-mask step {i + 1} != eager "
                              f"apply_masks: {diff[:6]}")
            plosses.append(float(m["loss"]))
        del ep, eo
        gpr, = pstep.graphs.values()
        require(gpr.replays == PRUNE_STEPS - 1 and ptrs == [
            t.data_ptr() for t in graph_leaves(params)],
            "the fixed-mask steps were not replayed on the params in place")
        kept = {}                # {leaf: (pruned non-zero, kept non-zero)}
        M.map_tree_with_path(
            lambda path, p, mk: None if mk is None else kept.__setitem__(
                M.path_key(path), (int((p[mk == 0] != 0).sum()),
                                   int((p[mk == 1] != 0).sum()))),
            params, masks)
        require(all(v[0] == 0 for v in kept.values()),
                f"a pruned weight moved: {kept}")
        w0 = params["blocks"][0]["p0"]["ffn"]["w_in"].float().cpu().numpy()
        require(np.array_equal(w0 * prune_by_magnitude(w0, LM_DENSITY), w0),
                "packing would prune the trained weights again")
        print(f"  prune_masks at {LM_DENSITY}: {len(rep)} leaves, density "
              f"{min(rep.values()):.4f}-{max(rep.values()):.4f}, "
              f"{prune_s:.2f} s on the host; {PRUNE_STEPS} fixed-mask steps,"
              f" captured ({gpr.replays} replays, the masks multiplied in "
              f"place, bitwise the eager apply_masks steps), loss "
              f"{[round(x, 4) for x in plosses]}, every pruned weight "
              f"exactly 0 ({sum(v[1] for v in kept.values())} kept "
              f"non-zero) [{card}]")
        del pstep, gpr

        # (d) save, restore into abstract templates
        t0 = time.perf_counter()
        final = ckpt.save(ck, total, params, opt, extra={"arch": cfg.name})
        save_s = time.perf_counter() - t0
        ck_bytes = sum(f.stat().st_size for f in Path(final).iterdir())
        abs_p = M.abstract_params(cfg)
        t0 = time.perf_counter()
        p2, o2, man = ckpt.restore(ck, total, abs_p, adamw.init(abs_p),
                                   device=dev)
        torch_sync()
        restore_s = time.perf_counter() - t0
        diff = leaves_bitwise((params, opt), (p2, o2))
        require(not diff and man["step"] == total,
                f"restore != saved: {diff[:6]}")
        print(f"  checkpoint of step {total}: save {save_s:.2f} s, restore "
              f"into abstract_params templates {restore_s:.2f} s, "
              f"{ck_bytes / 1e9:.3f} GB (params and AdamW moments), "
              f"bitwise equal; the loop's saves ran in threads [{card}]")
        del params, opt, o2
        launched = ffn_counts()
        require(launched == {"k3": 0, "k4": 0},
                f"training launched FFN kernels: {launched}")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()

    # (e) pack the restored weights and serve them through K3/K4
    scfg = dataclasses.replace(cfg, sparse_ffn=True)
    t0 = time.perf_counter()
    packed = sparsify_model(p2, scfg, density=LM_DENSITY,
                            num_shards=LM_SHARDS, strict=True)
    torch_sync()
    print(f"  sparsify_model(strict=True) of the restored weights "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    del p2
    launches = lm_serving_phase(scfg, packed, card)
    lm_oracle_phase(scfg, packed)
    del packed
    torch.cuda.empty_cache()

    # (f) descent on one batch, each step timed, eager then captured (the
    # same losses); one step of each traced
    ffn_counts(reset=True)
    batch = batch_for(cfg, shape, 0, seed=SEED, device=dev)
    dcfg = adamw.AdamWConfig(lr=DESCENT_LR, warmup_steps=0)
    timed = {}
    for name in ("eager", "graph"):
        state = init_state(cfg, seed=SEED, device=dev)
        params, opt = state.params, state.opt
        del state
        dstep = GraphedTrainStep(cfg, dcfg) if name == "graph" else \
            make_train_step(cfg, dcfg, donate=True)
        torch_sync()
        torch.cuda.reset_peak_memory_stats()
        ms, dlosses = [], []
        for _ in range(DESCENT_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt, m = dstep(params, opt, batch)
            end.record()
            torch_sync()
            ms.append(start.elapsed_time(end))
            dlosses.append(float(m["loss"]))
        # steps 1-2: the first calls (the graph's eager warm-up and
        # capture, then its first replay)
        skip = 2
        rec = {"ms": ms, "losses": dlosses,
               "med": float(np.median(ms[skip:])), "skip": skip,
               "peak": torch.cuda.max_memory_allocated() / 2 ** 30,
               "kernels": trace_kernels(lambda: dstep(params, opt, batch))}
        if name == "graph":
            g, = dstep.graphs.values()
            rec["capture_s"], rec["pool"] = g.capture_s, g.pool_bytes / 2**30
            del g
        timed[name] = rec
        del params, opt, dstep
        torch.cuda.empty_cache()
    dlosses = timed["eager"]["losses"]
    require(timed["graph"]["losses"] == dlosses,
            f"the captured descent's losses != eager: "
            f"{timed['graph']['losses']} vs {dlosses}")
    print(f"  same batch {DESCENT_STEPS} steps at lr {DESCENT_LR}: loss "
          f"{[round(x, 4) for x in dlosses]}, the captured step's equal "
          f"[{card}]")
    for name, rec in timed.items():
        med, ms, kernels = rec["med"], rec["ms"], rec["kernels"]
        extra = (f"; capture {rec['capture_s']:.3f} s, pool "
                 f"{rec['pool']:.3f} GiB") if name == "graph" else ""
        print(f"  train step, {name} ({tokens} tokens, remat on): median "
              f"{med:.4f} ms by CUDA events over steps {rec['skip'] + 1}-"
              f"{DESCENT_STEPS} (range {min(ms[rec['skip']:]):.4f}-"
              f"{max(ms[rec['skip']:]):.4f}; the first {ms[0]:.4f}), "
              f"{tokens / med * 1e3:.1f} tok/s; peak {rec['peak']:.3f} GiB "
              f"allocated{extra} [{card}]")
        if not kernels:
            print(f"  one traced {name} step: the profiler saw no kernel on "
                  f"the card (not measured)")
            continue
        busy = sum(t for _, t in kernels)
        top = sorted(by_name(kernels).items(), key=lambda kv: -kv[1][1])[:5]
        print(f"  one traced {name} step (torch.profiler): {len(kernels)} "
              f"kernels, the card busy {busy:.4f} ms, idle "
              f"{med - busy:.4f} ms ({(med - busy) / med:.1%}) of the median"
              f" [{card}]; top: " + "; ".join(
                  f"{n[:48]} ({k}, {t:.4f})" for n, (k, t) in top))
    print(f"  train step graph against eager: {timed['graph']['med']:.4f} "
          f"ms vs {timed['eager']['med']:.4f} ms "
          f"({timed['eager']['med'] / timed['graph']['med']:.3f}x) [{card}]")
    require(dlosses[-1] < dlosses[0] - 0.1 and all(np.isfinite(dlosses)),
            f"the loss did not fall on one batch: {dlosses}")
    require(ffn_counts() == {"k3": 0, "k4": 0},
            "the training step launched FFN kernels")

    # (g) fp32 against fp64
    train_fp64_gate(dev, card)
    torch.cuda.empty_cache()
    gc.collect()

    # (h) the launcher at full depth, captured
    full_depth_train(dev, card)
    print(f"  phase 20 {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


def full_depth_train(dev, card):
    """Phase 20 (h): ``python -m repro_torch.launch.train --arch qwen3_4b``
    (all 36 layers, seq TRAIN_SEQ x batch TRAIN_BATCH, the captured step)
    for FULL_STEPS steps in this process: its step ms (host clock, the
    median after the first two) and peak GiB. Where a depth does not fit
    the card (out of memory) that is printed on its own line and the next
    depth of FULL_DEPTHS is tried; none fitting fails the phase."""
    import torch
    from repro_torch.graphs import GraphCaptureError
    from repro_torch.launch import train as launch_train
    for depth in FULL_DEPTHS:
        argv = ["--arch", LM_ARCH, "--steps", str(FULL_STEPS), "--seq",
                str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--layers",
                str(depth)]
        t0 = time.perf_counter()
        out = None
        try:
            out = launch_train.main(argv)
        except (torch.OutOfMemoryError, GraphCaptureError) as e:
            # a capture that ran out of memory names it in its message
            if "out of memory" not in str(e):
                raise
            why = f"{type(e).__name__}: {str(e)[:200]}"
        gc.collect()                    # the failed run's tensors go too
        torch.cuda.empty_cache()
        if out is None:
            print(f"  full-depth train: {depth} layers did not fit the card "
                  f"({why}); {torch.cuda.memory_reserved() / 2**30:.3f} GiB "
                  f"still reserved after [{card}]")
            continue
        require(out["steps"] == FULL_STEPS and np.isfinite(out["step_ms"]),
                f"full-depth train: {out}")
        print(f"  full-depth train (the launcher, {depth} of 36 layers, "
              f"captured, seq {TRAIN_SEQ} x batch {TRAIN_BATCH}): step "
              f"{out['step_ms']:.3f} ms (median of steps 3-{FULL_STEPS}, "
              f"host clock), the first {out['first_ms']:.3f} ms (eager "
              f"warm-up), peak {out['peak_gib']:.3f} GiB allocated, "
              f"{time.perf_counter() - t0:.1f} s in all [{card}]")
        return out
    raise SmokeFailure(f"full-depth train: no depth of {FULL_DEPTHS} fits")


# phase 22: sharded LM training on a one-rank DeviceMesh
def local_tree(tree):
    """Each DTensor leaf's local tensor (plain leaves as they are)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import model as M
    return M.map_tree(lambda t: t.to_local() if isinstance(t, DTensor)
                      else t, tree)


def placements_off(tree, shardings) -> list:
    """Keys of the DTensor leaves whose placements are not their
    sharding's."""
    from repro_torch.models import model as M
    fa, fs = M.flatten_tree(tree), M.flatten_tree(shardings)
    return [k for k, t in fa.items()
            if tuple(getattr(t, "placements", ())) != fs[k].placements]


def step_times(name, make_state, make_step, batch, card):
    """MESH_TIMED_STEPS steps of ``make_step()`` from ``make_state()`` on
    one batch, each timed by CUDA events (median after the first two: the
    eager warm-up with the capture, and the first replay), then one step
    traced: the card's busy ms and idle share of the median."""
    import torch
    params, opt = make_state()
    step = make_step()
    ms = []
    for _ in range(MESH_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        torch_sync()
        ms.append(start.elapsed_time(end))
    med = float(np.median(ms[2:]))
    loss = float(m["loss"])                # before the trace's replays
    kernels = trace_kernels(lambda: step(params, opt, batch))
    busy = sum(t for _, t in kernels)
    rec = {"ms": ms, "median_ms": med, "kernels": len(kernels),
           "busy_ms": busy, "idle_share": (med - busy) / med
           if kernels else None, "loss": loss}
    idle = (f"one traced step {len(kernels)} kernels, busy {busy:.4f} ms, "
            f"idle {rec['idle_share']:.1%} of the median") if kernels \
        else "the profiler saw no kernel (idle share not measured)"
    print(f"  {name}: median {med:.4f} ms by CUDA events over steps 3-"
          f"{MESH_TIMED_STEPS} (range {min(ms[2:]):.4f}-{max(ms[2:]):.4f};"
          f" the first {ms[0]:.4f}); {idle} [{card}]")
    del params, opt, step
    torch.cuda.empty_cache()
    return rec


def lm_mesh_phase(dev, card):
    """Phase 22: Qwen3-4B at full width (LM_LAYERS layers, bf16, seq
    TRAIN_SEQ x batch TRAIN_BATCH, remat on) trained sharded on
    ``make_debug_mesh(1, 1)`` with FSDP, in the one-rank NCCL world of
    phase 21 (joined, or started when run alone).

    (a) one eager sharded step against the solo step from the same params
    and batch: params, moments and metrics bitwise equal, every leaf in
    the placements ``param_shardings`` / ``opt_shardings`` give it; (b)
    the captured sharded step (``GraphedTrainStep`` on the DTensors) over
    GRAPH_STEPS steps bitwise equal to the eager sharded donated step; (c)
    step ms, sharded against solo, graph and eager (CUDA events), with the
    card's idle share from one traced step each; (d) the mesh's state
    saved and restored solo bitwise, and a solo save of its params (the
    same bytes) restored onto the mesh bitwise (seconds and bytes); (e) the launcher under
    ``torch.distributed.run --nproc-per-node 1`` with ``--mesh 1,1
    --fsdp``, 4 steps at LM_LAYERS layers, its finish line. No kernel of
    the four runs here. Returns the record."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import ShapeConfig, load_config
    from repro_torch.data.pipeline import batch_for
    from repro_torch.dist import partitioning as part
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_state, shardings
    from repro_torch.train.train_step import GraphedTrainStep, \
        make_train_step
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(load_config(LM_ARCH), n_layers=LM_LAYERS)
    shape = ShapeConfig("phase22", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt_cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=16)
    mesh = make_debug_mesh(1, 1, device=dev)
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            "phase 22 runs in a one-rank NCCL world")
    p_sh, o_sh = shardings(cfg, mesh, fsdp=True)
    place = part.NamedSharding.of(mesh, part.batch_spec(mesh))

    def on_mesh(batch):
        return {k: part.distribute(v, place) for k, v in batch.items()}
    rec = {"mesh": "(data=1, model=1)", "fsdp": True}
    ffn_counts(reset=True)

    # (a) one eager sharded step against the solo step
    params = M.init_params(cfg, seed=SEED, device=dev)
    batch = batch_for(cfg, shape, 0, seed=SEED, device=dev)
    solo = make_train_step(cfg, opt_cfg)(params, adamw.init(params), batch)
    sp = part.distribute_tree(params, p_sh)
    so = adamw.init(sp)
    t0 = time.perf_counter()
    got = make_train_step(cfg, opt_cfg)(sp, so, on_mesh(batch))
    torch_sync()
    first_s = time.perf_counter() - t0
    diff = leaves_bitwise(local_tree(got), solo)
    off = placements_off(got[0], p_sh) + placements_off(got[1], o_sh)
    require(not diff, f"sharded step != solo: {diff[:6]}")
    require(not off, f"leaves off their shardings: {off[:6]}")
    shown = {k: str(v.placements) for k, v in list(M.flatten_tree(
        p_sh).items())[:3]}
    print(f"phase 22: {cfg.name} at full width, {cfg.n_layers} layers, "
          f"bf16, seq {TRAIN_SEQ} x batch {TRAIN_BATCH}, remat on, on "
          f"make_debug_mesh(1, 1) with FSDP: one eager sharded step "
          f"({first_s:.2f} s with DTensor's first dispatches) bitwise equal "
          f"to the solo step ({len(M.flatten_tree(solo))} leaves: params, "
          f"moments, counter, metrics); every leaf in its "
          f"param_shardings / opt_shardings placements ({shown}) [{card}]")
    del solo, got, sp, so
    torch.cuda.empty_cache()

    # (b) the captured sharded step against the eager sharded step
    ep = part.distribute_tree(params, p_sh)
    eo = adamw.init(ep)
    gp = part.distribute_tree(params, p_sh)
    go = adamw.init(gp)
    estep = make_train_step(cfg, opt_cfg, donate=True)
    gstep = GraphedTrainStep(cfg, opt_cfg)
    for i in range(GRAPH_STEPS):
        b = on_mesh(batch_for(cfg, shape, i, seed=SEED, device=dev))
        ep, eo, em = estep(ep, eo, b)
        gp, go, gm = gstep(gp, go, b)
        diff = leaves_bitwise(local_tree((gp, go, gm)),
                              local_tree((ep, eo, em)))
        require(not diff, f"captured sharded step {i + 1} != eager: "
                          f"{diff[:6]}")
    g, = gstep.graphs.values()
    require(g.replays == GRAPH_STEPS - 1,
            "the sharded step did not replay its graph")
    require(not placements_off(gp, p_sh), "the graph's params left their "
                                          "placements")
    rec["capture_s"], rec["pool_gib"] = g.capture_s, g.pool_bytes / 2**30
    print(f"  captured sharded step (GraphedTrainStep on the DTensors): "
          f"{GRAPH_STEPS} steps bitwise equal to the eager sharded donated "
          f"step (the first eager, then {g.replays} replays), capture "
          f"{g.capture_s:.3f} s, pool {g.pool_bytes / 2**30:.3f} GiB "
          f"[{card}]")
    del ep, eo, gp, go, gstep, g, estep
    torch.cuda.empty_cache()

    # (c) step ms: sharded against solo, graph and eager, each run from a
    # copy of one draw
    mb = on_mesh(batch)

    def solo_state():
        p = M.map_tree(torch.clone, params)
        return p, adamw.init(p)

    def mesh_state():
        p = part.distribute_tree(params, p_sh)
        return p, adamw.init(p)
    timed = {}
    for name, make_state, b in (("solo", solo_state, batch),
                                ("sharded", mesh_state, mb)):
        for mode in ("eager", "graph"):
            make = (lambda: GraphedTrainStep(cfg, opt_cfg)) \
                if mode == "graph" else \
                (lambda: make_train_step(cfg, opt_cfg, donate=True))
            timed[f"{name} {mode}"] = step_times(
                f"train step, {name} {mode}", make_state, make, b, card)
    losses = {k: v["loss"] for k, v in timed.items()}
    require(len(set(losses.values())) == 1,
            f"the four timed runs' last losses differ: {losses}")
    for mode in ("eager", "graph"):
        r = timed[f"sharded {mode}"]["median_ms"] / \
            timed[f"solo {mode}"]["median_ms"]
        rec[f"sharded_over_solo_{mode}"] = r
        print(f"  sharded {mode} / solo {mode}: {r:.4f}x [{card}]")
    rec["timed"] = timed

    # (d) checkpoints across the mesh and solo: the mesh's state restored
    # solo; a solo save of its params (the same bytes) onto the mesh
    (ROOT / "build").mkdir(exist_ok=True)
    ck = tempfile.mkdtemp(prefix="phase22_ckpt_", dir=ROOT / "build")
    try:
        sp, so = mesh_state()
        sp, so, _ = make_train_step(cfg, opt_cfg, donate=True)(sp, so, mb)
        del params
        abs_p = M.abstract_params(cfg)
        abs_o = adamw.init(abs_p)
        t0 = time.perf_counter()
        ckpt.save(ck, 1, sp, so)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in
                     (Path(ck) / "step_00000001").iterdir())
        t0 = time.perf_counter()
        p1, o1, _ = ckpt.restore(ck, 1, abs_p, abs_o, device=dev)
        torch_sync()
        solo_s = time.perf_counter() - t0
        diff = leaves_bitwise((p1, o1), local_tree((sp, so)))
        require(not diff, f"mesh checkpoint restored solo: {diff[:6]}")
        del o1, so
        ckpt.save(ck, 2, p1)
        t0 = time.perf_counter()
        p2, _, _ = ckpt.restore(ck, 2, abs_p, device=dev, shardings=p_sh)
        torch_sync()
        mesh_s = time.perf_counter() - t0
        diff = leaves_bitwise(local_tree(p2), p1)
        require(not diff and not placements_off(p2, p_sh),
                f"solo checkpoint restored onto the mesh: {diff[:6]}")
        same = (Path(ck) / "step_00000001" / "params.bin").read_bytes() == \
            (Path(ck) / "step_00000002" / "params.bin").read_bytes()
        require(same, "the mesh save's params.bin != the solo save's")
        rec["ckpt"] = {"bytes": nbytes, "save_s": save_s,
                       "restore_solo_s": solo_s, "restore_mesh_s": mesh_s}
        print(f"  checkpoints: the mesh's state saved {save_s:.2f} s "
              f"({nbytes / 1e9:.3f} GB, params and moments), restored solo "
              f"{solo_s:.2f} s bitwise; a solo save of its params "
              f"byte-identical, restored onto the mesh {mesh_s:.2f} s "
              f"bitwise, in its placements [{card}]")
        del sp, p1, p2
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    require(ffn_counts() == {"k3": 0, "k4": 0},
            "the sharded training launched FFN kernels")

    # (e) the launcher under torch.distributed.run
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
            "--arch", LM_ARCH, "--layers", str(LM_LAYERS), "--steps", "4",
            "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
            "--mesh", "1,1", "--fsdp"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(argv, env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    launch_s = time.perf_counter() - t0
    fin = [ln for ln in run.stdout.splitlines()
           if ln.startswith("finished at step 4")]
    require(run.returncode == 0 and fin, f"the mesh launcher failed "
            f"({run.returncode}): {run.stdout[-1500:]} {run.stderr[-3000:]}")
    rec["launcher_s"] = launch_s
    print(f"  torch.distributed.run --nproc-per-node 1 -m repro_torch."
          f"launch.train --mesh 1,1 --fsdp "
          f"({LM_LAYERS} layers, 4 steps): {fin[0]} ({launch_s:.1f} s in "
          f"all) [{card}]")
    print(f"  phase 22 {time.perf_counter() - t_phase:.1f} s [{card}]")
    return rec


# phase 23: the sharded serve steps on a one-rank DeviceMesh
def kernel_counts() -> dict:
    """The four kernels' launch counters."""
    from repro_torch.kernels.sparse_conv import CONV_GRID
    from repro_torch.kernels.worklist_core import WALK
    return {"k1": WALK.launches, "k2": CONV_GRID.launches, **ffn_counts()}


def per_step_ms(run, steps: int) -> float:
    """Median ms of ``steps`` calls of ``run(i)`` by CUDA events (after
    the first call: the eager warm-up, or a graph's capture)."""
    import torch
    run(0)
    ms = []
    for i in range(1, steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(i)
        end.record()
        torch_sync()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms))


def serve_mesh_phase(dev, card):
    """Phase 23: the sharded serve steps (the reference's dry-run serve
    step: ``make_prefill_fn`` and ``make_serve_step`` on DTensor params and
    a cache placed by ``cache_shardings``) on ``make_debug_mesh(1, 1)`` in
    phase 21's one-rank NCCL world, each bitwise equal to solo:

    (a) Qwen3-4B at full width (LM_LAYERS layers, bf16, dense): the
    last-position prefill logits of MESH_BATCH x LM_PROMPT tokens, the
    cache-writing prefill into a placed cache (``init_cache_on``), then
    DECODE_STEPS greedy steps eager (tokens, logits, cache) and captured
    (``GraphedServeStep`` on the DTensors: tokens, logits, cache); step ms
    by CUDA events, sharded against solo, eager and graph, with the card's
    idle share of one traced step each;
    (b) RWKV6-3B (LM_LAYERS layers) and one full-width Jamba Mamba block:
    the sharded forward (logits; the block's output and decode handoff)
    and FAMILY_STEPS decode steps;
    (c) one dry-run cell (``python -m repro_torch.launch.dryrun``, on meta
    in a fake world of 256 ranks) run on the card's host.

    None of the four kernels runs (the dense model, as the reference's dry
    run lowers it). Returns the record."""
    import dataclasses
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import load_config
    from repro_torch.dist import partitioning as part
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve.engine import (GraphedServeStep, init_cache_on,
                                          make_prefill_fn, make_serve_step)
    t_phase = time.perf_counter()
    before = kernel_counts()
    mesh = make_debug_mesh(1, 1, device=dev)
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            "phase 23 runs in a one-rank NCCL world")
    tok_sh = part.NamedSharding.of(mesh, part.batch_spec(mesh))
    rng = np.random.default_rng(SEED)
    rec = {"mesh": "(data=1, model=1)"}

    def same(a, b, what):
        diff = leaves_bitwise(local_tree(a), local_tree(b))
        require(not diff, f"{what}: sharded != solo at {diff[:6]}")

    def family(arch):
        cfg = dataclasses.replace(load_config(arch), n_layers=LM_LAYERS)
        params = M.init_params(cfg, seed=SEED, device=dev)
        sp = part.distribute_tree(params, part.param_shardings(
            mesh, M.abstract_params(cfg)))
        return cfg, params, sp

    def serve(cfg, params, sp, steps):
        """Prefill and ``steps`` eager steps, solo and sharded, bitwise;
        returns (the prompt, both prefilled caches and the first token)."""
        B, S = MESH_BATCH, LM_PROMPT
        toks = torch.as_tensor(rng.integers(1, cfg.vocab, (B, S)),
                               device=dev)
        dtoks = part.distribute(toks, tok_sh)
        pf = make_prefill_fn(cfg)
        with torch.no_grad():
            same(pf(sp, dtoks), pf(params, toks), f"{cfg.name} prefill")
            solo_c = M.init_cache(cfg, B, S + steps, device=dev)
            mesh_c, c_sh = init_cache_on(mesh, cfg, B, S + steps,
                                         device=dev)
            ls, solo_c = pf(params, toks, solo_c)
            lm, mesh_c = pf(sp, dtoks, mesh_c)
            same((lm, mesh_c), (ls, solo_c), f"{cfg.name} cache prefill")
            require(not placements_off(mesh_c, c_sh),
                    f"{cfg.name}: the prefilled cache left its placements")
            first = torch.argmax(ls, -1)[:, None]
            out = (toks, M.map_tree(torch.clone, solo_c),
                   M.map_tree(torch.clone, mesh_c), first)
            step = make_serve_step(cfg)
            ts, tm = first, part.distribute(first, tok_sh)
            for i in range(steps):
                pos = torch.full((B,), S + i, device=dev)
                lgs, _ = M.decode_step(params, cfg, ts, solo_c, pos)
                lgm, _ = M.decode_step(sp, cfg, tm, mesh_c, pos)
                ts, solo_c = step(params, solo_c, ts, pos)
                tm, mesh_c = step(sp, mesh_c, tm, pos)
                same((tm, lgm, mesh_c), (ts, lgs, solo_c),
                     f"{cfg.name} decode step {i + 1}")
            require(not placements_off(mesh_c, c_sh),
                    f"{cfg.name}: the decoded cache left its placements")
        return out

    # (a) Qwen3-4B: prefill, eager and captured decode, times
    cfg, params, sp = family(LM_ARCH)
    toks, solo0, mesh0, first = serve(cfg, params, sp, DECODE_STEPS)
    B, S = toks.shape
    pos = [torch.full((B,), S + i, device=dev) for i in range(DECODE_STEPS)]
    eager = make_serve_step(cfg)
    gstep = GraphedServeStep(cfg)
    c_e, c_g = M.map_tree(torch.clone, mesh0), M.map_tree(torch.clone, mesh0)
    t_e = t_g = part.distribute(first, tok_sh)
    with torch.no_grad():
        for i in range(DECODE_STEPS):
            lg, _ = M.decode_step(sp, cfg, t_e, c_e, pos[i])
            t_e, c_e = eager(sp, c_e, t_e, pos[i])
            t_g, c_g = gstep(sp, c_g, t_g, pos[i])
            same((t_g, gstep.last_logits, c_g), (t_e, lg[:, 0], c_e),
                 f"captured sharded step {i + 1}")
    g, = gstep.graphs.values()
    require(g.replays == DECODE_STEPS - 1,
            "the sharded serve step did not replay its graph")
    print(f"phase 23: {cfg.name} at full width, {cfg.n_layers} layers, "
          f"bf16, on make_debug_mesh(1, 1): the sharded prefill ({B} x {S}; "
          f"last logits, and the cache-writing prefill into a cache placed "
          f"by cache_shardings) and {DECODE_STEPS} greedy make_serve_step "
          f"steps bitwise equal to solo (tokens, logits, every cache leaf, "
          f"in its placements); the captured sharded step (GraphedServeStep"
          f" on the DTensors, {g.replays} replays) bitwise equal to the "
          f"eager sharded step, capture {g.capture_s:.3f} s [{card}]")
    del c_e, c_g

    def timed(name, p, cache0, tok0, graphed):
        with torch.no_grad():
            stepper = GraphedServeStep(cfg) if graphed else eager
            state = {"c": M.map_tree(torch.clone, cache0), "t": tok0}

            def run(i):
                state["t"], state["c"] = stepper(p, state["c"], state["t"],
                                                 pos[i % DECODE_STEPS])
            ms = per_step_ms(run, DECODE_STEPS)
            kernels = trace_kernels(lambda: run(0))
        busy = sum(t for _, t in kernels)
        idle = (ms - busy) / ms if kernels else None
        print(f"  decode step, {name}: median {ms:.4f} ms by CUDA events "
              f"over steps 2-{DECODE_STEPS}; one traced step "
              f"{len(kernels)} kernels, busy {busy:.4f} ms, idle "
              + (f"{idle:.1%}" if idle is not None else "not measured")
              + f" [{card}]")
        return {"ms": ms, "busy_ms": busy, "kernels": len(kernels),
                "idle_share": idle}
    times = {}
    for graphed in (False, True):
        mode = "graph" if graphed else "eager"
        times[f"solo {mode}"] = timed(f"solo {mode}", params, solo0, first,
                                      graphed)
        times[f"sharded {mode}"] = timed(f"sharded {mode}", sp, mesh0,
                                         part.distribute(first, tok_sh),
                                         graphed)
    for mode in ("eager", "graph"):
        r = times[f"sharded {mode}"]["ms"] / times[f"solo {mode}"]["ms"]
        rec[f"sharded_over_solo_{mode}"] = r
        print(f"  sharded {mode} / solo {mode}: {r:.4f}x [{card}]")
    rec["times"] = times
    del params, sp, solo0, mesh0, gstep, g
    torch.cuda.empty_cache()

    # (b) RWKV6-3B, then one Jamba Mamba block
    rcfg, rparams, rsp = family(RWKV_ARCH)
    serve(rcfg, rparams, rsp, FAMILY_STEPS)
    del rparams, rsp
    torch.cuda.empty_cache()
    jcfg = load_config(MAMBA_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = L.init_mamba(gen, jcfg, jcfg.torch_dtype)
    tree = {"blocks": [{"p1": {"mamba": p}}]}
    sp = part.distribute_tree(tree, part.param_shardings(
        mesh, M.map_tree(lambda t: torch.empty_like(t, device="meta"),
                         tree)))["blocks"][0]["p1"]["mamba"]
    T = MAMBA_MESH_TOKENS
    x = torch.randn((MESH_BATCH, T + FAMILY_STEPS, jcfg.d_model),
                    generator=gen, device=dev).to(jcfg.torch_dtype)
    xd = part.distribute(x, part.NamedSharding.of(
        mesh, part.P(tuple(part.dp_axes(mesh)), None, None)))
    with torch.no_grad(), implicit_replication():
        same(L.mamba_block(sp, xd[:, :T], jcfg, return_state=True),
             L.mamba_block(p, x[:, :T], jcfg, return_state=True),
             "the Mamba block's forward and handoff")
        _, conv_m, h_m = L.mamba_block(sp, xd[:, :T], jcfg, return_state=True)
        _, conv_s, h_s = L.mamba_block(p, x[:, :T], jcfg, return_state=True)
        for t in range(T, T + FAMILY_STEPS):
            ym, conv_m, h_m = L.mamba_decode(sp, xd[:, t:t + 1], jcfg,
                                             conv_m, h_m)
            ys, conv_s, h_s = L.mamba_decode(p, x[:, t:t + 1], jcfg, conv_s,
                                             h_s)
            same((ym, conv_m, h_m), (ys, conv_s, h_s),
                 f"Mamba decode step {t - T + 1}")
    print(f"  {rcfg.name} ({rcfg.n_layers} layers, bf16) prefill, cache "
          f"prefill and {FAMILY_STEPS} decode steps; one {jcfg.name} Mamba "
          f"block (din {jcfg.mamba.expand * jcfg.d_model}, bf16): forward "
          f"over {T} tokens with its handoff and {FAMILY_STEPS} decode steps:"
          f" sharded bitwise equal to solo [{card}]")
    del p, sp, x, xd
    torch.cuda.empty_cache()

    # (c) one dry-run cell on the card's host
    (ROOT / "build").mkdir(exist_ok=True)
    out = tempfile.mkdtemp(prefix="phase23_dryrun_", dir=ROOT / "build")
    arch, shape = DRYRUN_CELL
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--mesh", "single", "--out", out]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(argv, env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    dry_s = time.perf_counter() - t0
    ok = [ln for ln in run.stdout.splitlines() if ln.startswith("[ok]")]
    require(run.returncode == 0 and ok, f"the dry run failed "
            f"({run.returncode}): {run.stdout[-1500:]} {run.stderr[-3000:]}")
    with open(Path(out) / f"{arch}_{shape}_single.json") as f:
        cell = json.load(f)
    require(cell["per_device"]["flops"] > 0, "the dry-run cell counted no "
            "FLOPs on this host's torch")
    rec["dryrun"] = cell
    print(f"  python -m repro_torch.launch.dryrun --arch {arch} --shape "
          f"{shape} --mesh single (torch {torch.__version__}, on meta in a "
          f"fake world of 256 ranks, {dry_s:.1f} s in all): {ok[0]}")
    require(kernel_counts() == before,
            "the sharded serve steps launched a kernel")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 23 {rec['seconds']:.1f} s, none of the four kernels "
          f"launched [{card}]")
    return rec


# ---------------------------------------------------------------------------
# phase 24: AlexNet, ResNet-18 and ResNet-50 at full size and depth, each
# net's Figure-7 row at its measured densities, and the other examples
def example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts, not a
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def net_oracle(name: str, pattern: str, size: int):
    """One net built and run through ``oracle_check`` on one image by
    ``examples/torch_sparse_cnn_sim.main`` (which prints the layer table
    and the Figure-7 row): rel err <= TOL, the output finite and of the
    net's shape, K2 launched once a layer and K1 never. Returns the
    example's result, K2's launches and the output's non-zero share."""
    import torch
    from repro_torch.kernels.sparse_conv import CONV_GRID
    from repro_torch.kernels.worklist_core import WALK
    from repro_torch.vision import layer_geometry
    label = NET_LABEL[name]
    t0 = time.perf_counter()
    WALK.launches = CONV_GRID.launches = 0
    res = example("torch_sparse_cnn_sim").main(
        ["--bench", name, "--image-size", str(size), "--pattern", pattern,
         "--seed", str(SEED)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    model, out, rel = res["model"], res["output"], res["rel_err"]
    grid, n = CONV_GRID.launches, model.num_layers
    last = layer_geometry(model, size)[-1]
    shape = (1, last["oh"], last["ow"], model.layers[-1].conv.cout)
    require(tuple(out.shape) == shape and bool(torch.isfinite(out).all()),
            f"{label}: output {tuple(out.shape)} is not finite of shape "
            f"{shape}")
    require(rel <= TOL, f"{label} {pattern}: rel err {rel:.3e} > {TOL}")
    require(grid == n and WALK.launches == 0,
            f"{label}: oracle_check launched the dense grid {grid} times "
            f"(expected {n}) and the walker {WALK.launches} (expected 0)")
    live = float((out != 0).float().mean())
    print(f"{label} {size} px pattern={pattern}: oracle_check ({n} layers, "
          f"{grid} dense-grid launches) rel err {rel:.3e} vs dense F.conv2d "
          f"(TF32 off); output non-zero share {live:.4f}; build, check and "
          f"row {dt:.2f} s")
    return res, grid, live


def net_phase(name: str, pattern: str, size: int, card: str):
    """Phase 24 for one net: :func:`net_oracle`, then the compiled forward
    of 4 images (the eager closure, the graph's first call and a replay,
    bitwise equal, K1 launched exactly), ``VisionEngine`` on 8 staggered
    requests (every output bitwise the solo forward, K1 exact), the
    replayed forward timed against ``dense_forward``, and K1/K2 against
    their plain versions at the layers of NET_KERNEL_LAYERS. Returns the
    net's record and its kernel records."""
    import torch
    from repro_torch.core import simulator as S
    from repro_torch.kernels.worklist_core import WALK
    from repro_torch.launch.vision import blob_images
    from repro_torch.vision import (ImageRequest, VisionEngine,
                                    compile_forward, dense_forward,
                                    graphed_forward)
    label = NET_LABEL[name]
    t0 = time.perf_counter()
    res, grid, live = net_oracle(name, pattern, size)
    require(live > 0, f"{label}: the output is all zero")
    model = res["model"]
    n, dev = model.num_layers, model.device
    bench = S.BENCHMARKS[name]
    imgs = blob_images(np.random.default_rng(SEED), 8, size,
                       bench.map_density)
    x4 = torch.as_tensor(imgs[:4], device=dev)

    WALK.launches = 0
    eager = compile_forward(model)(x4)
    graph = graphed_forward(model)
    first, replay = graph(x4), graph(x4)
    torch.cuda.synchronize()
    fwd = WALK.launches
    require(torch.equal(first, eager) and torch.equal(replay, eager),
            f"{label}: the graphed forward of 4 images != the eager one")
    require(fwd == 3 * n, f"{label}: the compiled forwards launched the "
                          f"walker {fwd} times, expected {3 * n}")

    reqs = [ImageRequest(rid=i, image=imgs[i], arrival=i // 3)
            for i in range(8)]
    WALK.launches = 0
    eng = VisionEngine(model, num_slots=4)
    produced = eng.run(reqs)
    torch.cuda.synchronize()
    engine, st = WALK.launches, eng.stats
    forwards = st.engine_steps + 1                     # + the warm-up
    require(engine == forwards * n,
            f"{label}: the engine launched the walker {engine} times, "
            f"expected {forwards * n}")
    solo = compile_forward(model)
    for r in reqs:
        one = solo(torch.as_tensor(r.image[None], device=dev))[0]
        require(np.array_equal(produced[r.rid], one.cpu().numpy()),
                f"{label} request {r.rid}: engine output != solo forward")
    print(f"{label}: compiled forward of 4 images (eager, graph, replay) "
          f"bitwise equal, {fwd} walker launches; engine {st.images} images "
          f"on 4 slots in {st.engine_steps} steps, {engine} walker launches "
          f"({n} a forward), outputs bitwise equal to solo, "
          f"{st.img_per_s:.2f} img/s [{card}]")
    times = forwards_compared(
        {"graph": graph, "dense_forward (cuDNN, TF32 off)":
         lambda x: dense_forward(model, x)}, x4, card, windows=NET_WINDOWS,
        net=label)
    kern = [kernel_phase(model, imgs[:4], layer, card)
            for layer in NET_KERNEL_LAYERS.get(name, ())]
    rec = {"pattern": pattern, "image_size": size, "layers": n,
           "rel_err": res["rel_err"], "output_nonzero": live,
           "filter_density": res["filter_density"],
           "map_density": res["map_density"],
           "paper_filter_density": bench.filter_density,
           "paper_map_density": bench.map_density, "fig7": res["row"],
           "launches": {"oracle_check_grid": grid, "forward_walker": fwd,
                        "engine_walker": engine},
           "forward": times, "seconds": time.perf_counter() - t0}
    return rec, kern


def examples_phase(card: str):
    """The other three examples in-process at their smoke sizes on the
    card (their default device): the quickstart's sparse FFN (K4 then K3,
    once each) within TOL of its oracle, the batched server's
    batch-composition check on a sparse smoke model, and four pruned,
    checkpointed training steps. Returns K3/K4 launches by example."""
    import tempfile
    import torch
    from repro_torch.kernels.bitmask_spmm import BITMASK_SPMM
    from repro_torch.kernels.fused_ffn import FUSED_FFN

    def counts():
        torch.cuda.synchronize()
        return {"k3": BITMASK_SPMM.launches, "k4": FUSED_FFN.launches}
    launches = {}
    BITMASK_SPMM.launches = FUSED_FFN.launches = 0
    q = example("torch_quickstart").main([])
    launches["example_quickstart"] = counts()
    require(q["rel_err"] <= TOL, f"quickstart: sparse FFN rel err "
                                 f"{q['rel_err']:.3e} > {TOL}")
    require(launches["example_quickstart"] == {"k3": 1, "k4": 1},
            f"quickstart launched {launches['example_quickstart']}, "
            f"expected K3 and K4 once each")
    BITMASK_SPMM.launches = FUSED_FFN.launches = 0
    s = example("torch_serve_batched").main(["--smoke", "--sparse"])
    launches["example_serve_batched"] = c = counts()
    require(c["k3"] > 0 and c["k4"] > 0 and s["tokens"] > 0,
            f"serve_batched: K3/K4 launches {c}, {s['tokens']} tokens")
    ck = tempfile.mkdtemp(prefix="example_ckpt_", dir=ROOT / "build")
    t = example("torch_train_sparse_lm").main(
        ["--steps", "4", "--d-model", "64", "--layers", "2", "--seq", "16",
         "--batch", "2", "--ckpt", ck, "--ckpt-every", "2"])
    require(t["steps"] == 4 and t["masked"] > 0 and
            all(np.isfinite(t["losses"])) and
            sorted(p.name for p in Path(ck).iterdir())[-1:] ==
            ["step_00000004"],
            f"train_sparse_lm: {t['steps']} steps, {t['masked']} masked "
            f"tensors, losses {t['losses']}")
    print(f"examples: quickstart rel err {q['rel_err']:.3e} (K3, K4 once); "
          f"serve_batched --smoke --sparse {s['tokens']} tokens, "
          f"batch-composition invariant, K3/K4 {c}; train_sparse_lm 4 "
          f"steps, losses {[round(x, 4) for x in t['losses']]}, "
          f"{t['masked']} masked tensors still pruned, checkpoints at 2 "
          f"and 4 [{card}]")
    return launches


def table1_phase(card: str, vgg_stats):
    """Phase 24: VGG16's Figure-7 row from phase 4's stats (no rebuild),
    :func:`net_phase` for each of TABLE1_NETS, DEAD_NET through
    :func:`net_oracle` alone, then :func:`examples_phase`. Returns the
    nets' records, the K1/K2 records, the K1/K2 launches by path and
    the K3/K4 launches by example."""
    import torch
    from repro_torch.vision import measured_densities
    t_phase = time.perf_counter()
    sim = example("torch_sparse_cnn_sim")
    fd, md = measured_densities(vgg_stats)
    row = sim.figure7_row("VGGNet", len(vgg_stats), fd, md)
    print(f"VGG16 (phase 4, chunk) measured network densities: filters "
          f"{fd:.3f}, maps {md:.3f}")
    for line in sim.row_lines("VGGNet (phase 4's stats)", row):
        print(line)
    nets = {"VGG16": {"pattern": "chunk", "image_size": SIZE,
                      "layers": len(vgg_stats), "filter_density": fd,
                      "map_density": md, "fig7": row}}
    recs = {"walker": [], "grid": []}
    by_path = {"walker": {}, "grid": {}}
    for name, pattern, size in TABLE1_NETS:
        rec, kern = net_phase(name, pattern, size, card)
        nets[NET_LABEL[name]] = rec
        key = name.lower()
        by_path["grid"][f"{key}_oracle_check"] = \
            rec["launches"]["oracle_check_grid"]
        by_path["walker"][f"{key}_forward"] = \
            rec["launches"]["forward_walker"]
        by_path["walker"][f"{key}_engine"] = rec["launches"]["engine_walker"]
        for r1, r2 in kern:
            recs["walker"].append(r1)
            recs["grid"].append(r2)
        torch.cuda.empty_cache()
    name, pattern, size = DEAD_NET
    res, grid, live = net_oracle(name, pattern, size)
    require(live == 0.0, f"{NET_LABEL[name]} {pattern}: expected the pruned "
                         f"layer 1 to zero every later map")
    nets[f"{NET_LABEL[name]} {pattern}"] = {
        "pattern": pattern, "rel_err": res["rel_err"], "output_nonzero": live,
        "filter_density": res["filter_density"],
        "map_density": res["map_density"]}
    by_path["grid"][f"{name.lower()}_{pattern}_oracle_check"] = grid
    del res
    torch.cuda.empty_cache()
    k34 = examples_phase(card)
    print(f"  phase 24 {time.perf_counter() - t_phase:.1f} s [{card}]")
    return nets, recs, by_path, k34


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    from repro_torch.kernels._cuda import build_all
    from repro_torch.kernels.bitmask_spmm import BITMASK_SPMM
    from repro_torch.kernels.fused_ffn import FUSED_FFN
    from repro_torch.kernels.sparse_conv import CONV_GRID
    from repro_torch.kernels.worklist_core import WALK
    all_kernels = (WALK, CONV_GRID, BITMASK_SPMM, FUSED_FFN)

    # 1. card identity
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | device 0: {kind}")

    # 2. and 5. build
    t0 = time.perf_counter()
    secs = build_all(all_kernels)
    print(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
          f"(per source {secs})")
    for k in all_kernels:
        for line in k.build_log.splitlines():
            if any(s in line for s in ("Compiling entry", "registers",
                                       "spill", "smem")):
                print(f"  ptxas {k.source.name}: {line.strip()}")

    kernels, vgg_stats = drive(card)               # phases 3 and 4
    torch.cuda.empty_cache()
    nets, t1_recs, t1_paths, t1_k34 = table1_phase(card, vgg_stats)  # 24
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg, params = build_lm(dev)
    lm_admission_phase(cfg, params, card)          # phase 12 (Qwen3-4B)
    recs = ffn_kernel_phase(params, cfg, card)     # phase 6
    launches = {"qwen3_4b_serving": lm_serving_phase(cfg, params, card)}
    sampled_generate_phase(cfg, params, card)
    lm_oracle_phase(cfg, params)                   # phase 8
    k1_recs, k1_qwen = walker_ffn_phase(params, cfg, card)   # phase 9
    del params
    torch.cuda.empty_cache()
    rcfg, rparams = build_lm(dev, RWKV_ARCH)       # phase 10
    lm_admission_phase(rcfg, rparams, card)        # phase 12 (RWKV6-3B)
    for key, more in ffn_kernel_phase(rparams, rcfg, card).items():
        recs[key] += more
    launches["rwkv6_3b_serving"] = lm_serving_phase(rcfg, rparams, card)
    k1_rwkv, k1_rwkv_recs = channel_mix_compact_phase(rparams, rcfg, card)
    lm_oracle_phase(rcfg, rparams)
    del rparams
    torch.cuda.empty_cache()

    def add(path, result):
        launches[path], more = result
        for key in recs:
            recs[key] += more[key]
        torch.cuda.empty_cache()
    add("seamless_m4t_medium_generate", seamless_phase(dev, card))  # 13
    add("h2o_danube_3_4b_flash_prefill", danube_phase(dev, card))   # 14
    moe_phase(dev, card)                           # phase 15
    torch.cuda.empty_cache()
    mamba_phase(dev, card)                         # phase 16
    torch.cuda.empty_cache()
    add("paligemma_3b_prefix_forward", pali_phase(dev, card))      # 17
    add("yi_34b_serving", yi_phase(dev, card))                     # 18
    gc.collect()
    torch.cuda.empty_cache()
    arctic_phase(dev, card)                        # phase 19
    gc.collect()
    torch.cuda.empty_cache()
    slab_recs, slab_launches = lazy_phase(card)    # phase 11
    torch.cuda.empty_cache()
    mesh_rec, mesh_launches = mesh_phase(dev, card)   # phase 21
    torch.cuda.empty_cache()
    try:
        lm_mesh_phase(dev, card)                  # phase 22, phase 21's world
        serve_mesh_phase(dev, card)               # phase 23, the same world
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    vision_admission_phase(card, dev)              # phase 12 (VGG16)
    launches["qwen3_4b_trained_serving"] = train_phase(dev, card)   # 20
    torch.cuda.empty_cache()

    walker = kernels[0]
    walker["shapes"] += k1_recs + k1_rwkv_recs + slab_recs + \
        t1_recs["walker"]
    # per mode, the shape its path runs most: VGG16 layer 1 for the tile
    # mode, Qwen3-4B decode (4 rows) in bf16 for the grid modes
    modes = {}
    for r in walker["shapes"]:
        modes.setdefault(r["mode"], r)
        if r["at"].startswith("Qwen3-4B") and \
                "decode (4 rows), bfloat16" in r["at"]:
            modes[r["mode"]] = r
    walker["modes"] = modes
    walker["launches_by_path"] = {
        "vgg16_engine": walker["launches"],
        "qwen3_4b_ffn_compact": k1_qwen,
        "rwkv6_3b_channel_mix_compact": k1_rwkv, **slab_launches,
        **mesh_launches, "sharded_serve_steps_mesh": 0,
        **t1_paths["walker"]}
    # phase 23 (the dense sharded serve steps) launches none of the four
    grid = kernels[1]
    grid["launches_by_path"] = {
        "vgg16_oracle_check": grid["launches"],
        "sharded_serve_steps_mesh": 0, **t1_paths["grid"]}
    grid["shapes"] += t1_recs["grid"]
    launches["sharded_serve_steps_mesh"] = {"k3": 0, "k4": 0}
    launches.update(t1_k34)
    walker["vgg16_mesh"] = mesh_rec
    walker["table1_nets"] = nets
    for k in (walker, grid):
        k["launches"] = sum(k["launches_by_path"].values())
        for key in ("max_abs_err", "max_rel_err"):
            k[key] = max(r[key] for r in k["shapes"])
    meta = {
        "k3": ("bitmask_spmm", "src/repro_torch/csrc/bitmask_spmm.cu",
               "src/repro/kernels/bitmask_spmm.py:118"),
        "k4": ("fused_ffn_spmm", "src/repro_torch/csrc/fused_ffn.cu",
               "src/repro/kernels/fused_ffn.py:36"),
    }
    for key, (name, source, replaces) in meta.items():
        # headline: the decode regime in bf16, what serving runs most
        head = next(r for r in recs[key] if r["at"].startswith("Qwen3-4B")
                    and "decode" in r["at"] and "bfloat16" in r["at"])
        by_path = {path: n[key] for path, n in launches.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in recs[key]),
            "max_rel_err": max(r["max_rel_err"] for r in recs[key]),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "at": head["at"], "shapes": recs[key]})
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_all:.1f} s from the build's start "
          f"[{card}]")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
