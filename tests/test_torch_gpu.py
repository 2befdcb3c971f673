"""Card-only checks of the four CUDA kernels against their plain versions,
and of the port's bitwise invariants on the card. Every test is marked
``gpu`` and skips (through the ``cuda`` fixture) where there is no card.
This file imports neither JAX nor the reference, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.configs import load_smoke
from repro_torch.core.bitmask import block_sparsify
from repro_torch.kernels.bitmask_spmm import (BITMASK_SPMM, bitmask_spmm,
                                              bitmask_spmm_plain)
from repro_torch.kernels.fused_ffn import (FUSED_FFN, fused_ffn_spmm,
                                           fused_ffn_spmm_plain)
from repro_torch.models import model as M
from repro_torch.serve import Request, Scheduler, generate
from repro_torch.sparsity.sparse_ffn import sparse_ffn_apply, sparsify_model
from repro_torch.kernels.sparse_conv import (CONV_GRID, sparse_conv_spmm,
                                             sparse_conv_spmm_plain)
from repro_torch.kernels.worklist_core import (WALK, build_worklist,
                                               worklist_spmm,
                                               worklist_spmm_plain)
from repro_torch.vision import (VisionEngine, ImageRequest,
                                build_vision_model, compile_forward,
                                oracle_check)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(rng, dev, M=512, K=576, N=128, bk=64, bn=64, keep=0.4):
    w = rng.normal(size=(K, N)).astype(np.float32)
    tiles = rng.random((K // bk, N // bn)) < keep
    w *= np.repeat(np.repeat(tiles, bk, 0), bn, 1)
    x = np.abs(rng.normal(size=(M, K))).astype(np.float32)
    x[rng.random(x.shape) < 0.5] = 0
    x[:72] = 0                                  # dead sub-blocks and a slice
    return torch.as_tensor(x, device=dev), block_sparsify(w, bk, bn,
                                                          device=dev)


@pytest.mark.parametrize("bk,bn", [(32, 64), (64, 64), (128, 128), (96, 96)])
@pytest.mark.parametrize("act", [None, "relu"])
def test_walker_matches_plain(rng, cuda, bk, bn, act):
    x, w = _operands(rng, cuda, K=6 * bk, N=3 * bn, bk=bk, bn=bn)
    wl = build_worklist(w.host_indices(), x.shape[0] // 128)
    before = WALK.launches
    out, occ = worklist_spmm(x, w.vals, wl, bk=bk, bn=bn, sub_m=8, act=act,
                             emit_occupancy=True)
    assert WALK.launches == before + 1
    pout, pocc = worklist_spmm_plain(x, w.vals, wl, bk=bk, bn=bn,
                                     bm_rows=128, sub_m=8, act=act,
                                     emit_occupancy=True)
    torch.cuda.synchronize()
    rel = float((out - pout).abs().max() / pout.abs().max())
    assert rel <= 1e-5
    assert torch.equal(occ, pocc)


def test_walker_batched_equals_per_image_bitwise(rng, cuda):
    x, w = _operands(rng, cuda, M=4 * 256)
    whole = worklist_spmm(x, w.vals, build_worklist(w.host_indices(), 8),
                          bk=64, bn=64, act="relu")[0]
    wl1 = build_worklist(w.host_indices(), 2)
    parts = [worklist_spmm(x[i * 256:(i + 1) * 256].contiguous(), w.vals,
                           wl1, bk=64, bn=64, act="relu")[0]
             for i in range(4)]
    assert torch.equal(whole, torch.cat(parts))


@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("bk,bn", [(32, 64), (128, 128)])
def test_dense_grid_matches_plain(rng, cuda, two_sided, bk, bn):
    x, w = _operands(rng, cuda, K=6 * bk, N=3 * bn, bk=bk, bn=bn)
    before = CONV_GRID.launches
    out, occ, cnt = sparse_conv_spmm(x, w.indices, w.vals, bk=bk, bn=bn,
                                     sub_m=8, two_sided=two_sided,
                                     emit_occupancy=True, count_macs=True)
    assert CONV_GRID.launches == before + 1
    pout, pocc, pcnt = sparse_conv_spmm_plain(
        x, w.indices, w.vals, bk=bk, bn=bn, bm_rows=128, sub_m=8,
        two_sided=two_sided, fuse_relu=True, emit_occupancy=True,
        count_macs=True)
    torch.cuda.synchronize()
    assert float((out - pout).abs().max() / pout.abs().max()) <= 1e-5
    assert torch.equal(occ, pocc)
    assert torch.equal(cnt, pcnt)
    # same fp32 sum order as the walker: the two kernels agree bitwise
    wl = build_worklist(w.host_indices(), x.shape[0] // 128)
    assert torch.equal(out, worklist_spmm(x, w.vals, wl, bk=bk, bn=bn,
                                          act="relu")[0])


@pytest.mark.parametrize("sub_m", [8, 64])
@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("bm_rows", [64, 128, 256])
def test_dense_grid_dead_tiles_and_holes(rng, cuda, two_sided, bm_rows,
                                         sub_m):
    """The grid conv with all-dead 32-row tiles (the first 72 rows zero), a
    -1 slot between stored ones, row blocks of 64, 128 and 256 rows, and
    sub-blocks of 8 or 64 rows (a sub-block over two CTAs): the plain
    version's output, occupancy and counts, the walker's bits."""
    x, w = _operands(rng, cuda, M=512, K=6 * 64, N=3 * 64, bk=64, bn=64)
    idx = torch.cat([w.indices[:, :1], torch.full_like(w.indices[:, :1], -1),
                     w.indices[:, 1:]], 1).contiguous()
    vals = torch.cat([w.vals[:, :1], torch.zeros_like(w.vals[:, :1]),
                      w.vals[:, 1:]], 1).contiguous()
    kw = dict(bk=64, bn=64, bm_rows=bm_rows, sub_m=sub_m,
              two_sided=two_sided, emit_occupancy=True, count_macs=True)
    out, occ, cnt = sparse_conv_spmm(x, idx, vals, **kw)
    pout, pocc, pcnt = sparse_conv_spmm_plain(x, idx, vals, fuse_relu=True,
                                              **kw)
    torch.cuda.synchronize()
    assert float((out - pout).abs().max() / pout.abs().max()) <= 1e-5
    assert torch.equal(occ, pocc) and torch.equal(cnt, pcnt)
    assert bool((out[:64] == 0).all())
    wl = build_worklist(idx.cpu().numpy(), x.shape[0] // bm_rows)
    assert torch.equal(out, worklist_spmm(x, vals, wl, bk=64, bn=64,
                                          bm_rows=bm_rows, act="relu")[0])


def test_vgg_head_oracle_and_engine_on_card(rng, cuda):
    model = build_vision_model("VGGNet", num_layers=3, pattern="chunk",
                               device=cuda)
    imgs = np.abs(rng.normal(size=(3, 32, 32, 3))).astype(np.float32)
    _, _, rel = oracle_check(model, torch.as_tensor(imgs[:1], device=cuda))
    assert rel <= 1e-5
    produced = VisionEngine(model, num_slots=2).run(
        [ImageRequest(i, imgs[i], arrival=i) for i in range(3)])
    solo = compile_forward(model)
    for i in range(3):
        one = solo(torch.as_tensor(imgs[i:i + 1], device=cuda))
        np.testing.assert_array_equal(produced[i], one[0].cpu().numpy())


def _ffn_operands(rng, dev, dtype, M=256, K=384, nb=3, mnz=3, live=None):
    """x with zero rows and zero sub-blocks, -1 padded chunk lists."""
    x = rng.normal(size=(M, K)).astype(np.float32)
    if live is not None:
        x[live:] = 0
    x[8:24] = 0
    x[40:48, :128] = 0
    idx = np.array([[0, 2, -1], [1, -1, -1], [2, 1, 0]][:nb], np.int32)
    vals = rng.normal(size=(nb, mnz, 128, 128)).astype(np.float32) * 0.05
    vals[idx < 0] = 0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return t(x).to(dtype), t(idx), t(vals).to(dtype)


def _close(got, ref, dtype):
    g, r = got.float(), ref.float()
    if dtype == torch.float32:
        assert float((g - r).abs().max() / r.abs().max()) <= 1e-5
    else:
        # both sum in fp32 and round once: within an ulp but for sums the
        # two orders nearly cancel, which the fp32 gate bounds
        ulp = r.abs().clamp_min(1e-3) * 2.0 ** -7
        assert bool(((g - r).abs() <= ulp).all())


# Shapes the K3/K4 grid (32-row blocks of 16- or 32-column groups, two
# thread layouts) must take: the base operands, three row blocks, bk/bn 64
# and 96/64 (a ragged last column group), live rows only in the last 8-row
# tile of a block, and -1 slots between stored ones, with (for K4) slots
# live in the gate stream only and in the in stream only.
GRID_CASES = ["base", "m384", "bk64_bn64", "bk96_bn64", "last_tile", "holes"]


def _grid_case(rng, dev, dtype, case):
    """x, in and gate chunk lists (-1 padded, zero tiles behind every -1),
    and the tile (bk, bn) of one GRID_CASES case."""
    M = {"m384": 384, "last_tile": 128}.get(case, 256)
    bk, bn = {"bk64_bn64": (64, 64), "bk96_bn64": (96, 64)}.get(case,
                                                                (128, 128))
    idx = np.array([[0, 2, -1], [1, -1, -1], [2, 1, 0]], np.int32)
    gidx = idx[::-1].copy()
    if case == "holes":
        idx = np.array([[0, -1, 2], [1, -1, -1], [-1, 1, 0]], np.int32)
        gidx = np.array([[-1, 2, 1], [0, -1, 2], [2, -1, -1]], np.int32)
    x = rng.normal(size=(M, 3 * bk)).astype(np.float32)
    x[8:24] = 0
    x[40:48, :bk] = 0
    if case == "last_tile":
        x[:120] = 0
    vals, gvals = (rng.normal(size=(3, 3, bk, bn)).astype(np.float32) * 0.05
                   for _ in range(2))
    vals[idx < 0] = 0
    gvals[gidx < 0] = 0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (t(x).to(dtype), t(idx), t(vals).to(dtype), t(gidx),
            t(gvals).to(dtype), bk, bn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("sub_m", [8, 16, 128])
@pytest.mark.parametrize("case", GRID_CASES)
def test_bitmask_spmm_matches_plain(rng, cuda, dtype, two_sided, sub_m,
                                    case):
    x, idx, vals, _, _, bk, bn = _grid_case(rng, cuda, dtype, case)
    kw = dict(bk=bk, bn=bn, bm=128, sub_m=sub_m, two_sided=two_sided,
              count_macs=True)
    before = BITMASK_SPMM.launches
    out, cnt = bitmask_spmm(x, idx, vals, **kw)
    assert BITMASK_SPMM.launches == before + 1
    pout, pcnt = bitmask_spmm_plain(x, idx, vals, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    _close(out, pout, dtype)
    assert torch.equal(cnt, pcnt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "relu", "gelu"])
@pytest.mark.parametrize("case", GRID_CASES)
def test_fused_ffn_matches_plain(rng, cuda, dtype, act, case):
    x, idx, vals, gidx, gvals, bk, bn = _grid_case(rng, cuda, dtype, case)
    x[200:] = 0
    gated = act in ("swiglu", "geglu")
    g_idx, g_vals = (gidx, gvals) if gated else (None, None)
    kw = dict(act=act, bk=bk, bn=bn, bm=128, sub_m=8, two_sided=True)
    before = FUSED_FFN.launches
    h = fused_ffn_spmm(x, idx, vals, g_idx, g_vals, **kw)
    assert FUSED_FFN.launches == before + 1
    ph = fused_ffn_spmm_plain(x, idx, vals, g_idx, g_vals, **kw)
    torch.cuda.synchronize()
    _close(h, ph, dtype)
    assert bool((h[200:] == 0).all())          # zero rows stay exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("M", [8, 40])
def test_lm_kernels_take_a_partial_row_tile(rng, cuda, dtype, two_sided, M):
    """K3 and K4 at 8-row blocks whose last 32-row tile is partial: the
    plain versions' outputs and counts."""
    x, idx, vals, gidx, gvals, bk, bn = _grid_case(rng, cuda, dtype, "base")
    x = x[:M].contiguous()
    kw = dict(bk=bk, bn=bn, bm=8, sub_m=8, two_sided=two_sided)
    out, cnt = bitmask_spmm(x, idx, vals, count_macs=True, **kw)
    pout, pcnt = bitmask_spmm_plain(x, idx, vals, count_macs=True, **kw)
    h = fused_ffn_spmm(x, idx, vals, gidx, gvals, act="swiglu", **kw)
    ph = fused_ffn_spmm_plain(x, idx, vals, gidx, gvals, act="swiglu", **kw)
    torch.cuda.synchronize()
    assert out.shape == (M, 3 * bn) and h.shape == (M, 3 * bn)
    _close(out, pout, dtype)
    _close(h, ph, dtype)
    assert torch.equal(cnt, pcnt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_kernels_rows_independent_bitwise(rng, cuda, dtype):
    """A decode block gives bit for bit what each lane gives alone."""
    x, idx, vals = _ffn_operands(rng, cuda, dtype, M=128, live=4)
    kw = dict(act="swiglu", bk=128, bn=128, bm=128, sub_m=8)
    h = fused_ffn_spmm(x, idx, vals, idx, vals, **kw)
    o = bitmask_spmm(x, idx, vals, bm=128, sub_m=8, two_sided=True)
    for i in range(4):
        xi = torch.zeros_like(x)
        xi[0] = x[i]
        assert torch.equal(fused_ffn_spmm(xi, idx, vals, idx, vals,
                                          **kw)[0], h[i])
        assert torch.equal(bitmask_spmm(xi, idx, vals, bm=128, sub_m=8,
                                        two_sided=True)[0], o[i])


def test_sparse_lm_serving_on_card(cuda):
    """Smoke Qwen3 (fp32) through both FFN kernels: batched == solo, and
    the card's tokens equal the CPU plain path's."""
    cfg = dataclasses.replace(load_smoke("qwen3_4b"), d_model=256, d_ff=640,
                              sparse_ffn=True)
    params = sparsify_model(M.init_params(cfg, seed=0, device=cuda), cfg,
                            density=0.35, num_shards=4)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (3, 8))
    reqs = [Request(i, prompts[i], 6, arrival=i) for i in range(3)]
    b3, b4 = BITMASK_SPMM.launches, FUSED_FFN.launches
    got = Scheduler(cfg, params, num_slots=2, max_len=16).run(reqs)
    assert BITMASK_SPMM.launches > b3 and FUSED_FFN.launches > b4
    for r in reqs:
        solo = Scheduler(cfg, params, num_slots=2, max_len=16).run(
            [Request(r.rid, r.prompt, r.max_new)])
        assert solo[r.rid] == got[r.rid]
    cpu = M.map_tree(lambda t: t.cpu(), params)
    ref = Scheduler(cfg, cpu, num_slots=2, max_len=16).run(
        [Request(r.rid, r.prompt, r.max_new, r.arrival) for r in reqs])
    assert ref == got


def _two_stream_operands(rng, dev, dtype, M=64, live=50):
    """x at 8-row blocks with zero rows and sub-blocks; in and gate chunk
    lists on one slot axis (the gate's are the in lists reversed)."""
    x, idx, vals = _ffn_operands(rng, dev, torch.float32, M=M, live=live)
    gidx, gvals = torch.flip(idx, [0]).contiguous(), \
        torch.flip(vals, [0]).contiguous()
    return x.to(dtype), idx, vals.to(dtype), gidx, gvals.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "relu", "gelu"])
def test_walker_two_stream_matches_plain(rng, cuda, dtype, act):
    x, idx, vals, gidx, gvals = _two_stream_operands(rng, cuda, dtype)
    occ = (x.reshape(8, 8, 3, 128) != 0).any(3).any(1).cpu().numpy()
    wl = build_worklist(idx.cpu().numpy(), 8, occ_blk=occ,
                        gate_indices=gidx.cpu().numpy())
    assert ((wl.k < 0) & (wl.k2 >= 0)).any()    # gate-only steps
    kw = dict(bk=128, bn=128, bm_rows=8, act=act)
    before = WALK.launches
    out = worklist_spmm(x, vals, wl, vals2=gvals, **kw)[0]
    assert WALK.launches == before + 1
    pout = worklist_spmm_plain(x, vals, wl, vals2=gvals, sub_m=8,
                               emit_occupancy=False, **kw)[0]
    torch.cuda.synchronize()
    assert out.dtype == dtype
    _close(out, pout, dtype)
    assert bool((out[50:] == 0).all())
    if dtype == torch.bfloat16:
        # fp32 sums rounded once: the fp32 run on the widened inputs
        out32 = worklist_spmm(x.float(), vals.float(), wl,
                              vals2=gvals.float(), **kw)[0]
        assert torch.equal(out, out32.to(torch.bfloat16))


# (weight streams, act) of the walker's grid mode: every act, the gated
# ones on two streams
WALK_GRID_ACTS = [(1, None), (1, "relu"), (1, "relu2"), (1, "gelu"),
                  (2, "swiglu"), (2, "geglu")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("streams,act", WALK_GRID_ACTS)
@pytest.mark.parametrize("M", [8, 24, 40, 128])
def test_walker_grid_mode_matches_plain(rng, cuda, dtype, streams, act, M):
    """K1 at 8-row blocks (its grid mode, a partial last 32-row tile below
    M = 128): the plain version's output and occupancy, padded rows exact
    zeros, and in bf16 the rounding of its own fp32 sums."""
    live = M - 2
    x, idx, vals, gidx, gvals = _two_stream_operands(rng, cuda, dtype, M=M,
                                                     live=live)
    occ = (x.reshape(M // 8, 8, 3, 128) != 0).any(3).any(1).cpu().numpy()
    two = streams == 2
    wl = build_worklist(idx.cpu().numpy(), M // 8, occ_blk=occ,
                        gate_indices=gidx.cpu().numpy() if two else None)
    v2 = gvals if two else None
    kw = dict(bk=128, bn=128, bm_rows=8, sub_m=8, act=act,
              emit_occupancy=True)
    before = WALK.launches
    out, occ_out = worklist_spmm(x, vals, wl, vals2=v2, **kw)
    assert WALK.launches == before + 1
    pout, pocc = worklist_spmm_plain(x, vals, wl, vals2=v2, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (M, 3 * 128)
    _close(out, pout, dtype)
    assert torch.equal(occ_out, pocc)
    assert bool((out[live:] == 0).all())
    if dtype == torch.bfloat16:
        out32 = worklist_spmm(x.float(), vals.float(), wl,
                              vals2=v2.float() if two else None, **kw)[0]
        assert torch.equal(out, out32.to(torch.bfloat16))


@pytest.mark.parametrize("bm_rows", [16, 32])
@pytest.mark.parametrize("act", ["swiglu", "relu"])
def test_walker_grid_mode_wider_row_blocks(rng, cuda, bm_rows, act):
    """16- and 32-row blocks also run on the grid (one CTA covers two
    pairs, or one)."""
    M = 96
    x, idx, vals, gidx, gvals = _two_stream_operands(rng, cuda,
                                                     torch.float32, M=M,
                                                     live=80)
    two = act == "swiglu"
    wl = build_worklist(idx.cpu().numpy(), M // bm_rows,
                        gate_indices=gidx.cpu().numpy() if two else None)
    v2 = gvals if two else None
    kw = dict(bk=128, bn=128, bm_rows=bm_rows, sub_m=8, act=act,
              emit_occupancy=True)
    out, occ_out = worklist_spmm(x, vals, wl, vals2=v2, **kw)
    pout, pocc = worklist_spmm_plain(x, vals, wl, vals2=v2, **kw)
    torch.cuda.synchronize()
    _close(out, pout, torch.float32)
    assert torch.equal(occ_out, pocc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "relu", "gelu"])
@pytest.mark.parametrize("rows", [2, 4, 128])
def test_compact_schedule_equals_dense_bitwise(rng, cuda, dtype, act, rows):
    """The work-list FFN (K1, two streams for the gated acts, then one)
    gives bit for bit what the dense grid (K4 then K3) gives."""
    x, idx, vals, gidx, gvals = _two_stream_operands(rng, cuda, dtype,
                                                     M=128, live=rows)
    x[:rows][x[:rows].abs() < 0.5] = 0          # zero sub-blocks and chunks
    sp = {"in_indices": idx, "in_vals": vals, "out_indices": gidx,
          "out_vals": gvals}
    if act in ("swiglu", "geglu"):
        sp.update(gate_indices=gidx, gate_vals=gvals)
    before = WALK.launches
    got = sparse_ffn_apply(sp, x[:rows], act, schedule="compact")
    assert WALK.launches == before + 2
    want = sparse_ffn_apply(sp, x[:rows], act)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


def test_sparse_rwkv_serving_on_card(cuda):
    """Smoke RWKV6 (fp32) through K3/K4 on the channel-mix: batched ==
    solo, and the card's tokens equal the CPU plain path's."""
    cfg = load_smoke("rwkv6_3b")
    params = sparsify_model(M.init_params(cfg, seed=0, device=cuda), cfg,
                            density=0.35, num_shards=4)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (3, 8))
    reqs = [Request(i, prompts[i], 6, arrival=i) for i in range(3)]
    b3, b4 = BITMASK_SPMM.launches, FUSED_FFN.launches
    got = Scheduler(cfg, params, num_slots=2, max_len=16).run(reqs)
    assert BITMASK_SPMM.launches > b3 and FUSED_FFN.launches > b4
    for r in reqs:
        solo = Scheduler(cfg, params, num_slots=2, max_len=16).run(
            [Request(r.rid, r.prompt, r.max_new)])
        assert solo[r.rid] == got[r.rid]
    cpu = M.map_tree(lambda t: t.cpu(), params)
    ref = Scheduler(cfg, cpu, num_slots=2, max_len=16).run(
        [Request(r.rid, r.prompt, r.max_new, r.arrival) for r in reqs])
    assert ref == got


# The walker's tile mode (csrc/walk.cu, row blocks not dividing 32)
def _tile_operands(rng, dev, dtype, M, bk, bn, nb=3, kb=6):
    """x with all-zero 8-row sub-blocks inside chunks the list schedules
    (rows 64..79 everywhere, rows 104..111 in the first two chunks, and
    _operands' zero rows) and chunk-sparse weights."""
    x, w = _operands(rng, dev, M=M, K=kb * bk, N=nb * bn, bk=bk, bn=bn)
    x[64:80] = 0
    x[104:112, :2 * bk] = 0
    return x.to(dtype), w, w.vals.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm_rows,sub_m", [
    (64, 8), (64, 16), (64, 64), (128, 8), (128, 16), (128, 64), (128, 128),
    (256, 8), (256, 16), (256, 64), (256, 128)])
@pytest.mark.parametrize("bk,bn", [(64, 64), (128, 128)])
def test_walker_tile_mode_matches_plain(rng, cuda, dtype, bm_rows, sub_m, bk,
                                        bn):
    """K1's tile mode against its plain version: output (fp32 rel err, bf16
    the rounding of its own fp32 sums) and occupancy, with live chunks
    whose 8-row sub-blocks are all zero in x. The occupancy's sub-blocks
    lie in one warp's band (one ballot), in one CTA tile over several
    bands, or over several CTA tiles (sub_m 64 and 128 at 32-row tiles:
    integer atomics into a zeroed map)."""
    from repro_torch.kernels.grid import WalkTiles
    from repro_torch.kernels.worklist_core import walk_mode
    x, w, vals = _tile_operands(rng, cuda, dtype, 512, bk, bn)
    wl = build_worklist(w.host_indices(), 512 // bm_rows)
    assert isinstance(walk_mode(x, vals, None, wl, bk=bk, bn=bn,
                                bm_rows=bm_rows), WalkTiles)
    kw = dict(bk=bk, bn=bn, bm_rows=bm_rows, sub_m=sub_m, act="relu",
              emit_occupancy=True)
    before = WALK.launches
    out, occ = worklist_spmm(x, vals, wl, **kw)
    assert WALK.launches == before + 1
    pout, pocc = worklist_spmm_plain(x, vals, wl, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    _close(out, pout, dtype)
    assert torch.equal(occ, pocc)
    assert bool((out[64:80] == 0).all())
    if dtype == torch.bfloat16:
        out32 = worklist_spmm(x.float(), vals.float(), wl, **kw)[0]
        assert torch.equal(out, out32.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_walker_tile_mode_two_streams(rng, cuda, dtype, act):
    """Two weight streams with a gated act at bm_rows = 128: the tile
    mode's two-stream kernel against the plain version, with steps live in
    one stream only."""
    x, idx, vals, gidx, gvals = _two_stream_operands(rng, cuda, dtype,
                                                     M=256, live=200)
    occ = (x.reshape(2, 128, 3, 128) != 0).any(3).any(1).cpu().numpy()
    occ[1, 0] = False
    wl = build_worklist(idx.cpu().numpy(), 2, occ_blk=occ,
                        gate_indices=gidx.cpu().numpy())
    assert ((wl.k < 0) & (wl.k2 >= 0)).any() or \
        ((wl.k >= 0) & (wl.k2 < 0)).any()
    kw = dict(bk=128, bn=128, bm_rows=128, sub_m=8, act=act,
              emit_occupancy=True)
    out, occ_out = worklist_spmm(x, vals, wl, vals2=gvals, **kw)
    pout, pocc = worklist_spmm_plain(x, vals, wl, vals2=gvals, **kw)
    torch.cuda.synchronize()
    _close(out, pout, dtype)
    assert torch.equal(occ_out, pocc)
    assert bool((out[200:] == 0).all())
    if dtype == torch.bfloat16:
        out32 = worklist_spmm(x.float(), vals.float(), wl,
                              vals2=gvals.float(), **kw)[0]
        assert torch.equal(out, out32.to(torch.bfloat16))


@pytest.mark.parametrize("bm_rows", [64, 128, 256])
@pytest.mark.parametrize("bk,bn", [(32, 64), (64, 64), (128, 128)])
def test_walker_tile_mode_equals_dense_grid_bitwise(rng, cuda, bm_rows, bk,
                                                    bn):
    """K1's tile mode == K2 bit for bit on random operands with zero rows
    and sub-blocks (the same fp32 chains; K2 predicates off what K1's
    warps skip)."""
    x, w, vals = _tile_operands(rng, cuda, torch.float32, 512, bk, bn)
    wl = build_worklist(w.host_indices(), 512 // bm_rows)
    k1 = worklist_spmm(x, vals, wl, bk=bk, bn=bn, bm_rows=bm_rows,
                       act="relu")[0]
    k2 = sparse_conv_spmm(x, w.indices, vals, bk=bk, bn=bn, bm_rows=bm_rows,
                          sub_m=8)[0]
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_walker_tile_mode_batched_equals_per_image(rng, cuda, dtype):
    """A batch of 4 images gives bit for bit what each image gives alone,
    though the tile geometry differs between the two launches."""
    x, w, vals = _tile_operands(rng, cuda, dtype, 4 * 256, 128, 128)
    kw = dict(bk=128, bn=128, bm_rows=128, act="relu")
    whole = worklist_spmm(x, vals, build_worklist(w.host_indices(), 8),
                          **kw)[0]
    wl1 = build_worklist(w.host_indices(), 2)
    parts = [worklist_spmm(x[i * 256:(i + 1) * 256].contiguous(), vals, wl1,
                           **kw)[0] for i in range(4)]
    torch.cuda.synchronize()
    assert torch.equal(whole, torch.cat(parts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_walker_tile_mode_same_bits_for_every_tile(rng, cuda, dtype,
                                                   monkeypatch):
    """Every CTA tile and thread tile the mode builds gives the same bits
    (the geometry only splits rows and columns), and so do its plain
    copies."""
    import dataclasses
    from repro_torch.kernels import worklist_core as wc
    x, w, vals = _tile_operands(rng, cuda, dtype, 512, 128, 128)
    wl = build_worklist(w.host_indices(), 4)
    kw = dict(bk=128, bn=128, bm_rows=128, sub_m=8, act="relu",
              emit_occupancy=True)
    want, wocc = worklist_spmm(x, vals, wl, **kw)
    chosen = wc.walk_mode

    for tm, cols, rows, tma in [
            (8, 128, 32, True), (8, 128, 128, True), (8, 64, 64, True),
            (4, 128, 64, True), (4, 32, 128, True), (4, 64, 32, False)]:
        def forced(*a, _g=(tm, cols, rows, tma), **k):
            return dataclasses.replace(
                chosen(*a, **k), thread_rows=_g[0], cols=_g[1], rows=_g[2],
                tma=_g[3])
        monkeypatch.setattr(wc, "walk_mode", forced)
        got, occ = worklist_spmm(x, vals, wl, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (tm, cols, rows, tma)
        assert torch.equal(occ, wocc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bk", [10, 12, 36])
def test_walker_tile_mode_plain_copies(rng, cuda, dtype, bk):
    """Rows the tensor copies refuse (K not a multiple of 16 bytes) or a
    chunk 32 does not divide: the tile mode with plain copies or a partial
    last stage, against the plain version."""
    from repro_torch.kernels.grid import walk_tma_problem
    from repro_torch.kernels.worklist_core import walk_mode
    x, w, vals = _tile_operands(rng, cuda, dtype, 256, bk, 64, kb=3)
    wl = build_worklist(w.host_indices(), 2)
    mode = walk_mode(x, vals, None, wl, bk=bk, bn=64, bm_rows=128)
    assert mode.tma == (walk_tma_problem(x, [("vals", vals)], 64, bk)
                        is None)
    kw = dict(bk=bk, bn=64, bm_rows=128, sub_m=8, act="relu",
              emit_occupancy=True)
    out, occ = worklist_spmm(x, vals, wl, **kw)
    pout, pocc = worklist_spmm_plain(x, vals, wl, **kw)
    torch.cuda.synchronize()
    _close(out, pout, dtype)
    assert torch.equal(occ, pocc)


# ---------------------------------------------------------------------------
# the walker's tap-slab operand (lazy im2col)
# ---------------------------------------------------------------------------
# (images, H, W, cin, cout, k, stride, padding, bk, bn, bm_rows): several
# images whose m_img a tile passes (14 x 14 = 196 of 256 rows, 7 x 7 of
# 64), stride 2 SAME and VALID, a 1x1 window, a whole-image row block, and
# pixels of 40 bytes, which the im2col copies refuse (plain copies)
TAP_CASES = {
    "s1_same_pad_rows": (2, 14, 14, 64, 64, 3, 1, "SAME", 64, 64, 128),
    "s2_valid": (2, 13, 9, 32, 64, 3, 2, "VALID", 32, 64, 64),
    "s2_same": (3, 12, 12, 32, 128, 3, 2, "SAME", 32, 128, 64),
    "k1_whole_image": (3, 7, 7, 128, 128, 1, 1, "VALID", 128, 128, 64),
    "plain_copies": (2, 9, 11, 20, 64, 3, 1, "SAME", 10, 64, 128),
}


def _tap_layer(rng, dev, dtype, case):
    from repro_torch.sparsity.conv import pack_conv_filters
    B, H, W, cin, cout, k, stride, padding, bk, bn, bm_rows = TAP_CASES[case]
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    keep = rng.random((k * k * cin // bk, cout // bn)) < 0.5
    keep[0] = True                      # every n-block keeps a chunk
    w = (w.reshape(-1, cout) * np.repeat(np.repeat(keep, bk, 0), bn, 1)) \
        .reshape(k, k, cin, cout)
    x = np.abs(rng.normal(size=(B, H, W, cin))).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = 0
    x[0, : H // 2] = 0                           # dead rows of image 0
    packed = pack_conv_filters(w, layout="tap", bk=bk, bn=bn, device=dev)
    packed = dataclasses.replace(packed, vals=packed.vals.to(dtype))
    return (torch.as_tensor(x, device=dev).to(dtype), packed, k, cout,
            dict(stride=stride, padding=padding, bm_rows=bm_rows,
                 layout="tap"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(TAP_CASES))
@pytest.mark.parametrize("occupancy", [True, False])
def test_walker_tap_slabs_match_plain_and_patch_matrix(rng, cuda, dtype,
                                                       case, occupancy):
    """K1 reading the tap slabs from the NHWC map: bitwise K1 on the taps
    patch matrix (output and occupancy), and within the plain version's
    tolerance, with exactly its occupancy; counted as one launch."""
    from repro_torch.kernels.sparse_conv import sparse_conv2d_nhwc
    x, packed, k, cout, kw = _tap_layer(rng, cuda, dtype, case)
    kw.update(emit_occupancy=occupancy)
    before = WALK.launches
    lazy, la = sparse_conv2d_nhwc(x, packed, k, k, cout, im2col="lazy", **kw)
    assert WALK.launches == before + 1
    taps, ta = sparse_conv2d_nhwc(x, packed, k, k, cout, im2col="taps", **kw)
    cpu = dataclasses.replace(packed, indices=packed.indices.cpu(),
                              vals=packed.vals.cpu())
    plain, pa = sparse_conv2d_nhwc(x.cpu(), cpu, k, k, cout, im2col="lazy",
                                   **kw)
    torch.cuda.synchronize()
    assert torch.equal(lazy, taps)
    _close(lazy.cpu(), plain, dtype)
    if occupancy:
        assert torch.equal(la["occupancy"], ta["occupancy"])
        if dtype == torch.float32:
            assert torch.equal(la["occupancy"].cpu(), pa["occupancy"])


def test_walker_tap_slabs_plain_copies_same_bits(rng, cuda, monkeypatch):
    """The plain-copy body with the im2col copies' address map gives the
    bits the tensor copies give, at a shape both take."""
    from repro_torch.kernels import worklist_core as wc
    from repro_torch.kernels.sparse_conv import sparse_conv2d_nhwc
    x, packed, k, cout, kw = _tap_layer(rng, cuda, torch.float32,
                                        "s1_same_pad_rows")
    kw.update(emit_occupancy=True)
    want, wa = sparse_conv2d_nhwc(x, packed, k, k, cout, im2col="lazy", **kw)
    chosen = wc.walk_mode
    monkeypatch.setattr(wc, "walk_mode", lambda *a, **k_: dataclasses.replace(
        chosen(*a, **k_), tma=False))
    got, ga = sparse_conv2d_nhwc(x, packed, k, k, cout, im2col="lazy", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(ga["occupancy"], wa["occupancy"])


@pytest.mark.parametrize("tma", [True, False])
def test_walker_tap_slabs_take_a_layer_output_view(rng, cuda, monkeypatch,
                                                   tma):
    """A layer's output cut from its padded rows (images m_pad pixels
    apart) is read in place, with the bits of its contiguous copy."""
    from repro_torch.kernels import worklist_core as wc
    from repro_torch.kernels.sparse_conv import sparse_conv2d_nhwc
    x, packed, k, cout, kw = _tap_layer(rng, cuda, torch.float32,
                                        "s1_same_pad_rows")
    B, H, W, C = x.shape
    buf = torch.zeros((B, H * W + 60, C), device=cuda)
    buf[:, :H * W] = x.reshape(B, H * W, C)
    view = buf[:, :H * W].reshape(B, H, W, C)
    assert not view.is_contiguous() and wc.map_pixels_contiguous(view)
    if not tma:
        chosen = wc.walk_mode
        monkeypatch.setattr(wc, "walk_mode", lambda *a, **k_:
                            dataclasses.replace(chosen(*a, **k_), tma=False))
    got, ga = sparse_conv2d_nhwc(view, packed, k, k, cout, im2col="lazy",
                                 emit_occupancy=True, **kw)
    want, wa = sparse_conv2d_nhwc(x, packed, k, k, cout, im2col="taps",
                                  emit_occupancy=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(ga["occupancy"], wa["occupancy"])


def test_walker_tap_slabs_reject_what_the_kernel_does_not_take(rng, cuda):
    from repro_torch.kernels.sparse_conv import worklist_spmm_slabs
    x, packed, k, cout, kw = _tap_layer(rng, cuda, torch.float32, "s2_valid")
    wl = build_worklist(packed.host_indices(), 2, mb_per_img=1)
    args = dict(kh=3, kw=3, stride=2, padding="VALID", bk=32, bn=64,
                bm_rows=64, sub_m=8, m_pad=64)
    worklist_spmm_slabs(x, packed.vals, wl, **args)
    with pytest.raises(ValueError):                 # pixels not contiguous
        worklist_spmm_slabs(x.transpose(1, 2), packed.vals, wl, **args)
    with pytest.raises(ValueError):                 # dtype mismatch
        worklist_spmm_slabs(x.double(), packed.vals, wl, **args)
    with pytest.raises(ValueError):                 # cin % bk
        worklist_spmm_slabs(x, packed.vals, wl, **dict(args, bk=24))


def test_tuned_and_lazy_forward_bitwise_default_on_card(cuda):
    """The autotuned forward (whole-image row blocks, lazy tap slabs) and a
    forward pinned to lazy at 128-row blocks equal the default forward."""
    from repro_torch.kernels.autotune import (ConvTileConfig, autotune_conv,
                                              autotune_model)
    rng = np.random.default_rng(3)
    model = build_vision_model("VGGNet", density=1 / 3, num_layers=4,
                               pattern="chunk", seed=0, device=cuda)
    x = np.abs(rng.normal(size=(2, 32, 32, 3))).astype(np.float32)
    x[rng.random(x.shape) >= 0.4] = 0.0
    xt = torch.as_tensor(x, device=cuda)
    default = compile_forward(model)(xt)
    autotune_model(model, 32, batch=2)
    tuned = compile_forward(model, use_tuned=True)(xt)
    for layer in model.layers:
        c = layer.conv
        if c.layout == "tap":
            autotune_conv(c, c.tuned.m_img, candidates=[ConvTileConfig(
                bm_rows=128, bn=c.packed.bn, sub_m=8, im2col="lazy")])
    before = WALK.launches
    lazy = compile_forward(model, use_tuned=True)(xt)
    torch.cuda.synchronize()
    assert WALK.launches == before + model.num_layers
    assert torch.equal(tuned, default)
    assert torch.equal(lazy, default)


def test_vision_server_outputs_bitwise_solo_on_card(cuda):
    from repro_torch.serve.vision import VirtualClock, VisionServer
    from repro_torch.vision import fit_image, route_bucket
    rng = np.random.default_rng(5)
    model = build_vision_model("VGGNet", density=0.4, num_layers=2,
                               pattern="chunk", seed=0, device=cuda)
    sizes = (10, 16, 5, 20, 8, 16)
    reqs = [ImageRequest(rid=i, image=np.abs(rng.normal(size=(s, s, 3)))
                         .astype(np.float32), arrival_s=0.1 * i,
                         deadline_s=0.1 * i + 1.0)
            for i, s in enumerate(sizes)]
    srv = VisionServer(model, num_slots=2, buckets=(8, 16),
                       clock=VirtualClock(), step_cost_s=0.1)
    out = srv.run(reqs)
    assert srv.stats.sla_misses == 0
    fwd = compile_forward(model)
    for r in reqs:
        canon = fit_image(r.image, route_bucket(srv.buckets,
                                                *r.image.shape[:2]))
        one = fwd(torch.as_tensor(canon[None], device=cuda))[0]
        assert np.array_equal(out[r.rid], one.cpu().numpy())


# ---------------------------------------------------------------------------
# admission: the artifact verifier on card tensors (repro_torch.analysis)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qwen_layer():
    """Sparse Qwen3-4B at full width, one layer, bf16, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import load_config
    cfg = dataclasses.replace(load_config("qwen3_4b"), n_layers=1,
                              sparse_ffn=True)
    params = M.init_params(cfg, seed=0, device=torch.device("cuda"))
    return cfg, sparsify_model(params, cfg, density=0.35, num_shards=4,
                               strict=True)


def _pad_tile_copy(sp):
    """A copy of a leaf dict whose n-block 0 has its last (live) slot marked
    -1: a non-zero tile at a padding slot. The values are shared."""
    bad = dict(sp)
    idx = sp["in_indices"].clone()
    assert int(idx[0, -1]) >= 0
    idx[0, -1] = -1
    bad["in_indices"] = idx
    return bad


def test_admission_copies_no_values_to_host(cuda, qwen_layer):
    """The Scheduler's admission gate over a bf16 Qwen3-4B layer moves
    index tables and flags to the host, never a value tensor."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class HostCopies(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.moved = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in tree_leaves((args, kwargs))):
                self.moved += [o.numel() for o in tree_leaves(out)
                               if isinstance(o, torch.Tensor)
                               and o.device.type == "cpu"]
            return out

    cfg, params = qwen_layer
    sp = params["blocks"][0]["p0"]["ffn_sparse"]
    assert sp["in_vals"].dtype == torch.bfloat16
    biggest_index = max(v.numel() for k, v in sp.items()
                        if k.endswith("_indices"))
    with HostCopies() as mode:
        Scheduler(cfg, params, num_slots=1, max_len=8)
    assert mode.moved and max(mode.moved) <= biggest_index
    tile = sp["in_vals"][0, 0].numel()
    assert biggest_index < tile


def test_device_value_checks_agree_with_cpu(cuda, qwen_layer):
    """The value checks reduce on the card what they reduce on the CPU:
    the same findings for the same leaves, clean and corrupt, and for a
    block-sparse matrix with a dead live tile and a live padding tile."""
    from repro_torch.analysis import verify_block_sparse, verify_ffn_leaves
    cfg, params = qwen_layer
    sp = params["blocks"][0]["p0"]["ffn_sparse"]

    def found(diags):
        return {(d.rule, int(d.severity)) for d in diags}
    for leaves, want in ((sp, set()),
                         (_pad_tile_copy(sp), {("BS-PAD-VALS", 2)})):
        host = {k: v.cpu() for k, v in leaves.items()}
        assert found(verify_ffn_leaves(leaves, d_model=cfg.d_model)) == \
            found(verify_ffn_leaves(host, d_model=cfg.d_model)) == want
    dense = np.random.default_rng(3).normal(size=(256, 256)).astype(
        np.float32)
    dense[:128, :128] = 0                 # n-block 0 keeps one chunk of two
    w = block_sparsify(dense, 128, 128, device=cuda)
    idx = w.host_indices()
    assert (idx < 0).any()
    vals = w.vals.clone()
    vals[0, 0] = 0
    n, j = np.argwhere(idx < 0)[0]
    vals[n, j, 1, 1] = 1.0
    bad = dataclasses.replace(w, vals=vals)
    cpu = dataclasses.replace(w, indices=w.indices.cpu(), vals=vals.cpu())
    assert found(verify_block_sparse(bad)) == found(verify_block_sparse(cpu)) \
        == {("BS-MASK-VALS", 2), ("BS-PAD-VALS", 2)}


def test_corrupt_device_schedule_refused_before_launch(cuda):
    """A cached DeviceSchedule naming chunk K // bk (the walker would read
    past the weights) is refused by the engine before any launch; with
    the true copy back the forward is unchanged."""
    from repro_torch.analysis import AnalysisError
    model = build_vision_model("VGGNet", density=0.4, num_layers=2,
                               pattern="chunk", seed=0, device=cuda)
    x = torch.as_tensor(np.abs(np.random.default_rng(4).normal(
        size=(2, 16, 16, 3))).astype(np.float32), device=cuda)
    fwd = compile_forward(model)
    out = fwd(x)
    conv = model.layers[1].conv
    wl = next(iter(conv.wl_cache.values()))
    good = wl.on_device(x.device)
    bad = good.k.clone()
    bad[int(np.nonzero(wl.k >= 0)[0][0])] = \
        conv.packed.shape[0] // conv.packed.bk
    wl._device[str(x.device)] = dataclasses.replace(good, k=bad)
    before = WALK.launches
    with pytest.raises(AnalysisError, match="WL-STALE-CACHE"):
        VisionEngine(model, num_slots=2)
    assert WALK.launches == before
    wl._device[str(x.device)] = good
    VisionEngine(model, num_slots=2)
    assert torch.equal(fwd(x), out)


def test_smem_budget_matches_device(cuda):
    from repro_torch.analysis import SMEM_BUDGET_BYTES
    props = torch.cuda.get_device_properties(cuda)
    assert SMEM_BUDGET_BYTES == props.shared_memory_per_block_optin


def _limit_operands(dev, max_nz):
    """x [128, 144] and weights [144, 32] at bk = 16, bn = 32 whose one
    n-block lists ``max_nz`` slots (9 live): the CTA's live list sets the
    shared memory a launch asks for."""
    rng = np.random.default_rng(6)
    x = torch.as_tensor(np.abs(rng.normal(size=(128, 144))).astype(
        np.float32), device=dev)
    w = block_sparsify(rng.normal(size=(144, 32)).astype(np.float32), 16,
                       32, pad_to=max_nz, device=dev)
    return x, w


def _limits():
    """(walker tile mode, dense-grid conv): the longest chunk list the host
    models fit under SMEM_BUDGET_BYTES with 1 KB to spare for static shared
    memory, and the shortest they put over it."""
    from repro_torch.analysis import SMEM_BUDGET_BYTES
    from repro_torch.kernels.grid import (grid_smem_bytes, tile_smem_bytes,
                                          walk_tiles)
    from repro_torch.kernels.sparse_conv import CONV_COL_GROUP
    tiles = walk_tiles(128, 1, bm=128, bn=32, depth=9.0)
    models = {"walker": lambda n: tile_smem_bytes(tiles, 4, n),
              "grid": lambda n: grid_smem_bytes(4, CONV_COL_GROUP, 16, n)}
    out = {}
    for name, need in models.items():
        n = 1
        while need(n + 1) <= SMEM_BUDGET_BYTES - 1024:
            n += 1
        over = n + 1
        while need(over) <= SMEM_BUDGET_BYTES:
            over += 1
        out[name] = (n, over)
    return out


OVER_LIMIT = r"""
import sys
import torch
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
from test_torch_gpu import _limit_operands, _limits
from repro_torch.kernels.sparse_conv import sparse_conv_spmm
from repro_torch.kernels.worklist_core import build_worklist, worklist_spmm
dev = torch.device("cuda")
lim = _limits()
x, w = _limit_operands(dev, lim["walker"][1])
try:
    worklist_spmm(x, w.vals, build_worklist(w.host_indices(), 1), bk=16,
                  bn=32)
    print("walker launched")
except RuntimeError:
    print("walker refused")
x, w = _limit_operands(dev, lim["grid"][1])
try:
    sparse_conv_spmm(x, w.indices, w.vals, bk=16, bn=32)
    print("grid launched")
except RuntimeError:
    print("grid refused")
"""


def test_smem_models_hold_at_the_limit(cuda):
    """PC-VMEM's host models of a launch's shared memory: at the longest
    chunk list they fit under the budget the walker's tile mode and the
    dense-grid conv launch and match their plain versions; one they put
    over it is refused by the launch (in a subprocess, whose failed
    attribute call cannot leave an error for a later launch here)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    lim = _limits()
    x, w = _limit_operands(cuda, lim["walker"][0])
    wl = build_worklist(w.host_indices(), 1)
    out = worklist_spmm(x, w.vals, wl, bk=16, bn=32)[0]
    ref = worklist_spmm(x.cpu(), w.vals.cpu(), wl, bk=16, bn=32)[0]
    assert float((out.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-5
    x, w = _limit_operands(cuda, lim["grid"][0])
    out = sparse_conv_spmm(x, w.indices, w.vals, bk=16, bn=32)[0]
    ref = sparse_conv_spmm(x.cpu(), w.indices.cpu(), w.vals.cpu(), bk=16,
                           bn=32)[0]
    assert float((out.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-5
    tests = Path(__file__).resolve().parent
    src = str(tests.parent / "src")
    env = dict(os.environ, PYTHONPATH=src)
    run = subprocess.run(
        [sys.executable, "-c", OVER_LIMIT.format(src=src, tests=str(tests))],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split("\n")[:2] == ["walker refused", "grid refused"]


# ---------------------------------------------------------------------------
# the remaining LM families on the card
# ---------------------------------------------------------------------------
def test_moe_ffn_on_card_equals_cpu_and_is_stable(cuda):
    """fp32 MoE with drops (capacity 0.5) on the card against the CPU on
    the same weights, and bitwise equal across two runs: the dispatch
    writes each kept slot once and the combine sums k = 0 .. K-1 in order,
    no atomic scatter-add."""
    from repro_torch.models import layers as L
    cfg = load_smoke("moonshot_v1_16b_a3b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    gen = torch.Generator().manual_seed(0)
    p = L.init_moe(gen, cfg, torch.float32)
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    perm = torch.randperm(cfg.moe.num_experts, generator=gen).int()
    ref, raux = L.moe_ffn(p, x, cfg, perm)
    pc = {k: v.to(cuda) for k, v in p.items()}
    a, aux = L.moe_ffn(pc, x.to(cuda), cfg, perm.to(cuda))
    b, _ = L.moe_ffn(pc, x.to(cuda), cfg, perm.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert float((a.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert abs(float(aux) - float(raux)) <= 1e-5 * float(raux)


@pytest.mark.parametrize("window", [None, 24])
def test_flash_sdpa_on_card_equals_dense(cuda, window):
    from repro_torch.models import layers as L
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 100, 8, 64), generator=gen, device=cuda)
    k, v = (torch.randn((2, 100, 2, 64), generator=gen, device=cuda)
            for _ in range(2))
    torch.backends.cuda.matmul.allow_tf32 = False
    flash = L._flash_sdpa(q, k, v, 4, window=window, kv_chunk=32)
    dense = L._sdpa(q, k, v, L.causal_mask(100, 100, window, device=cuda), 4)
    torch.cuda.synchronize()
    assert float((flash - dense).abs().max() / dense.abs().max()) <= 1e-5


def test_sparse_seamless_generate_on_card_equals_cpu(cuda):
    """The sparse encoder-decoder (smoke, widened so its FFNs have several
    chunks) on the card: its encoder leaves pass ``strict=True``, and
    ``generate``'s greedy tokens equal the CPU's on the same weights (K3 and
    K4 at the encoder's and the decoder's FFNs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(load_smoke("seamless_m4t_medium"), d_model=256,
                              d_ff=512)
    params = sparsify_model(M.init_params(cfg, seed=0, device="cpu"), cfg,
                            num_shards=4)
    card = sparsify_model(M.init_params(cfg, seed=0, device="cpu"), cfg,
                          num_shards=4, strict=True)
    card = M.map_tree(lambda t: t.to(cuda), card)
    gen = torch.Generator().manual_seed(1)
    src = 0.02 * torch.randn((2, 8, cfg.d_model), generator=gen)
    prompt = torch.randint(1, cfg.vocab, (2, 6), generator=gen)
    want = generate(params, cfg, prompt, 6, src_embeds=src)
    k3, k4 = BITMASK_SPMM.launches, FUSED_FFN.launches
    got = generate(card, cfg, prompt.to(cuda), 6, src_embeds=src.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    layers = cfg.n_layers + cfg.encoder_layers
    assert BITMASK_SPMM.launches - k3 >= layers
    assert FUSED_FFN.launches - k4 >= layers


# ---------------------------------------------------------------------------
# CUDA graphs of the serving paths (repro_torch.graphs): the captured decode
# step and whole-net forward replayed on the card, bitwise equal to eager
# ---------------------------------------------------------------------------
def _graph_lm(cuda, arch):
    """A smoke LM on the card: Qwen3 and SeamlessM4T widened (d_model 256)
    and packed sparse, RWKV6 packed at its smoke width, Moonlight and
    Jamba dense (MoE, Mamba); fp32."""
    cfg = load_smoke(arch)
    if arch in ("qwen3_4b", "seamless_m4t_medium"):
        cfg = dataclasses.replace(cfg, sparse_ffn=True, d_model=256,
                                  d_ff=512)
    params = M.init_params(cfg, seed=0, device="cpu")
    if cfg.sparse_ffn:
        params = sparsify_model(params, cfg, num_shards=4, strict=True)
    return cfg, M.map_tree(lambda t: t.to(cuda), params)


@pytest.mark.parametrize("arch", ["qwen3_4b", "rwkv6_3b",
                                  "moonshot_v1_16b_a3b",
                                  "jamba_1_5_large_398b",
                                  "seamless_m4t_medium"])
def test_graphed_step_bitwise_eager_on_card(cuda, arch):
    """Five decode steps from one prefilled cache: the replayed graph's
    logits, tokens and cache bitwise equal to the eager ``decode_step``'s;
    one graph, its K3/K4 tally one launch a sparse layer."""
    from repro_torch.serve import GraphedServeStep
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _graph_lm(cuda, arch)
    B, S, steps = 3, 7, 5
    gen = torch.Generator(device=cuda).manual_seed(2)
    toks = torch.randint(1, cfg.vocab, (B, S), generator=gen, device=cuda)
    enc = 6 if cfg.encoder_layers else 0
    cache = M.init_cache(cfg, B, S + steps + 1, enc_len=enc, device=cuda)
    if enc:
        src = 0.02 * torch.randn((B, enc, cfg.d_model), generator=gen,
                                 device=cuda)
        cache = M.prefill_cache(params, cfg, cache,
                                M.encode(params, src, cfg))
    last, cache = M.prefill(params, cfg, toks, cache)
    eager = M.map_tree(torch.clone, cache)
    step = GraphedServeStep(cfg)
    tok = torch.argmax(last, -1)[:, None]
    for i in range(steps):
        pos = torch.full((B,), S + i, dtype=torch.long, device=cuda)
        el, eager = M.decode_step(params, cfg, tok, eager, pos)
        nxt, cache = step(params, cache, tok, pos)
        torch.cuda.synchronize()
        assert torch.equal(step.last_logits, el[:, 0]), i
        assert torch.equal(nxt, torch.argmax(el[:, 0], -1)[:, None]), i
        assert all(torch.equal(a, b) for a, b in
                   zip(_tensors(cache), _tensors(eager))), i
        tok = nxt
    g, = step.graphs.values()
    assert g.replays == steps - 1
    sparse = cfg.n_layers if cfg.sparse_ffn else 0
    assert g.tally.get(BITMASK_SPMM, 0) == sparse
    assert g.tally.get(FUSED_FFN, 0) == sparse


def _tensors(tree):
    from repro_torch.graphs import leaves
    return leaves(tree)


def test_graphed_scheduler_bitwise_eager_on_card(cuda):
    """``Scheduler`` (sparse Qwen3 smoke, 4 slots, staggered requests) on
    its replayed step: tokens, the final cache and the K3/K4 launch counts
    equal to ``compiled=False``'s; the counts are eager launches + replays
    x the graph's tally."""
    cfg, params = _graph_lm(cuda, "qwen3_4b")
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (6, 9))
    runs = {}
    for compiled in (False, True):
        BITMASK_SPMM.launches = FUSED_FFN.launches = 0
        sch = Scheduler(cfg, params, num_slots=4, max_len=24,
                        compiled=compiled)
        out = sch.run([Request(i, prompts[i], 7, arrival=i) for i in
                       range(6)])
        torch.cuda.synchronize()
        runs[compiled] = (out, BITMASK_SPMM.launches, FUSED_FFN.launches,
                          sch)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1:3] == runs[False][1:3]
    sch = runs[True][3]
    assert all(torch.equal(a, b) for a, b in
               zip(_tensors(sch.cache), _tensors(runs[False][3].cache)))
    g, = sch._step_fn.graphs.values()
    assert g.tally == {BITMASK_SPMM: cfg.n_layers, FUSED_FFN: cfg.n_layers}
    assert g.replays == sch.stats.engine_steps - 1
    prefills = sch.stats.prefills
    assert runs[True][1] == cfg.n_layers * (prefills +
                                            sch.stats.engine_steps)


def test_graphed_generate_new_batch_width_new_graph(cuda):
    """A held ``GraphedServeStep`` handed to ``generate`` replays one graph
    per batch width, tokens bitwise equal to ``compiled=False``."""
    from repro_torch.serve import GraphedServeStep
    cfg, params = _graph_lm(cuda, "qwen3_4b")
    gen = torch.Generator(device=cuda).manual_seed(3)
    toks = torch.randint(1, cfg.vocab, (4, 5), generator=gen, device=cuda)
    step = GraphedServeStep(cfg)
    for B in (2, 4, 2):
        got = generate(params, cfg, toks[:B], 6, step=step)
        assert torch.equal(got, generate(params, cfg, toks[:B], 6,
                                         compiled=False))
    assert len(step.graphs) == 2
    assert sorted(g.replays for g in step.graphs.values()) == [4, 9]


def test_graphed_step_recaptures_a_rebound_params_leaf(cuda):
    """Rebinding ``params["expert_perm"]`` (Moonlight smoke, MoE) makes the
    held step capture a new graph that reads the new leaf: its tokens
    follow the eager step on the new params, not the old graph's baked
    pointer, and rebinding back replays the first graph."""
    from repro_torch.serve import GraphedServeStep
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _graph_lm(cuda, "moonshot_v1_16b_a3b")
    gen = torch.Generator(device=cuda).manual_seed(4)
    toks = torch.randint(1, cfg.vocab, (2, 5), generator=gen, device=cuda)
    step = GraphedServeStep(cfg)
    perms = (params["expert_perm"], params["expert_perm"].flip(0))
    outs = []
    for perm in perms + perms:
        params["expert_perm"] = perm
        got = generate(params, cfg, toks, 6, step=step)
        want = generate(params, cfg, toks, 6, compiled=False)
        assert torch.equal(got, want)
        outs.append(got)
    assert len(step.graphs) == 2
    # per graph: 4 replays after its warm-up and capture, then 5
    assert all(g.replays == 9 for g in step.graphs.values())
    assert not torch.equal(outs[0], outs[1])


def test_graphed_vgg_head_forward_bitwise_on_card(cuda):
    """The captured forward of a 4-layer VGG head (chunk pattern, 2 images
    at 32 px): every replay, from a card or a host batch, bitwise equal to
    the eager forward; the graph's input buffer its own (the first call's
    batch is not overwritten by a later one); the walker's launches exact
    (one a layer and forward); ``VisionEngine`` graphed == eager."""
    from repro_torch.vision import graphed_forward
    from repro_torch.launch.vision import blob_images
    model = build_vision_model("VGGNet", pattern="chunk", num_layers=4,
                               seed=0, device=cuda)
    imgs = blob_images(np.random.default_rng(0), 4, 32, 0.45)
    x = torch.as_tensor(imgs[:2], device=cuda)
    eager = compile_forward(model)(x)
    fwd = graphed_forward(model)
    WALK.launches = 0
    outs = [fwd(x) for _ in range(3)] + [fwd(torch.as_tensor(imgs[2:]))]
    torch.cuda.synchronize()
    assert torch.equal(x, torch.as_tensor(imgs[:2], device=cuda))  # own
    assert WALK.launches == 4 * model.num_layers
    assert all(torch.equal(o, eager) for o in outs[:3])
    assert torch.equal(outs[3], compile_forward(model)(
        torch.as_tensor(imgs[2:], device=cuda)))
    reqs = [ImageRequest(rid=i, image=imgs[i], arrival=i // 3)
            for i in range(4)]
    got = VisionEngine(model, num_slots=2).run(reqs)
    want = VisionEngine(model, num_slots=2, compiled=False).run(reqs)
    assert all(np.array_equal(got[i], want[i]) for i in range(4))


def test_graph_spans_on_card(cuda, monkeypatch):
    """The captured forward's first call opens one ``graph.capture`` span
    and each replay a ``graph.copy_in`` and a ``graph.replay``; an engine
    step its phases. The capture runs with no profiler, its span counted
    through a stand-in that records each name: on the card a capture under
    a recording ``torch.profiler`` can be invalidated after earlier card
    work, spans or none. On the card's timeline a span is only a user
    annotation (which the benchmark's trace drops), never a kernel or a
    copy; the outputs are the unprofiled ones."""
    import repro_torch.graphs as G
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.vision import blob_images
    from repro_torch.vision import graphed_forward
    model = build_vision_model("VGGNet", pattern="chunk", num_layers=2,
                               seed=0, device=cuda)
    imgs = blob_images(np.random.default_rng(1), 4, 32, 0.45)
    x = torch.as_tensor(imgs[:2])
    eager = compile_forward(model)(x.to(cuda))
    fwd = graphed_forward(model)
    opened, span = [], G.span

    def recording(name):
        opened.append(name)
        return span(name)
    monkeypatch.setattr(G, "span", recording)
    first = fwd(x)
    assert opened == ["graph.capture"]
    monkeypatch.setattr(G, "span", span)

    def spans(prof):
        return [e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() != torch.autograd.DeviceType.CUDA
                and e.name().startswith(("graph.", "engine."))]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs = [fwd(x) for _ in range(3)]
        eng = VisionEngine(model, num_slots=2)
        got = eng.run([ImageRequest(i, imgs[i]) for i in range(4)])
        torch.cuda.synchronize()
    names = spans(prof)
    assert "graph.capture" not in names
    # three replays, then the engine's warm-up and its two steps
    assert names.count("graph.copy_in") == names.count("graph.replay") == 6
    assert names.count("engine.copy_out") == 2
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert any(e.name().startswith("Memcpy HtoD") for e in device)
    assert not [e.name() for e in device if not e.is_user_annotation()
                and e.name().startswith(("graph.", "engine.", "conv."))]
    assert all(torch.equal(o, eager) for o in [first] + outs)
    for i in range(4):
        one = compile_forward(model)(torch.as_tensor(imgs[i:i + 1],
                                                     device=cuda))
        np.testing.assert_array_equal(got[i], one[0].cpu().numpy())


def test_chip_smoke_kernel_trace_leaves_out_program_spans(cuda):
    """``chip_smoke.trace_kernels`` of a graphed forward and of engine
    steps lists the card's kernels and copies and no program span: the
    ``graph.*`` and ``engine.*`` user annotations on the card's row would
    count a replay's whole range as busy time."""
    import importlib.util
    from pathlib import Path
    from repro_torch.launch.vision import blob_images
    from repro_torch.vision import graphed_forward
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model = build_vision_model("VGGNet", pattern="chunk", num_layers=2,
                               seed=0, device=cuda)
    imgs = blob_images(np.random.default_rng(2), 4, 32, 0.45)
    x = torch.as_tensor(imgs[:2])
    fwd = graphed_forward(model)
    fwd(x)                                 # the capture
    eng = VisionEngine(model, num_slots=2)
    for i in range(4):
        eng.submit(ImageRequest(i, imgs[i]))
    spans = ("graph.", "engine.", "conv.", "server.")
    for fn in (lambda: fwd(x), eng.step):  # a replay; then two steps
        names = [n for n, _ in smoke.trace_kernels(fn)]
        assert any("tile_kernel" in n for n in names)
        assert any(n.startswith("Memcpy HtoD") for n in names)
        assert not [n for n in names if n.startswith(spans)]


def test_capture_refuses_host_schedules_and_host_reads(cuda):
    """A body that builds a host schedule under capture (the compact FFN
    schedule with activation occupancy) or reads a tensor to the host
    raises ``GraphCaptureError`` naming the graph, at the capture and at
    every later call; nothing runs eagerly in its place. A kernel launched
    on a capturing stream with no tally open raises."""
    from repro_torch.graphs import CapturedGraph, GraphCaptureError
    cfg, params = _graph_lm(cuda, "qwen3_4b")
    sp = params["blocks"][0]["p0"]["ffn_sparse"]
    x = torch.randn((4, cfg.d_model), device=cuda)
    g = CapturedGraph(lambda t: sparse_ffn_apply(
        sp, t, cfg.act, schedule="compact", compact_activations=True),
        cuda, "compact FFN")
    for _ in range(2):                   # the failed capture, then again
        with pytest.raises(GraphCaptureError, match="compact FFN"):
            g(x)
    assert g.graph is None
    h = CapturedGraph(lambda t: t * float(t.sum().item()), cuda, "host read")
    with pytest.raises(GraphCaptureError, match="host read"):
        h(x)
    # a kernel launch captured outside CapturedGraph (no tally) raises
    # rather than go uncounted
    dense = sparse_ffn_apply(sp, x, cfg.act)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture_tally"):
        with torch.cuda.graph(graph):
            sparse_ffn_apply(sp, x, cfg.act)
    torch.cuda.synchronize()
    assert torch.equal(x * 2, x + x)           # the card still works
    assert torch.equal(sparse_ffn_apply(sp, x, cfg.act), dense)


# ---------------------------------------------------------------------------
# training (phase 20 of chip_smoke.py at smoke size)
# ---------------------------------------------------------------------------
def _train_setup(cuda, arch, dtype):
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import batch_for
    cfg = dataclasses.replace(load_smoke(arch), dtype=dtype)
    params = M.init_params(cfg, seed=0, device=cuda)
    batch = batch_for(cfg, ShapeConfig("t", 64, 4, "train"), 0, device=cuda)
    return cfg, params, batch


def test_train_step_on_card_matches_fp64(cuda):
    """The fp32 step on the card (TF32 off) against the same step in fp64
    on the card: loss, grad norm and every gradient within 1e-5; the params
    after AdamW within 1e-5 plus ``lr * (gradient error) / eps`` (AdamW's
    step-1 update ``g / (|g| + eps)``), and AdamW's own arithmetic on
    shared gradients within 1e-5."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import (loss_and_grads,
                                              make_train_step, promote_fp64)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, batch = _train_setup(cuda, "qwen3_4b", "float32")
    c64 = dataclasses.replace(cfg, dtype="float64")
    p64 = M.map_tree(torch.Tensor.double, params)
    opt_cfg = adamw.AdamWConfig(warmup_steps=0)
    l32, _, g32 = loss_and_grads(params, batch, cfg)
    n32, _, m32 = make_train_step(cfg, opt_cfg)(params, adamw.init(params),
                                                batch)
    with promote_fp64():
        l64, _, g64 = loss_and_grads(p64, batch, c64, remat=False)
        n64, _, m64 = adamw.apply(opt_cfg, p64, g64, adamw.init(p64))
        q64 = adamw.apply(opt_cfg, p64, M.map_tree(
            lambda g: g.float().double(), g64), adamw.init(p64))[0]
    q32 = adamw.apply(opt_cfg, params, M.map_tree(torch.Tensor.float, g64),
                      adamw.init(params))[0]

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())
    assert rel(l32, l64) <= 1e-5
    assert rel(m32["grad_norm"], m64["grad_norm"]) <= 1e-5
    fg32, fg64 = M.flatten_tree(g32), M.flatten_tree(g64)
    assert all(rel(fg32[k], fg64[k]) <= 1e-5 for k in fg64)
    assert all(rel(a, b) <= 1e-5 for a, b in zip(
        M.flatten_tree(q32).values(), M.flatten_tree(q64).values()))
    lr = float(m64["lr"])
    for (k, a), b in zip(M.flatten_tree(n32).items(),
                         M.flatten_tree(n64).values()):
        assert b.dtype == torch.float64
        g_err = float((fg32[k].double() - fg64[k]).abs().max())
        allow = 1e-5 * float(b.abs().max()) + lr * g_err / opt_cfg.eps
        assert float((a.double() - b).abs().max()) <= allow, k


@pytest.mark.parametrize("arch", ["qwen3_4b", "moonshot_v1_16b_a3b"])
def test_train_step_deterministic_on_card(cuda, arch):
    """One bf16 step twice from one state: params, moments and metrics bit
    for bit equal (the embedding gather's backward and the MoE's dispatch
    on the card included), and no FFN kernel launched by training."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    cfg, params, batch = _train_setup(cuda, arch, "bfloat16")
    step = make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0))
    before = (BITMASK_SPMM.launches, FUSED_FFN.launches)
    runs = [step(params, adamw.init(params), batch) for _ in range(2)]
    torch.cuda.synchronize()
    fa, fb = M.flatten_tree(runs[0]), M.flatten_tree(runs[1])
    for k in fa:
        a, b = fa[k], fb[k]
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), k
    assert (BITMASK_SPMM.launches, FUSED_FFN.launches) == before


def test_train_loop_restart_and_restore_on_card(cuda, tmp_path):
    """The loop on the card: 4 steps with a checkpoint every 2, resumed to
    6, bitwise equal to 6 in one run; the restored params on the card."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import ShapeConfig
    from repro_torch.train.loop import TrainLoopConfig, train
    cfg = dataclasses.replace(load_smoke("qwen3_4b"), dtype="bfloat16")
    shape = ShapeConfig("t", 32, 4, "train")
    lc = TrainLoopConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                         log_every=100)
    train(cfg, shape, lc, device=cuda)
    st = train(cfg, shape, dataclasses.replace(lc, steps=6), device=cuda)
    one = train(cfg, shape, TrainLoopConfig(steps=6, log_every=100),
                device=cuda)
    assert st.step == 6 and int(st.opt.step) == 6
    assert st.params["embed"].device.type == "cuda"
    for a, b in zip(M.flatten_tree((st.params, st.opt)).values(),
                    M.flatten_tree((one.params, one.opt)).values()):
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)
    p, _, _ = ckpt.restore(str(tmp_path), 6, M.abstract_params(cfg),
                           device=cuda)
    assert torch.equal(p["embed"].view(torch.int16),
                       st.params["embed"].view(torch.int16))


# ---------------------------------------------------------------------------
# the remaining compiled paths: the captured train step, prefill and
# admission, the sampled decode step and the FFN probe
# ---------------------------------------------------------------------------
def _bitwise_trees(a, b) -> bool:
    fa, fb = M.flatten_tree(a), M.flatten_tree(b)
    if list(fa) != list(fb):
        return False
    for k in fa:
        x, y = fa[k], fb[k]
        if x.dtype != y.dtype:
            return False
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not torch.equal(x, y):
            return False
    return True


@pytest.mark.parametrize("arch,microbatches", [
    ("qwen3_4b", 1), ("qwen3_4b", 2), ("moonshot_v1_16b_a3b", 1)])
def test_graphed_train_step_bitwise_eager_on_card(cuda, arch, microbatches):
    """bf16, 4 steps from one state: the captured step (eager warm-up,
    capture, 3 replays) bitwise equal to the eager donated step (params,
    moments, counter, metrics), the state's tensors kept; a restored state
    (other tensors) copied into the buffers, no new graph; no FFN kernel
    launched."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import batch_for
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import GraphedTrainStep, \
        make_train_step
    cfg, params, _ = _train_setup(cuda, arch, "bfloat16")
    shape = ShapeConfig("t", 64, 4, "train")
    batches = [batch_for(cfg, shape, i, device=cuda) for i in range(5)]
    opt_cfg = adamw.AdamWConfig(warmup_steps=2)
    eager = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                            donate=True)
    graphed = GraphedTrainStep(cfg, opt_cfg, microbatches=microbatches)
    ep = M.map_tree(torch.clone, params)
    eo = adamw.init(ep)
    gp = M.map_tree(torch.clone, params)
    go = adamw.init(gp)
    ptrs = [t.data_ptr() for t in M.flatten_tree((gp, go)).values()]
    before = (BITMASK_SPMM.launches, FUSED_FFN.launches)
    for i in range(4):
        ep, eo, em = eager(ep, eo, batches[i])
        gp, go, gm = graphed(gp, go, batches[i])
        torch.cuda.synchronize()
        assert _bitwise_trees((gp, go, gm), (ep, eo, em)), i
    g, = graphed.graphs.values()
    assert g.replays == 3 and g.pool_bytes > 0
    assert [t.data_ptr() for t in M.flatten_tree((gp, go)).values()] == ptrs
    # a restored state: other tensors of the same geometry, copied in
    rp, ro = M.map_tree(torch.clone, ep), adamw.OptState(
        eo.step.clone(), M.map_tree(torch.clone, eo.mu),
        M.map_tree(torch.clone, eo.nu))
    ep, eo, em = eager(ep, eo, batches[4])
    gp, go, gm = graphed(rp, ro, batches[4])
    torch.cuda.synchronize()
    assert _bitwise_trees((gp, go, gm), (ep, eo, em))
    assert len(graphed.graphs) == 1 and g.replays == 4
    assert (BITMASK_SPMM.launches, FUSED_FFN.launches) == before


def test_graphed_pruned_steps_and_compiled_loop_on_card(cuda, tmp_path):
    """The captured fixed-mask steps bitwise the eager ``apply_masks``
    steps, every pruned weight exactly 0, the params the graph's buffers
    throughout; ``train`` compiled (the default) bitwise ``compiled=False``
    and its resume bitwise the uninterrupted run."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import batch_for
    from repro_torch.optim import adamw
    from repro_torch.sparsity import pruning
    from repro_torch.train.loop import TrainLoopConfig, train
    from repro_torch.train.train_step import GraphedTrainStep, \
        make_train_step
    cfg, params, _ = _train_setup(cuda, "qwen3_4b", "bfloat16")
    shape = ShapeConfig("t", 64, 4, "train")
    masks = pruning.prune_masks(params, pruning.PruneConfig(
        density=0.5, min_size=512))
    start = pruning.apply_masks(params, masks)
    opt_cfg = adamw.AdamWConfig(warmup_steps=0)
    eager = pruning.make_pruned_train_step(make_train_step(cfg, opt_cfg),
                                           masks)
    graphed = pruning.make_pruned_train_step(GraphedTrainStep(cfg, opt_cfg),
                                             masks)
    ep, eo = start, adamw.init(start)
    gp = M.map_tree(torch.clone, start)
    go = adamw.init(gp)
    ptrs = [t.data_ptr() for t in M.flatten_tree(gp).values()]
    for i in range(4):
        b = batch_for(cfg, shape, i, device=cuda)
        ep, eo, em = eager(ep, eo, b)
        gp, go, gm = graphed(gp, go, b)
        torch.cuda.synchronize()
        assert _bitwise_trees((gp, go, gm), (ep, eo, em)), i
    assert [t.data_ptr() for t in M.flatten_tree(gp).values()] == ptrs
    assert list(graphed.graphs.values())[0].replays == 3
    M.map_tree(lambda p, m: None if m is None else
               _assert(bool((p[m == 0] == 0).all())), gp, masks)
    lc = TrainLoopConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                         log_every=100)
    train(cfg, ShapeConfig("t", 32, 4, "train"), lc, device=cuda)
    resumed = train(cfg, ShapeConfig("t", 32, 4, "train"),
                    dataclasses.replace(lc, steps=6), device=cuda)
    runs = [train(cfg, ShapeConfig("t", 32, 4, "train"),
                  TrainLoopConfig(steps=6, log_every=100), device=cuda,
                  compiled=c) for c in (True, False)]
    assert _bitwise_trees((resumed.params, resumed.opt),
                          (runs[0].params, runs[0].opt))
    assert _bitwise_trees((runs[0].params, runs[0].opt),
                          (runs[1].params, runs[1].opt))


def _assert(cond: bool) -> None:
    assert cond


def test_graphed_admission_and_prefill_bitwise_eager_on_card(cuda):
    """``GraphedAdmit`` (slot a device tensor, one graph per prompt
    length) over 6 admissions into a dirty cache: first tokens and the
    cache bitwise ``prefill_lane`` + ``write_lane``'s, the cache written in
    place; ``GraphedPrefill`` replays bitwise ``prefill`` into the
    caller's cache; K3/K4 counts exact (warm-ups + replays x tallies)."""
    from repro_torch.serve import GraphedAdmit, GraphedPrefill
    from repro_torch.serve.engine import prefill_lane, write_lane
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _graph_lm(cuda, "qwen3_4b")
    gen = torch.Generator(device=cuda).manual_seed(4)
    cache = M.map_tree(lambda t: torch.randn(t.shape, generator=gen,
                                             device=cuda).to(t.dtype),
                       M.init_cache(cfg, 4, 16, device=cuda))
    want = M.map_tree(torch.clone, cache)
    before = _tensors(cache)
    admit = GraphedAdmit(cfg, 16)
    rng = np.random.default_rng(1)
    BITMASK_SPMM.launches = FUSED_FFN.launches = 0
    for i, (slot, S) in enumerate(((1, 7), (3, 7), (0, 5), (2, 7), (1, 5),
                                   (0, 7))):
        prompt = rng.integers(1, cfg.vocab, S)
        first, cache = admit(params, cache, prompt,
                             torch.tensor(slot, device=cuda))
        tok, lane = prefill_lane(params, cfg, 16,
                                 torch.as_tensor(prompt, device=cuda)[None])
        write_lane(want, lane, slot)
        torch.cuda.synchronize()
        assert torch.equal(first, tok), i
        assert all(torch.equal(a, b) for a, b in
                   zip(_tensors(cache), _tensors(want))), i
    assert all(a is b for a, b in zip(_tensors(cache), before))
    assert sorted(g.replays for g in admit.graphs.values()) == [1, 3]
    # 6 graphed + 6 eager admissions: 2 warm-ups and 4 replays graphed
    n = cfg.n_layers
    assert BITMASK_SPMM.launches == FUSED_FFN.launches == 12 * n
    assert all(g.tally == {BITMASK_SPMM: n, FUSED_FFN: n}
               for g in admit.graphs.values())
    pre = GraphedPrefill(cfg)
    toks = torch.randint(1, cfg.vocab, (3, 6), generator=gen, device=cuda)
    for _ in range(3):
        mine = M.init_cache(cfg, 3, 12, device=cuda)
        last, got = pre(params, toks, mine)
        wl, wc = M.prefill(params, cfg, toks, M.init_cache(cfg, 3, 12,
                                                           device=cuda))
        torch.cuda.synchronize()
        assert torch.equal(last, wl)
        assert all(torch.equal(a, b) for a, b in
                   zip(_tensors(got), _tensors(wc)))
        assert all(a is b for a, b in zip(_tensors(got), _tensors(mine)))
    g, = pre.graphs.values()
    assert g.replays == 2


def test_graphed_scheduler_admits_and_probes_through_graphs_on_card(cuda):
    """``Scheduler`` (compiled, the default) admits through ``GraphedAdmit``
    and probes through ``GraphedFfnStats``: tokens, probe and cache equal
    to ``compiled=False``'s, the admissions replayed, the K3/K4 launches
    exact: one eager call per graph plus its replays x its tally."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _graph_lm(cuda, "qwen3_4b")
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (6, 9))
    runs = {}
    for compiled in (False, True):
        BITMASK_SPMM.launches = FUSED_FFN.launches = 0
        sch = Scheduler(cfg, params, num_slots=4, max_len=24,
                        compiled=compiled)
        out = sch.run([Request(i, prompts[i], 7, arrival=i) for i in
                       range(6)], probe_ffn=True)
        torch.cuda.synchronize()
        runs[compiled] = (out, BITMASK_SPMM.launches, FUSED_FFN.launches,
                          sch)
    sch, eager = runs[True][3], runs[False][3]
    assert runs[True][:3] == runs[False][:3]
    assert sch.ffn_probe == eager.ffn_probe
    a, = sch._admit_fn.graphs.values()
    assert a.replays == 5
    graphs = sch.captured_graphs()
    assert len(graphs) == 3
    n = cfg.n_layers
    assert runs[True][1] == sum(n + g.replays * g.tally[BITMASK_SPMM]
                                for g in graphs)


def test_sampled_graphed_step_bitwise_eager_on_card(cuda):
    """The sampled decode step replayed (a CUDA generator registered with
    its graph): 6 steps' tokens and caches bitwise the eager step's on the
    same seed, the generators' offsets equal after; ``generate(rng=...)``
    compiled bitwise eager."""
    from repro_torch.serve import GraphedServeStep, make_serve_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _graph_lm(cuda, "qwen3_4b")
    B, S = 3, 6
    g0 = torch.Generator(device=cuda).manual_seed(5)
    toks = torch.randint(1, cfg.vocab, (B, S), generator=g0, device=cuda)
    last, cache = M.prefill(params, cfg, toks,
                            M.init_cache(cfg, B, 16, device=cuda))
    eg, gg = (torch.Generator(device=cuda).manual_seed(9) for _ in range(2))
    step = GraphedServeStep(cfg, greedy=False)
    eager = make_serve_step(cfg, greedy=False)
    ec, gc = M.map_tree(torch.clone, cache), M.map_tree(torch.clone, cache)
    et = gt = torch.argmax(last, -1)[:, None]
    for i in range(6):
        pos = torch.full((B,), S + i, dtype=torch.long, device=cuda)
        et, ec = eager(params, ec, et, pos, None, eg)
        gt, gc = step(params, gc, gt, pos, None, gg)
        torch.cuda.synchronize()
        assert torch.equal(gt, et), i
        assert all(torch.equal(a, b) for a, b in
                   zip(_tensors(gc), _tensors(ec))), i
    g, = step.graphs.values()
    assert g.replays == 5
    assert torch.equal(eg.get_state(), gg.get_state())
    a, b = (torch.Generator(device=cuda).manual_seed(1) for _ in range(2))
    got = generate(params, cfg, toks, 8, greedy=False, rng=a)
    want = generate(params, cfg, toks, 8, greedy=False, rng=b,
                    compiled=False)
    assert torch.equal(got, want)


def test_seeded_host_read_in_a_body_raises(cuda):
    """A body that draws a seeded number and reads it to the host raises
    ``GraphCaptureError`` naming the graph, at the capture and again; the
    warm-up ran once, eagerly, and nothing runs in the graph's place."""
    from repro_torch.graphs import CapturedGraph, GraphCaptureError
    gen = torch.Generator(device=cuda).manual_seed(0)
    calls = []

    def body(t):
        calls.append(1)
        r = torch.rand((), generator=gen, device=cuda)
        return t * float(r)
    g = CapturedGraph(body, cuda, "seeded read", generator=gen)
    with pytest.raises(GraphCaptureError, match="seeded read"):
        g(torch.ones(3, device=cuda))
    with pytest.raises(GraphCaptureError, match="seeded read"):
        g(torch.ones(3, device=cuda))
    assert g.graph is None and len(calls) == 2     # warm-up, capture
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the mesh-sharded vision runtime
# ---------------------------------------------------------------------------
def test_cout_sharded_walks_bitwise_whole_list_on_card(rng, cuda):
    """Each device's walk of VGG16 layer 8 (cout 512, packed for 4
    clusters: one n-block each) through ``worklist_spmm_padded`` launches K1
    once over its local work list, and the four slabs and occupancies in
    ring order are K1 over the whole list, bitwise."""
    from repro_torch.kernels.worklist_core import worklist_spmm_padded
    model = build_vision_model("VGGNet", num_layers=9, pattern="chunk",
                               mesh_devices=4, device=cuda)
    w = model.layers[7].conv.packed
    assert list(w.shard_of) == [0, 1, 2, 3]
    x = np.abs(rng.normal(size=(4 * 128, w.shape[0]))).astype(np.float32)
    x[rng.random(x.shape) < 0.6] = 0
    x[:40] = 0
    flat = torch.as_tensor(x, device=cuda)
    wl = build_worklist(w.host_indices(), 4, mb_per_img=1,
                        shard_of=w.shard_of)
    kw = dict(bk=w.bk, bn=w.bn, bm_rows=128, sub_m=8, mb_per_img=1,
              ncolors=2, act="relu", emit_occupancy=True)
    whole, wocc = worklist_spmm(flat, w.vals, wl, **kw)
    before = WALK.launches
    slabs = [worklist_spmm_padded(flat, w.vals[d:d + 1], wl, d, 4, **kw)
             for d in range(4)]
    assert WALK.launches == before + 4
    assert torch.equal(torch.cat([s[0] for s in slabs], dim=1), whole)
    assert torch.equal(torch.cat([s[1] for s in slabs], dim=1), wocc)


def test_one_rank_nccl_mesh_bitwise_solo_on_card(rng, cuda):
    """``data_mesh(1)`` starts a one-rank NCCL world; the sharded forward
    (eager and replayed) and the mesh engine equal the solo forward
    bitwise."""
    import torch.distributed as dist
    from repro_torch.vision import graphed_forward
    from repro_torch.vision.mesh import data_mesh
    model = build_vision_model("VGGNet", num_layers=3, pattern="chunk",
                               mesh_devices=4, device=cuda)
    x = torch.as_tensor(np.abs(rng.normal(size=(4, 24, 24, 3))).astype(
        np.float32), device=cuda)
    solo = compile_forward(model)(x)
    started = not dist.is_initialized()
    mesh = data_mesh(1)
    try:
        assert dist.get_backend() == "nccl"
        assert torch.equal(compile_forward(model, mesh=mesh)(x), solo)
        g = graphed_forward(model, mesh=mesh)
        assert all(torch.equal(g(x), solo) for _ in range(3))
        reqs = [ImageRequest(rid=i, image=x[i].cpu().numpy())
                for i in range(4)]
        out = VisionEngine(model, num_slots=2, mesh=mesh).run(reqs)
        for i in range(4):
            np.testing.assert_array_equal(out[i], solo[i].cpu().numpy())
    finally:
        if started:
            dist.destroy_process_group()


def _nccl_ring_rank(rank, world, store, out_dir):
    """One rank of the two-rank NCCL ring test."""
    import datetime
    import os
    import torch.distributed as dist
    from repro_torch.kernels.worklist_core import (build_worklist as bw,
                                                   worklist_spmm as ws)
    from repro_torch.vision.mesh import (cout_sharded_spmm, data_mesh,
                                         device_mesh)
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        model = build_vision_model("VGGNet", num_layers=9, pattern="chunk",
                                   mesh_devices=world, device=dev)
        w = model.layers[7].conv.packed
        g = np.random.default_rng(0)
        x = torch.as_tensor(np.abs(g.normal(size=(256, w.shape[0]))).astype(
            np.float32), device=dev)
        wl = bw(w.host_indices(), 2, shard_of=w.shard_of)
        mesh = device_mesh((world,), ("model",), device=dev)
        full, occ = cout_sharded_spmm(x, w.vals, wl, mesh, bk=w.bk,
                                      bn=w.bn, bm_rows=128, occupancy=True)
        whole, wocc = ws(x, w.vals, wl, bk=w.bk, bn=w.bn, bm_rows=128,
                         sub_m=128, emit_occupancy=True)
        imgs = torch.as_tensor(np.abs(g.normal(size=(4, 24, 24, 3))).astype(
            np.float32), device=dev)
        sharded = compile_forward(model, mesh=data_mesh(world, device=dev))(
            imgs)
        ok = torch.equal(full, whole) and torch.equal(occ, wocc) and \
            torch.equal(sharded, compile_forward(model)(imgs))
        with open(os.path.join(out_dir, f"rank{rank}"), "w") as f:
            f.write("ok" if ok else "differs")
    finally:
        dist.destroy_process_group()


def test_two_rank_nccl_ring_on_cards(cuda, tmp_path):
    """Two ranks, one card each, over NCCL: the cout-sharded layer's ring
    (slabs and occupancy) and the data-parallel forward bitwise equal to
    one card's walk and forward."""
    if torch.cuda.device_count() < 2:
        pytest.skip("an NCCL ring of two ranks needs two CUDA devices; "
                    f"this machine has {torch.cuda.device_count()}")
    import torch.multiprocessing as mp
    mp.spawn(_nccl_ring_rank, args=(2, str(tmp_path / "store"),
                                    str(tmp_path)), nprocs=2, join=True)
    for rank in range(2):
        assert (tmp_path / f"rank{rank}").read_text() == "ok", rank


def _local(tree):
    """Each DTensor leaf's local tensor (plain leaves as they are)."""
    from torch.distributed.tensor import DTensor
    return M.map_tree(lambda t: t.to_local() if isinstance(t, DTensor)
                      else t, tree)


@pytest.mark.parametrize("arch", ["qwen3_4b", "moonshot_v1_16b_a3b"])
def test_one_rank_sharded_train_step_bitwise_solo_on_card(cuda, arch):
    """``make_debug_mesh(1, 1)`` (a one-rank NCCL world) with FSDP, bf16:
    one eager sharded step bitwise equal to the solo step (params,
    moments, counter, metrics), every leaf in its ``param_shardings``
    placements; the captured sharded step over 3 steps bitwise equal to
    the eager sharded donated step; no FFN kernel launched."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import batch_for
    from repro_torch.dist import partitioning as part
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import adamw
    from repro_torch.train.loop import shardings
    from repro_torch.train.train_step import GraphedTrainStep, \
        make_train_step
    cfg, params, _ = _train_setup(cuda, arch, "bfloat16")
    shape = ShapeConfig("t", 64, 4, "train")
    started = not dist.is_initialized()
    mesh = make_debug_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl"
        p_sh, _ = shardings(cfg, mesh, fsdp=True)
        place = part.NamedSharding.of(mesh, part.batch_spec(mesh))
        batches = [batch_for(cfg, shape, i, device=cuda) for i in range(3)]
        on_mesh = [{k: part.distribute(v, place) for k, v in b.items()}
                   for b in batches]
        opt_cfg = adamw.AdamWConfig(warmup_steps=2)
        before = (BITMASK_SPMM.launches, FUSED_FFN.launches)
        solo = make_train_step(cfg, opt_cfg)(params, adamw.init(params),
                                             batches[0])
        sp = part.distribute_tree(params, p_sh)
        got = make_train_step(cfg, opt_cfg)(sp, adamw.init(sp), on_mesh[0])
        torch.cuda.synchronize()
        assert _bitwise_trees(_local(got), solo)
        flat = M.flatten_tree(p_sh)
        assert all(tuple(v.placements) == flat[k].placements
                   for k, v in M.flatten_tree(got[0]).items())
        eager = make_train_step(cfg, opt_cfg, donate=True)
        graphed = GraphedTrainStep(cfg, opt_cfg)
        ep = part.distribute_tree(params, p_sh)
        eo = adamw.init(ep)
        gp = part.distribute_tree(params, p_sh)
        go = adamw.init(gp)
        for b in on_mesh:
            ep, eo, em = eager(ep, eo, b)
            gp, go, gm = graphed(gp, go, b)
            torch.cuda.synchronize()
            assert _bitwise_trees(_local((gp, go, gm)), _local((ep, eo, em)))
        g, = graphed.graphs.values()
        assert g.replays == 2
        assert (BITMASK_SPMM.launches, FUSED_FFN.launches) == before
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["rwkv6_3b", "jamba_1_5_large_398b",
                                  "seamless_m4t_medium", "paligemma_3b",
                                  "qwen3_4b", "moonshot_v1_16b_a3b"])
def test_one_rank_sharded_serve_steps_bitwise_solo_on_card(cuda, arch):
    """``make_debug_mesh(1, 1)`` (a one-rank NCCL world), bf16: every
    family's sharded ``make_prefill_fn`` logits (with the prefix or the
    encoder input), the cache-writing prefill into a cache placed by
    ``cache_shardings`` and 4 greedy ``make_serve_step`` steps bitwise
    equal to solo, eager and captured (``GraphedServeStep``), every cache
    leaf in its placements; no FFN kernel launched."""
    import torch.distributed as dist
    from repro_torch.dist import partitioning as part
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve.engine import (GraphedServeStep, init_cache_on,
                                          make_prefill_fn, make_serve_step)
    cfg, params, batch = _train_setup(cuda, arch, "bfloat16")
    started = not dist.is_initialized()
    mesh = make_debug_mesh(1, 1)
    try:
        sp = part.distribute_tree(params, part.param_shardings(
            mesh, M.abstract_params(cfg)))
        b2 = part.NamedSharding.of(mesh, part.batch_spec(mesh))
        b3 = part.NamedSharding.of(mesh, part.P(("data",), None, None))
        extras = {k: v for k, v in batch.items()
                  if k in ("prefix_embeds", "src_embeds")}
        mesh_extras = {k: part.distribute(v, b3) for k, v in extras.items()}
        toks = batch["tokens"]
        before = (BITMASK_SPMM.launches, FUSED_FFN.launches)
        pf = make_prefill_fn(cfg)
        with torch.no_grad():
            assert _bitwise_trees(
                _local(pf(sp, part.distribute(toks, b2), **mesh_extras)),
                pf(params, toks, **extras))
            B, S, n = toks.shape[0], 8, 4
            enc = extras["src_embeds"].shape[1] if cfg.encoder_layers else 0
            solo = M.init_cache(cfg, B, S + n, enc_len=enc, device=cuda)
            cache, c_sh = init_cache_on(mesh, cfg, B, S + n, enc_len=enc,
                                        device=cuda)
            if cfg.encoder_layers:
                solo = M.prefill_cache(params, cfg, solo, M.encode(
                    params, extras["src_embeds"], cfg))
                cache = M.prefill_cache(sp, cfg, cache, M.encode(
                    sp, mesh_extras["src_embeds"], cfg))
            ls, solo = pf(params, toks[:, :S].contiguous(), solo)
            lm, cache = pf(sp, part.distribute(toks[:, :S].contiguous(), b2),
                           cache)
            assert _bitwise_trees(_local((lm, cache)), (ls, solo))
            eager, graphed = make_serve_step(cfg), GraphedServeStep(cfg)
            c_g = M.map_tree(torch.clone, cache)
            ts = torch.argmax(ls, -1)[:, None]
            te = tg = part.distribute(ts, b2)
            for i in range(n):
                pos = torch.full((B,), S + i, device=cuda)
                ts, solo = eager(params, solo, ts, pos)
                te, cache = eager(sp, cache, te, pos)
                tg, c_g = graphed(sp, c_g, tg, pos)
                torch.cuda.synchronize()
                assert _bitwise_trees(_local((te, cache)), (ts, solo)), i
                assert _bitwise_trees(_local((tg, c_g)), (ts, solo)), i
        flat = M.flatten_tree(c_sh)
        assert all(tuple(v.placements) == flat[k].placements
                   for k, v in M.flatten_tree(c_g).items())
        assert (BITMASK_SPMM.launches, FUSED_FFN.launches) == before
    finally:
        if started:
            dist.destroy_process_group()


def test_mesh_and_solo_checkpoints_restart_bitwise_on_card(cuda, tmp_path):
    """A checkpoint saved from the one-rank NCCL mesh restores solo
    bitwise, and a solo save of the same values (the same bytes) restores
    onto the mesh bitwise, in its placements."""
    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainLoopConfig, shardings, train
    cfg, _, _ = _train_setup(cuda, "qwen3_4b", "bfloat16")
    shape = ShapeConfig("t", 64, 4, "train")
    started = not dist.is_initialized()
    mesh = make_debug_mesh(1, 1)
    try:
        d = str(tmp_path / "mesh")
        st = train(cfg, shape, TrainLoopConfig(
            steps=2, ckpt_every=2, ckpt_dir=d, fsdp=True, log_every=100),
            mesh=mesh, device=cuda)
        abs_p = M.abstract_params(cfg)
        abs_o = adamw.init(abs_p)
        p, o, man = ckpt.restore(d, 2, abs_p, abs_o, device=cuda)
        assert man["step"] == 2
        assert _bitwise_trees((p, o), _local((st.params, st.opt)))
        s = str(tmp_path / "solo")
        ckpt.save(s, 2, p, o)
        for f in ("params.bin", "opt.bin"):
            assert open(f"{d}/step_00000002/{f}", "rb").read() == \
                open(f"{s}/step_00000002/{f}", "rb").read()
        p_sh, o_sh = shardings(cfg, mesh, fsdp=True)
        mp, mo, _ = ckpt.restore(s, 2, abs_p, abs_o, device=cuda,
                                 shardings=p_sh, opt_shardings=o_sh)
        assert _bitwise_trees(_local((mp, mo)), (p, o))
        flat = M.flatten_tree(p_sh)
        assert all(tuple(v.placements) == flat[k].placements
                   for k, v in M.flatten_tree(mp).items())
    finally:
        if started:
            dist.destroy_process_group()
