"""Port parity, the analysis slice: ``repro_torch.analysis`` against
``repro.analysis``.

Every seeded defect of ``tests/test_analysis.py`` is built in both packages
from the same numpy seed and corrupted the same way; the port's set of
(rule, severity) findings must equal the reference's. The card rules
(``device="cuda"``: shared memory in place of VMEM, the dtypes the conv
kernels are built for, tilings the launches refuse) get their own cases,
each saying why it differs. Then the port's own checks: the device copies
of a work list, no false positives over the zoo (default and tuned),
purity, the pack-time and admission gates, and the port's AST lint."""
import dataclasses
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.analysis as RA
from repro.configs import base as r_base
from repro.core import bitmask as r_bm
from repro.kernels import autotune as r_tune
from repro.kernels import worklist_core as r_wl
from repro.models import model as RM
from repro.sparsity import conv as r_conv
from repro.sparsity.sparse_ffn import sparsify_model as r_sparsify_model
from repro_torch import analysis as TA
from repro_torch.analysis import lint as t_lint
from repro_torch.analysis.astlint import lint_source
from repro_torch.analysis.diagnostics import REGISTRY
from repro_torch.analysis.verify import (SMEM_BUDGET_BYTES,
                                         card_launch_smem)
from repro_torch.configs import base as t_base
from repro_torch.convert import params_from_reference
from repro_torch.core import bitmask as t_bm
from repro_torch.kernels import autotune as t_tune
from repro_torch.kernels import worklist_core as t_wl
from repro_torch.serve import Scheduler
from repro_torch.serve.vision import VirtualClock, VisionServer
from repro_torch.sparsity import conv as t_conv
from repro_torch.sparsity.sparse_ffn import sparsify_model
from repro_torch.vision import VisionEngine, build_vision_model
from repro_torch.vision.model import compile_forward

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

REF = SimpleNamespace(
    A=RA, bm=r_bm, wl=r_wl, conv=r_conv, tune=r_tune,
    sparsify=lambda w, bk=128, bn=128, **kw: r_bm.block_sparsify(
        w, bk=bk, bn=bn, **kw),
    chain=lambda ws, **kw: r_conv.build_sparse_chain(ws, **kw),
    copy=lambda a: np.array(a, copy=True))
PORT = SimpleNamespace(
    A=TA, bm=t_bm, wl=t_wl, conv=t_conv, tune=t_tune,
    sparsify=lambda w, bk=128, bn=128, **kw: t_bm.block_sparsify(
        w, bk, bn, device=CPU, **kw),
    chain=lambda ws, **kw: t_conv.build_sparse_chain(ws, device=CPU, **kw),
    copy=lambda a: a.clone() if isinstance(a, torch.Tensor)
    else np.array(a, copy=True))


def _found(diags):
    return {(d.rule, int(d.severity)) for d in diags}


def _errors(diags):
    return {d.rule for d in diags if d.severity >= TA.Severity.ERROR}


def _mat(pk, seed=0, shape=(256, 384), density=0.25, dead=((0, 1),)):
    """Element-sparse matrix with explicitly dead (k-chunk, n-block) 128 x
    128 tiles (element sparsity alone never kills a whole tile)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape) * (rng.random(shape) < density)
    for kc, nblk in dead:
        w[kc * 128:(kc + 1) * 128, nblk * 128:(nblk + 1) * 128] = 0
    return pk.sparsify(np.asarray(w, np.float32))


def _flat_replace(wl, **arrays):
    return dataclasses.replace(wl, **{k: np.asarray(v)
                                      for k, v in arrays.items()})


def _conv_chain(pk):
    rng = np.random.default_rng(1)
    ws = [np.asarray(rng.normal(size=s), np.float32)
          for s in [(3, 3, 16, 128), (3, 3, 128, 256)]]
    return pk.chain(ws, density=0.4)


def _mesh_chain(pk, seed=3):
    rng = np.random.default_rng(seed)
    ws = [np.asarray(rng.normal(size=(3, 3, 32, 512)), np.float32),
          np.asarray(rng.normal(size=(3, 3, 512, 1024)), np.float32),
          np.asarray(rng.normal(size=(3, 3, 1024, 1024)), np.float32)]
    return pk.chain(ws, density=0.35, pattern="chunk", mesh_devices=4)


def _tune_record(pk, **cfg):
    return pk.tune.TuneRecord(config=pk.tune.ConvTileConfig(**cfg),
                              cost=1.0, counts={}, table=[], m_img=1,
                              batch=1, measured=False)


# ---------------------------------------------------------------------------
# seeded defects, one per case of tests/test_analysis.py: (package) ->
# diagnostics of the corrupted artifact, and the rule the reference's test
# requires (None: the artifact is clean there)
# ---------------------------------------------------------------------------
def _wl_packed(pk):
    m = _mat(pk)
    idx = m.host_indices()
    return m, idx, pk.wl.build_worklist(idx, 4)


def case_wl_out_of_range_index(pk):
    m, idx, wl = _wl_packed(pk)
    j = np.asarray(wl.j).copy()
    j[0] = 99                                  # beyond max_nz
    return pk.A.verify_worklist(_flat_replace(wl, j=j), indices=idx)


def case_wl_non_pair_major(pk):
    m, idx, wl = _wl_packed(pk)
    perm = np.arange(np.asarray(wl.n).shape[0])[::-1]
    bad = _flat_replace(wl, **{f: np.asarray(getattr(wl, f))[perm]
                               for f in ("n", "m", "k", "j", "first",
                                         "last")})
    return pk.A.verify_worklist(bad, indices=idx)


def case_wl_dead_live_entry(pk):
    m, idx, wl = _wl_packed(pk)
    k = np.asarray(wl.k).copy()
    k[np.nonzero(k >= 0)[0][0]] = -1
    return pk.A.verify_worklist(_flat_replace(wl, k=k), indices=idx)


def case_wl_dropped_flush_only(pk):
    m = _mat(pk, seed=3, dead=((0, 0), (1, 0)))   # n-block 0 fully dead
    idx = m.host_indices()
    wl = pk.wl.build_worklist(idx, 4)
    assert wl.flush_only_steps > 0
    flush = np.nonzero(np.asarray(wl.j) < 0)[0]
    keep = np.ones(np.asarray(wl.n).shape[0], bool)
    keep[flush[0]] = False
    bad = _flat_replace(wl, **{f: np.asarray(getattr(wl, f))[keep]
                               for f in ("n", "m", "k", "j", "first",
                                         "last")})
    return pk.A.verify_worklist(bad, indices=idx)


def case_wl_wrong_first_last(pk):
    m, idx, wl = _wl_packed(pk)
    last = np.asarray(wl.last).copy()
    last[np.nonzero(last)[0][0]] = 0
    return pk.A.verify_worklist(_flat_replace(wl, last=last), indices=idx)


def _combined(pk):
    m = _mat(pk, seed=5)
    wl = pk.wl.build_worklist(m.host_indices(), 4, mb_per_img=2)
    return wl, wl.combined()


_FETCH = ("fetch_stream", "fetch_n", "fetch_k", "fetch_at")


def case_cross_duplicate_fetch(pk):
    wl, cs = _combined(pk)
    dup = {f: np.concatenate([np.asarray(getattr(cs, f)),
                              np.asarray(getattr(cs, f))[:1]])
           for f in _FETCH}
    return pk.A.verify_combined_schedule(wl, dataclasses.replace(cs, **dup))


def case_cross_dropped_fetch(pk):
    wl, cs = _combined(pk)
    cut = {f: np.asarray(getattr(cs, f))[1:] for f in _FETCH}
    return pk.A.verify_combined_schedule(wl, dataclasses.replace(cs, **cut))


def case_cross_late_fetch(pk):
    wl, cs = _combined(pk)
    at = np.asarray(cs.fetch_at).copy()
    at[0] += 1
    return pk.A.verify_combined_schedule(
        wl, dataclasses.replace(cs, fetch_at=at))


def case_cross_counter_drift(pk):
    wl, cs = _combined(pk)
    return pk.A.verify_combined_schedule(wl, dataclasses.replace(
        cs, per_image_fetches=cs.per_image_fetches + 3))


def case_cross_bad_granularity(pk):
    wl, cs = _combined(pk)
    return pk.A.verify_combined_schedule(
        wl, dataclasses.replace(cs, mb_per_img=3))   # does not divide mb=4


def case_cross_dedup_clean_via_worklist(pk):
    m = _mat(pk, seed=5)
    idx = m.host_indices()
    wl = pk.wl.build_worklist(idx, 4, mb_per_img=2)
    wl.combined()
    wl.combined(mb_per_img=1)                   # second granularity
    return pk.A.verify_worklist(wl, indices=idx)


def case_bs_zeroed_live_tile(pk):
    m, idx, wl = _wl_packed(pk)
    v = pk.copy(m.vals)
    v[0, 0] = 0
    return pk.A.verify_block_sparse(dataclasses.replace(m, vals=v))


def case_bs_nonzero_padding(pk):
    m, idx, wl = _wl_packed(pk)
    assert (idx < 0).any()
    v = pk.copy(m.vals)
    nblk, slot = np.argwhere(idx < 0)[0]
    v[nblk, slot, 0, 0] = 1.0
    return pk.A.verify_block_sparse(dataclasses.replace(m, vals=v))


def case_bs_duplicate_chunk(pk):
    m, idx, wl = _wl_packed(pk)
    nblk = int(np.argmax((idx >= 0).sum(1)))
    i2 = idx.copy()
    i2[nblk, 1] = i2[nblk, 0]                   # duplicate -> not ascending
    dev = i2 if pk is REF else torch.as_tensor(i2)
    bad = dataclasses.replace(m, indices=dev, indices_np=i2)
    return pk.A.verify_block_sparse(bad, check_values=False)


def case_bs_host_desync(pk):
    m, idx, wl = _wl_packed(pk)
    stale = idx.copy()
    stale[0, 0] = -1                            # host says dead, device live
    return pk.A.verify_block_sparse(dataclasses.replace(m, indices_np=stale),
                                    check_values=False)


def case_stale_wl_cache(pk):
    m = _mat(pk, seed=4, dead=())               # fully live packing
    wl = pk.wl.build_worklist(m.host_indices(), 4)
    m2 = _mat(pk, seed=4)                       # re-packed: a tile pruned
    m2.wl_cache[4] = wl                         # stale schedule survives
    return pk.A.verify_block_sparse(m2, check_values=False)


def case_pc_non_permutation_fold(pk):
    pc = _conv_chain(pk)[0]
    p = np.asarray(pc.perm).copy()
    p[0] = p[1]
    return pk.A.verify_packed_conv(dataclasses.replace(pc, perm=p))


def case_pc_dense_packed_mismatch(pk):
    pc = _conv_chain(pk)[0]
    w = np.asarray(pc.w_dense).copy()
    w[0, 0, 0, :] += 1.0
    return pk.A.verify_packed_conv(dataclasses.replace(pc, w_dense=w),
                                   deep=True)


def case_pc_vmem_config(pk):
    pc = _conv_chain(pk)[0]
    rec = _tune_record(pk, bm_rows=65536, sub_m=8)
    return pk.A.verify_packed_conv(dataclasses.replace(pc, tuned=rec))


def case_pc_illegal_strategy(pk):
    pc = _conv_chain(pk)[0]
    assert pc.layout == "channel"
    rec = _tune_record(pk, bm_rows=128, sub_m=8, im2col="taps")
    return pk.A.verify_packed_conv(dataclasses.replace(pc, tuned=rec))


def case_chain_geometry(pk):
    chain = _conv_chain(pk)
    return pk.A.verify_chain([chain[1], chain[1]], check_values=False)


def case_chain_last_layer_permuted(pk):
    chain = _conv_chain(pk)
    p = np.roll(np.asarray(chain[-1].perm), 1)
    bad = [chain[0], dataclasses.replace(chain[-1], perm=p)]
    return pk.A.verify_chain(bad, check_values=False)


def case_ffn_leaves_padding(pk):
    """The reference's leaves stack the periods ([P, nb, max_nz]); the
    port keeps one dict per period, so its case is period 0's slice."""
    idx = np.full((1, 2, 3), -1, np.int32)
    idx[:, :, 0] = 0
    vals = np.zeros((1, 2, 3, 128, 128), np.float32)
    vals[0, 0, 0] = 1.0
    vals[0, 1, 2] = 1.0                          # non-zero at padding
    if pk is REF:
        return RA.verify_ffn_leaves({"in_indices": idx, "in_vals": vals})
    return TA.verify_ffn_leaves({"in_indices": torch.as_tensor(idx[0]),
                                 "in_vals": torch.as_tensor(vals[0])})


def case_mesh_chain_clean(pk):
    return pk.A.verify_chain(_mesh_chain(pk), deep=True)


def _shard_case(pk, fn):
    pc = _mesh_chain(pk)[1]
    return pk.A.verify_packed_conv(fn(pc), check_values=False)


def case_shard_all_one_device(pk):
    return _shard_case(pk, lambda pc: dataclasses.replace(
        pc, shard=pk.conv.ShardInfo(pc.shard.num_devices,
                                    np.zeros_like(pc.shard.assign),
                                    pc.shard.block_steps, "greedy")))


def case_shard_out_of_range(pk):
    def corrupt(pc):
        assign = np.asarray(pc.shard.assign).copy()
        assign[0] = pc.shard.num_devices + 3
        return dataclasses.replace(pc, shard=pk.conv.ShardInfo(
            pc.shard.num_devices, assign, pc.shard.block_steps,
            pc.shard.mode))
    return _shard_case(pk, corrupt)


def case_shard_noncontiguous(pk):
    def corrupt(pc):
        assign = np.asarray(pc.shard.assign).copy()
        first0 = int(np.nonzero(assign == 0)[0][0])
        last = int(np.nonzero(assign == assign.max())[0][-1])
        assign[first0], assign[last] = assign[last], assign[first0]
        return dataclasses.replace(pc, shard=pk.conv.ShardInfo(
            pc.shard.num_devices, assign, pc.shard.block_steps,
            pc.shard.mode))
    return _shard_case(pk, corrupt)


def case_shard_of_mismatch(pk):
    def corrupt(pc):
        so = np.asarray(pc.packed.shard_of).copy()
        pc.packed.shard_of = so[::-1].copy()
        return pc
    return _shard_case(pk, corrupt)


def case_worklist_shard_imbalance_warns(pk):
    idx = np.full((8, 4), -1, np.int32)
    idx[:, 0] = 0
    idx[0, :4] = [0, 1, 2, 3]                     # block 0 is 4x heavier
    skew = np.asarray([0] * 7 + [1], np.int32)    # 7 blocks on device 0
    return pk.A.verify_worklist(pk.wl.build_worklist(idx, 2, shard_of=skew))


def case_worklist_balanced_shard_is_silent(pk):
    idx = np.full((8, 4), -1, np.int32)
    idx[:, :2] = [0, 1]
    even = np.repeat(np.arange(4), 2).astype(np.int32)
    return pk.A.verify_worklist(pk.wl.build_worklist(idx, 2, shard_of=even))


DEFECTS = {
    "wl_out_of_range_index": (case_wl_out_of_range_index, "WL-RANGE"),
    "wl_non_pair_major": (case_wl_non_pair_major, "WL-PAIR-MAJOR"),
    "wl_dead_live_entry": (case_wl_dead_live_entry, "WL-DEAD-STEP"),
    "wl_dropped_flush_only": (case_wl_dropped_flush_only, "WL-COUNTS"),
    "wl_wrong_first_last": (case_wl_wrong_first_last, "WL-FIRST-LAST"),
    "cross_duplicate_fetch": (case_cross_duplicate_fetch, "WL-CROSS-DEDUP"),
    "cross_dropped_fetch": (case_cross_dropped_fetch, "WL-CROSS-DEDUP"),
    "cross_late_fetch": (case_cross_late_fetch, "WL-CROSS-DEDUP"),
    "cross_counter_drift": (case_cross_counter_drift, "WL-CROSS-DEDUP"),
    "cross_bad_granularity": (case_cross_bad_granularity, "WL-CROSS-DEDUP"),
    "cross_dedup_clean": (case_cross_dedup_clean_via_worklist, None),
    "bs_zeroed_live_tile": (case_bs_zeroed_live_tile, "BS-MASK-VALS"),
    "bs_nonzero_padding": (case_bs_nonzero_padding, "BS-PAD-VALS"),
    "bs_duplicate_chunk": (case_bs_duplicate_chunk, "BS-ORDER"),
    "bs_host_desync": (case_bs_host_desync, "BS-HOST-SYNC"),
    "stale_wl_cache": (case_stale_wl_cache, "WL-STALE-CACHE"),
    "pc_non_permutation_fold": (case_pc_non_permutation_fold, "PC-PERM"),
    "pc_dense_packed_mismatch": (case_pc_dense_packed_mismatch,
                                 "PC-REPACK"),
    "pc_vmem_config": (case_pc_vmem_config, "PC-VMEM"),
    "pc_illegal_strategy": (case_pc_illegal_strategy, "PC-TUNED"),
    "chain_geometry": (case_chain_geometry, "CH-GEOM"),
    "chain_last_layer_permuted": (case_chain_last_layer_permuted,
                                  "CH-LAST-PERM"),
    "ffn_leaves_padding": (case_ffn_leaves_padding, "BS-PAD-VALS"),
    "mesh_chain_clean": (case_mesh_chain_clean, None),
    "shard_all_one_device": (case_shard_all_one_device, "PC-SHARD"),
    "shard_out_of_range": (case_shard_out_of_range, "PC-SHARD"),
    "shard_noncontiguous": (case_shard_noncontiguous, "PC-SHARD"),
    "shard_of_mismatch": (case_shard_of_mismatch, "PC-SHARD"),
    "worklist_shard_imbalance_warns": (case_worklist_shard_imbalance_warns,
                                       "WL-SHARD-BAL"),
    "worklist_balanced_shard_is_silent": (
        case_worklist_balanced_shard_is_silent, None),
}


@pytest.mark.parametrize("name", sorted(DEFECTS))
def test_seeded_defect_findings_equal_reference(name):
    """Same artifact, same corruption: the port finds exactly the
    (rule, severity) pairs the reference finds, including the one the
    reference's own test requires."""
    fn, rule = DEFECTS[name]
    want = _found(fn(REF))
    got = _found(fn(PORT))
    assert got == want
    if rule is None:
        assert not _errors(fn(PORT))
    else:
        assert rule in {r for r, _ in got}


# ---------------------------------------------------------------------------
# the card rules (device="cuda": host arithmetic, so they run here)
# ---------------------------------------------------------------------------
def _padded_conv(pk, max_nz):
    """A 3x3x8 -> 8 conv packed at bk = bn = 8 with its chunk lists padded
    to ``max_nz`` slots: the walker CTA's live list holds a slot each."""
    w = np.asarray(np.random.default_rng(2).normal(size=(3, 3, 8, 8)),
                   np.float32)
    packed = pk.conv.pack_conv_filters(w, bk=8, bn=8, pad_to=max_nz,
                                       **({} if pk is REF else
                                          {"device": CPU}))
    return pk.conv.PackedConv(w, packed, np.arange(8))


def card_vmem_reference_budget(pk):
    """bm_rows=65536 overflows the reference's VMEM estimate; on the card
    the walker's CTA tile is at most 128 rows whatever the row block, and
    65536 is a multiple of 32, so nothing is refused."""
    pc = _conv_chain(pk)[0]
    return dataclasses.replace(pc, tuned=_tune_record(pk, bm_rows=65536,
                                                      sub_m=8))


def card_vmem_live_list(pk):
    """12000 slots a chunk list: the CTA's live list alone needs 192000
    bytes of shared memory, over the card's 227 KiB with the ring and the
    warp bands; the reference's VMEM estimate does not count slots."""
    return _padded_conv(pk, 12000)


def card_dtype_fp16(pk):
    """fp16 tiles are legal for the reference's kernels; the card's conv
    kernels are built for fp32."""
    pc = _conv_chain(pk)[0]
    v = pc.packed.vals
    v = v.astype(np.float16) if pk is REF else v.to(torch.float16)
    return dataclasses.replace(pc, packed=dataclasses.replace(pc.packed,
                                                              vals=v))


def card_tuned_bm48(pk):
    """A 48-row block: the reference's tiling takes it; the card's
    dense-grid conv (K2) refuses row blocks that neither divide nor are a
    multiple of 32."""
    pc = _conv_chain(pk)[0]
    return dataclasses.replace(pc, tuned=_tune_record(pk, bm_rows=48,
                                                      sub_m=8))


def card_wide_n_block(pk):
    """Packed at 256-column n-blocks: the walker takes at most 128."""
    w = np.asarray(np.random.default_rng(3).normal(size=(3, 3, 16, 256)),
                   np.float32)
    return pk.chain([w], density=0.5, chunk=256)[0]


CARD = {
    "vmem_reference_budget": (card_vmem_reference_budget, {"PC-VMEM"},
                              set()),
    "vmem_live_list": (card_vmem_live_list, set(), {"PC-VMEM"}),
    "dtype_fp16": (card_dtype_fp16, set(), {"PC-DTYPE"}),
    "tuned_bm48": (card_tuned_bm48, set(), {"PC-TUNED"}),
    "wide_n_block": (card_wide_n_block, set(), {"PC-TUNED"}),
}


@pytest.mark.parametrize("name", sorted(CARD))
def test_card_rules_differ_from_reference_as_stated(name):
    """On the CPU the port agrees with the reference; with
    ``device="cuda"`` it finds what the card's launches would refuse (see
    each case's docstring)."""
    fn, ref_rules, card_rules = CARD[name]
    r = RA.verify_packed_conv(fn(REF))
    t = fn(PORT)
    assert _errors(r) == ref_rules
    assert _found(TA.verify_packed_conv(t)) == _found(r)
    assert _errors(TA.verify_packed_conv(t, device="cuda")) == card_rules


def test_card_smem_model_boundary():
    """PC-VMEM on the card fires from the first chunk-list length at which
    the host model of a launch asks for more than SMEM_BUDGET_BYTES."""
    def need(max_nz):
        stub = SimpleNamespace(packed=SimpleNamespace(
            max_nz=max_nz, shape=(72, 8), bk=8))
        return card_launch_smem(stub, 128, 8)
    lo, hi = 1, 20000                     # need(lo) fits, need(hi) not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if need(mid) <= SMEM_BUDGET_BYTES else (lo, mid)
    for max_nz, fires in ((lo, False), (hi, True)):
        pc = _padded_conv(PORT, max_nz)
        assert card_launch_smem(pc, 128, 8) == need(max_nz)
        rules = _errors(TA.verify_packed_conv(pc, device="cuda"))
        assert ("PC-VMEM" in rules) == fires, max_nz
        assert not _errors(TA.verify_packed_conv(pc))


@pytest.mark.parametrize("chunk,card", [(12, {"FF-SHAPE"}), (128, set())])
def test_card_ffn_chunk_rule(chunk, card):
    """The FFN kernels take chunks of a multiple of 8, at most 128 columns:
    leaves packed at another chunk pass on the CPU (the plain versions
    take any) and are refused for the card."""
    idx = np.full((2, 3), -1, np.int32)
    idx[:, :2] = [0, 1]
    vals = np.zeros((2, 3, chunk, chunk), np.float32)
    vals[:, :2] = 1.0
    sp = {"in_indices": torch.as_tensor(idx),
          "in_vals": torch.as_tensor(vals)}
    ref = RA.verify_ffn_leaves({"in_indices": idx[None],
                                "in_vals": vals[None]})
    assert _found(TA.verify_ffn_leaves(sp)) == _found(ref) == set()
    assert _errors(TA.verify_ffn_leaves(sp, device="cuda")) == card


# ---------------------------------------------------------------------------
# the port's own: device copies of a work list, zoo, purity
# ---------------------------------------------------------------------------
def _served_model():
    """A 2-layer VGG (chunk pattern) after one forward: its static work
    lists cached (the tap layer's walked through the tap slabs, whose plain
    version remaps a copy of the list)."""
    vm = build_vision_model("VGGNet", density=0.3, seed=0, num_layers=2,
                            pattern="chunk", device=CPU)
    x = torch.zeros((2, 16, 16, 3))
    x[:, 3:11, 2:9] = 1.0
    compile_forward(vm)(x)
    return vm


@pytest.mark.parametrize("copy", ["device_schedule", "live_steps"])
def test_stale_device_copy_is_refused(copy):
    """A device copy of a cached schedule that no longer equals its host
    schedule (here: one chunk id set to K // bk, the offset the walker
    would read out of range) fires WL-STALE-CACHE, and the engine refuses
    the model before anything launches."""
    vm = _served_model()
    assert not TA.verify_model(vm)
    conv = vm.layers[1].conv
    wl = next(iter(conv.wl_cache.values()))
    kb = conv.packed.shape[0] // conv.packed.bk
    t = int(np.nonzero(wl.k >= 0)[0][0])
    if copy == "device_schedule":
        ds = wl.on_device(CPU)
        bad = ds.k.clone()
        bad[t] = kb
        wl._device[str(CPU)] = dataclasses.replace(ds, k=bad)
    else:
        wl.live_steps(CPU)   # the plain walker's copy (on the patch matrix)
        key = next(iter(wl._live))
        n, m, k, j = wl._live[key]
        k = k.clone()
        k[0] = kb
        wl._live[key] = (n, m, k, j)
    assert "WL-STALE-CACHE" in _errors(TA.verify_model(vm))
    with pytest.raises(TA.AnalysisError, match="WL-STALE-CACHE"):
        VisionEngine(vm, num_slots=2)


@pytest.mark.parametrize("pattern", ["unstructured", "chunk"])
@pytest.mark.parametrize("name", ["AlexNet", "VGGNet", "ResNet18",
                                  "ResNet50"])
def test_zoo_zero_false_positives(name, pattern):
    """Every artifact the port's pipeline produces verifies clean, default
    pack and cost-model tuned, on the CPU and under the card rules."""
    vm = build_vision_model(name, density=0.3, seed=0, num_layers=3,
                            pattern=pattern, device=CPU)
    for tag in ("default", "tuned"):
        if tag == "tuned":
            t_tune.autotune_model(vm, batch=1, measure=False)
        for device in (None, "cuda"):
            diags = TA.verify_model(vm, f"zoo/{name}/{pattern}/{tag}",
                                    deep=True, device=device)
            assert not diags, TA.render_text(diags)


def test_verifier_is_pure():
    """Side-effect free: no wl_cache fills, no indices_np, no device
    copies, artifact bit-identical after verification."""
    m = _mat(PORT, seed=7)
    m.indices_np = None
    before = (m.indices.clone(), m.vals.clone())
    assert not TA.has_errors(TA.verify_block_sparse(m))
    assert m.indices_np is None and not m.wl_cache
    assert torch.equal(m.indices, before[0])
    assert torch.equal(m.vals, before[1])
    vm = _served_model()
    caches = [(dict(c.wl_cache), {k: (dict(w._device), dict(w._live))
                                  for k, w in c.wl_cache.items()})
              for c in (layer.conv for layer in vm.layers)]
    fwd = dict(vm._fwd_cache)
    assert not TA.verify_model(vm, deep=True)
    assert vm._fwd_cache == fwd
    for (cache, copies), conv in zip(caches,
                                     (layer.conv for layer in vm.layers)):
        assert conv.wl_cache == cache
        for k, w in conv.wl_cache.items():
            assert (w._device, w._live) == copies[k]


def test_verify_artifact_dispatch():
    vm = _served_model()
    conv = vm.layers[0].conv
    for obj in (vm, [layer.conv for layer in vm.layers], conv,
                conv.packed, next(iter(conv.wl_cache.values()))):
        assert TA.verify_artifact(obj) == []
    with pytest.raises(TypeError):
        TA.verify_artifact(object())


# ---------------------------------------------------------------------------
# wiring: strict pack + admission gates, on by default
# ---------------------------------------------------------------------------
def test_strict_build_chain_passes():
    rng = np.random.default_rng(2)
    ws = [np.asarray(rng.normal(size=(3, 3, 16, 64)), np.float32)]
    chain = t_conv.build_sparse_chain(ws, density=0.5, strict=True,
                                      device=CPU)
    assert len(chain) == 1


def _perm_corrupt_model():
    vm = build_vision_model("AlexNet", density=0.3, seed=0, num_layers=2,
                            device=CPU)
    pc = vm.layers[0].conv
    p = np.asarray(pc.perm).copy()
    p[0] = p[1]
    vm.layers[0].conv = dataclasses.replace(pc, perm=p)
    return vm


@pytest.mark.parametrize("server", [False, True])
def test_vision_admission_rejects_corrupt_model(server):
    """On by default, as in the reference; verify_artifacts=False opts
    out."""
    vm = _perm_corrupt_model()
    make = (lambda **kw: VisionServer(vm, buckets=(8,), step_cost_s=1.0,
                                      clock=VirtualClock(), **kw)) \
        if server else (lambda **kw: VisionEngine(vm, num_slots=2, **kw))
    with pytest.raises(TA.AnalysisError, match="PC-PERM"):
        make()
    make(verify_artifacts=False)


@pytest.fixture(scope="module")
def nemotron():
    """The reference's Scheduler test config: Nemotron-4 smoke, packed in
    both packages from the same dense weights with strict=True."""
    rcfg = dataclasses.replace(r_base.load_smoke("nemotron_4_340b"),
                               sparse_ffn=True)
    tcfg = dataclasses.replace(t_base.load_smoke("nemotron_4_340b"),
                               sparse_ffn=True)
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    rps = r_sparsify_model(rp, rcfg, density=0.5, num_shards=4, strict=True)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)
    tps = sparsify_model(tp, tcfg, density=0.5, num_shards=4, strict=True)
    return rcfg, tcfg, rps, tps


def _corrupt_leaf(params, fn):
    """A copy of ``params`` whose first packed FFN leaf dict is ``fn``
    applied to a shallow copy of it (the other leaves are shared)."""
    blocks = [dict(period) for period in params["blocks"]]
    pk = next(iter(blocks[0]))
    bp = dict(blocks[0][pk])
    bp["ffn_sparse"] = fn(dict(bp["ffn_sparse"]))
    blocks[0][pk] = bp
    return dict(params, blocks=blocks)


def test_scheduler_admits_clean_and_rejects_corrupt_leaves(nemotron):
    rcfg, tcfg, rps, tps = nemotron
    Scheduler(tcfg, tps, num_slots=1, max_len=8)        # admits clean
    assert not TA.verify_param_leaves(tps, d_model=tcfg.d_model)

    def below_padding(sp):
        idx = sp["in_indices"].clone()
        idx[0, 0] = -2                           # below the -1 padding value
        sp["in_indices"] = idx
        return sp
    bad = _corrupt_leaf(tps, below_padding)
    with pytest.raises(TA.AnalysisError, match="BS-RANGE"):
        Scheduler(tcfg, bad, num_slots=1, max_len=8)
    Scheduler(tcfg, bad, num_slots=1, max_len=8, verify_artifacts=False)

    # the reference refuses the same corruption of its stacked leaves
    blocks = dict(rps["blocks"])
    key = next(iter(blocks))
    sp = dict(blocks[key]["ffn_sparse"])
    idx = np.asarray(sp["in_indices"]).copy()
    idx[0, 0, 0] = -2
    r_rules = _errors(RA.verify_ffn_leaves(dict(sp, in_indices=idx)))
    t_rules = _errors(TA.verify_ffn_leaves(
        bad["blocks"][0][next(iter(bad["blocks"][0]))]["ffn_sparse"]))
    assert t_rules == r_rules and "BS-RANGE" in t_rules


@pytest.mark.parametrize("defect,rule", [("pad_tile", "BS-PAD-VALS"),
                                         ("past_d_model", "BS-RANGE")])
def test_scheduler_rejects_card_faults(nemotron, defect, rule):
    """The faults that would end a CUDA context or sum garbage on the card:
    a non-zero tile at a -1 slot (MAC'd by the gated union schedule) and
    an in-projection chunk id past the input's chunks (read as an offset
    into x)."""
    _, tcfg, _, tps = nemotron

    def corrupt(sp):
        idx = sp["in_indices"].clone()
        if defect == "pad_tile":
            idx[0, -1] = -1                      # keeps a non-zero tile
        else:
            kb = -(-tcfg.d_model // sp["in_vals"].shape[2])
            idx[0, idx.shape[1] - 1] = kb
            idx[0] = torch.sort(idx[0]).values
        sp["in_indices"] = idx
        return sp
    bad = _corrupt_leaf(tps, corrupt)
    assert rule in _errors(TA.verify_param_leaves(bad, d_model=tcfg.d_model))
    with pytest.raises(TA.AnalysisError, match=rule):
        Scheduler(tcfg, bad, num_slots=1, max_len=8)


def test_strict_sparsify_model_and_card_chunks(nemotron):
    """strict=True passes what sparsify_model packs, at any chunk on the
    CPU; leaves at a chunk the card's FFN kernels refuse fail the card
    rules, which strict=True applies to leaves packed on the card."""
    _, tcfg, _, tps = nemotron
    diags = TA.verify_param_leaves(tps, d_model=tcfg.d_model,
                                   device="cuda")
    assert not diags, TA.render_text(diags)
    small = sparsify_model(tps, tcfg, density=0.5, num_shards=4, chunk=12,
                           strict=True)
    assert _errors(TA.verify_param_leaves(small, device="cuda")) == \
        {"FF-SHAPE"}


# ---------------------------------------------------------------------------
# the port's AST lint
# ---------------------------------------------------------------------------
def _lint(snippet, path="snippet.py"):
    return lint_source(textwrap.dedent(snippet), path)


def test_lint_cache_mutate():
    got = _lint("""
        def sneaky(conv, cfg, wl):
            conv.tuned = cfg                    # skips invalidation
            conv.wl_cache[4] = None
            conv.wl_cache.clear()
            wl._device["cuda:0"] = None
            del wl._live[("cpu", 0)]
            conv.packed.indices_np = None
    """)
    assert [d.rule for d in got] == ["CACHE-MUTATE"] * 6


def test_lint_cache_mutate_silent():
    setter = textwrap.dedent("""
        def autotune_conv(conv, rec):
            conv.tuned = rec
            conv.wl_cache.clear()
    """)
    assert lint_source(setter, "src/repro_torch/kernels/autotune.py") == []
    owner = textwrap.dedent("""
        def on_device(self, key, ds):
            self._device[key] = ds
    """)
    assert lint_source(owner,
                       "src/repro_torch/kernels/worklist_core.py") == []
    assert _lint("""
        def reads(conv, wl, cache):
            cache[4] = wl                       # a caller-owned dict
            return conv.tuned, wl._device.get("cuda:0")
    """) == []


def test_lint_eager_guard():
    got = _lint("""
        def builds_unguarded(x, indices):
            return build_worklist(indices.cpu().numpy(), 4)

        def builds_guarded(x, indices):
            if x.is_cuda and torch.cuda.is_current_stream_capturing():
                raise ValueError("build before capture")
            return build_worklist(indices.cpu().numpy(), 4)
    """)
    assert [d.rule for d in got] == ["EAGER-GUARD"]
    assert "builds_unguarded" in got[0].message
    assert got[0].path == "snippet.py:2"


def test_lint_tf32_on():
    got = _lint("""
        import torch
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = flag
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.fp32_precision = "tf32"
    """)
    assert [d.rule for d in got] == ["TF32-ON"] * 4
    assert _lint("""
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.fp32_precision = "ieee"
    """) == []


KERNEL = "src/repro_torch/kernels/snippet.py"


def test_lint_kernel_fallback():
    got = _lint("""
        def spmm(x, w):
            try:
                return _spmm_cuda(x, w)
            except RuntimeError:
                return spmm_plain(x, w)

        def other(x, w):
            if x.device.type == "cuda":
                return _spmm_cuda(x, w)
            return spmm_plain(x, w)

        def branch(x, w):
            if x.device.type != "cpu":
                return spmm_plain(x, w)
            return _spmm_cuda(x, w)
    """, KERNEL)
    assert [d.rule for d in got] == ["KERNEL-FALLBACK"] * 3
    assert "except handler" in got[0].message


def test_lint_kernel_fallback_silent():
    assert _lint("""
        def spmm(x, w):
            if x.device.type == "cpu":
                return spmm_plain(x, w)
            if x.device.type != "cuda":
                raise ValueError(x.device)
            return _spmm_cuda(x, w)

        def spmm2(x, w):
            if x.device.type != "cpu":
                return _spmm_cuda(x, w)
            else:
                return spmm_plain(x, w)

        def slabs_plain(x, w):
            return spmm_plain(x, w)
    """, KERNEL) == []
    # outside kernels/ the plain versions are the tests' and oracles' own
    assert _lint("""
        def oracle(x, w):
            return spmm_plain(x, w)
    """) == []


def test_lint_graph_host_read():
    got = _lint("""
        import torch
        from repro_torch import graphs

        @graphs.captured
        def body(cache, packed):
            n = packed[0].item()
            rows = packed.cpu()
            ids = packed[1].tolist()
            arr = cache.numpy()
            if bool(packed[2].any()):
                pos = int(packed[1][0])
            scale = float(cache.max() * 2)
            pos_t = torch.as_tensor(ids, device=cache.device)
            eps = torch.tensor(1e-6, device="cuda")
            return cache

        @captured
        def factory(params):
            def step(x):
                return x * float(x.sum())
            return step
    """)
    assert [d.rule for d in got] == ["GRAPH-HOST-READ"] * 10
    assert "body()" in got[0].message and got[0].path == "snippet.py:7"
    assert "factory()" in got[-1].message


def test_lint_graph_host_read_silent():
    assert _lint("""
        import torch
        from repro_torch import graphs

        @graphs.captured
        def body(cache, packed, cfg):
            B = int(packed.shape[0])
            D = int(cache.size(1))
            eps = float(cfg.norm_eps)
            keep = packed[2].bool()
            idx = torch.arange(B, device=cache.device)
            return cache * keep[:, None] + eps, idx

        def eager(cache, packed):
            # not captured: the scheduler reads tokens back here
            return packed.cpu().numpy(), int(cache.sum()), \
                torch.as_tensor([1, 2], device="cuda")
    """) == []


def test_lint_suppression():
    src = """
        import torch
        torch.backends.cudnn.allow_tf32 = True  # lint: ignore[TF32-ON]{}
    """
    assert _lint(src.format(" the TF32 baseline of a timing table")) == []
    assert {d.rule for d in _lint(src.format(""))} == \
        {"TF32-ON", "LINT-SUPPRESS"}


def test_port_tree_is_lint_clean():
    """src/repro_torch and chip_smoke.py pass the port's lint (with
    suppressions only where they give a reason)."""
    diags = t_lint.lint_paths([str(REPO / p) for p in t_lint.LINT_PATHS],
                              str(REPO))
    assert diags == [], TA.render_text(diags)


def test_rule_registry_renders():
    for rule in ("WL-LIVE-MAP", "PC-VMEM", "FF-SHAPE", "CACHE-MUTATE",
                 "EAGER-GUARD", "TF32-ON", "KERNEL-FALLBACK",
                 "GRAPH-HOST-READ", "LINT-SUPPRESS"):
        assert rule in REGISTRY
        assert f"`{rule}`" in t_lint.render_rules()
    assert "No findings" in TA.render_github([])


def test_lint_cli_exits_zero(monkeypatch, capsys):
    """``python -m repro_torch.analysis.lint``: both halves (a 2-layer zoo
    here) and the registry listing."""
    monkeypatch.chdir(REPO)
    assert t_lint.main(["--layers", "2"]) == 0
    assert "0 error(s)" in capsys.readouterr().out
    assert t_lint.main(["--rules"]) == 0
    assert "PC-VMEM" in capsys.readouterr().out
