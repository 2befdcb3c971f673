"""Port parity, the LM FFN kernels: the plain versions of the predicated
sparse matmul (K3) and the fused FFN (K4) against the reference's Pallas
kernels run in interpret mode, the skip model of ``ops``, the FFN entry
points and the offline FFN packing. Small sizes: 2-3 n-blocks and row
blocks, 3 chunks of 128, inputs with all-zero rows and sub-blocks."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels.bitmask_spmm import bitmask_spmm as r_bitmask_spmm
from repro.kernels.fused_ffn import fused_ffn_spmm as r_fused_ffn_spmm
from repro.kernels.worklist_core import activate as r_activate
from repro.sparsity import sparse_ffn as r_sf
from repro_torch.kernels import ops
from repro_torch.kernels.bitmask_spmm import bitmask_spmm, subblock_macs
from repro_torch.kernels.grid import (check_lm_grid, count_partials,
                                      grid_geometry)
from repro_torch.kernels.fused_ffn import fused_ffn_spmm
from repro_torch.kernels.worklist_core import activate, activation_occupancy
from repro_torch.sparsity import sparse_ffn as sf

CPU = torch.device("cpu")
ACTS = ["swiglu", "geglu", "relu2", "relu", "gelu"]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _operands(seed=0, M=256, K=384, relu_rows=False):
    """x [M, K] with zero rows (a decode block's padding), zero sub-blocks
    and a zero chunk slab; -1 padded in (max_nz 3) and gate (max_nz 2)
    chunk lists over 3 n-blocks, zero tiles behind every -1."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    if relu_rows:
        x = np.maximum(x, 0)
    x[200:] = 0
    x[8:24] = 0
    x[40:48, :128] = 0
    idx = np.array([[0, 2, -1], [1, -1, -1], [2, 1, 0]], np.int32)
    vals = rng.normal(size=(3, 3, 128, 128)).astype(np.float32) * 0.05
    vals[idx < 0] = 0
    gidx = np.array([[1, -1], [0, 2], [-1, -1]], np.int32)
    gvals = rng.normal(size=(3, 2, 128, 128)).astype(np.float32) * 0.05
    gvals[gidx < 0] = 0
    return x, idx, vals, gidx, gvals


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("sub_m", [8, 128])
def test_bitmask_spmm_plain_matches_pallas(two_sided, sub_m):
    x, idx, vals, _, _ = _operands()
    kw = dict(bk=128, bn=128, bm=128, sub_m=sub_m, two_sided=two_sided,
              count_macs=True)
    ref, rcnt = r_bitmask_spmm(jnp.asarray(x), jnp.asarray(idx),
                               jnp.asarray(vals), interpret=True, **kw)
    out, cnt = bitmask_spmm(_t(x), _t(idx), _t(vals), **kw)
    assert out.shape == (256, 384) and out.dtype == torch.float32
    assert _rel(out, ref) <= 1e-5
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt))
    if two_sided and sub_m == 8:
        # the zero sub-blocks and rows were skipped, not just multiplied
        assert int(cnt.sum()) < int((idx >= 0).sum()) * 2 * 16


def test_bitmask_spmm_bf16_within_one_ulp():
    x, idx, vals, _, _ = _operands()
    bf = ml_dtypes.bfloat16
    kw = dict(bk=128, bn=128, bm=128, sub_m=8, two_sided=True)
    ref = np.asarray(r_bitmask_spmm(jnp.asarray(x.astype(bf)),
                                    jnp.asarray(idx),
                                    jnp.asarray(vals.astype(bf)),
                                    interpret=True, **kw)).astype(np.float32)
    out = bitmask_spmm(_t(x).to(torch.bfloat16), _t(idx),
                       _t(vals).to(torch.bfloat16), **kw)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    # one bf16 ulp at the reference's magnitude (8 significand bits)
    ulp = np.maximum(np.abs(ref), 1e-30) * 2.0 ** -7
    assert (np.abs(got - ref) <= ulp).all()


@pytest.mark.parametrize("act", ACTS)
def test_fused_ffn_plain_matches_pallas(act):
    x, idx, vals, gidx, gvals = _operands(relu_rows=act == "relu2")
    gated = act in ("swiglu", "geglu")
    kw = dict(act=act, bk=128, bn=128, bm=128, sub_m=8, two_sided=True)
    ref = r_fused_ffn_spmm(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(vals),
        jnp.asarray(gidx) if gated else None,
        jnp.asarray(gvals) if gated else None, interpret=True, **kw)
    h = fused_ffn_spmm(_t(x), _t(idx), _t(vals),
                       _t(gidx) if gated else None,
                       _t(gvals) if gated else None, **kw)
    assert h.shape == (256, 384)
    assert _rel(h, ref) <= 1e-5
    assert bool((h[200:] == 0).all())          # zero rows stay exact zeros


@pytest.mark.parametrize("sub_m", [8, 128])
def test_fused_ffn_one_sided_matches_pallas(sub_m):
    x, idx, vals, gidx, gvals = _operands(seed=1)
    kw = dict(act="swiglu", bk=128, bn=128, bm=128, sub_m=sub_m,
              two_sided=False)
    ref = r_fused_ffn_spmm(jnp.asarray(x), jnp.asarray(idx),
                           jnp.asarray(vals), jnp.asarray(gidx),
                           jnp.asarray(gvals), interpret=True, **kw)
    h = fused_ffn_spmm(_t(x), _t(idx), _t(vals), _t(gidx), _t(gvals), **kw)
    assert _rel(h, ref) <= 1e-5


def test_fused_ffn_rejects_wrong_gate_operands():
    x, idx, vals, gidx, gvals = _operands()
    with pytest.raises(ValueError):
        fused_ffn_spmm(_t(x), _t(idx), _t(vals), act="swiglu")
    with pytest.raises(ValueError):
        fused_ffn_spmm(_t(x), _t(idx), _t(vals), _t(gidx), _t(gvals),
                       act="relu2")
    with pytest.raises(ValueError):
        fused_ffn_spmm(_t(x), _t(idx), _t(vals), act="tanh")


@pytest.mark.parametrize("act", ACTS + [None])
def test_activate_matches_reference(act):
    rng = np.random.default_rng(3)
    h = rng.normal(size=(64, 32)).astype(np.float32) * 3
    g = rng.normal(size=(64, 32)).astype(np.float32) * 3
    ref = r_activate(jnp.asarray(h), jnp.asarray(g), act)
    got = activate(_t(h), _t(g), act)
    assert _rel(got, ref) <= 1e-6
    assert bool((activate(torch.zeros(4, 4), torch.zeros(4, 4), act)
                 == 0).all())                  # every act maps 0 to 0


@pytest.mark.parametrize("sub_m", [8, None])
def test_tile_stats_match_reference_and_kernel_counts(sub_m):
    x, idx, _, _, _ = _operands()
    x = x[:, :300]                             # K padded to the chunk
    kw = dict(k_total=384, bk=128, sub_m=sub_m)
    ref = r_ops.sparse_matmul_tile_stats(jnp.asarray(x), jnp.asarray(idx),
                                         **kw)
    got = ops.sparse_matmul_tile_stats(_t(x), _t(idx), **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert float(got[k]) == float(ref[k]), k
    _, counts = ops.sparse_matmul_packed(
        _t(x), _t(idx), torch.zeros(3, 3, 128, 128), k_total=384, bk=128,
        bn=128, sub_m=sub_m, count_macs=True)
    assert int(counts.sum()) == int(got["executed"])


@pytest.mark.parametrize("M", [1, 4, 130, 300])
def test_predicated_steps_match_reference(M):
    assert ops._predicated_steps(M, 76, 20, 8) == \
        r_ops._predicated_steps(M, 76, 20, 8)


def test_packed_entry_points_pad_rows_and_k():
    """Leading dims and an unpadded K go through ``_pad_rows_k`` into both
    kernels and back."""
    x, idx, vals, gidx, gvals = _operands()
    x3 = x[:10, :300].reshape(2, 5, 300)
    ref = r_ops.fused_sparse_ffn(
        jnp.asarray(x3), jnp.asarray(idx), jnp.asarray(vals),
        jnp.asarray(gidx), jnp.asarray(gvals), act="swiglu", k_total=384,
        bk=128, bn=128, sub_m=8, interpret=True)
    h = ops.fused_sparse_ffn(_t(x3), _t(idx), _t(vals), _t(gidx),
                             _t(gvals), act="swiglu", k_total=384, bk=128,
                             bn=128, sub_m=8)
    assert h.shape == (2, 5, 384) and _rel(h, ref) <= 1e-5
    ref2 = r_ops.sparse_matmul_packed(
        jnp.asarray(ref), jnp.asarray(idx), jnp.asarray(vals), k_total=384,
        bk=128, bn=128, sub_m=8, interpret=True)
    out = ops.sparse_matmul_packed(h, _t(idx), _t(vals), k_total=384,
                                   bk=128, bn=128, sub_m=8)
    assert out.shape == (2, 5, 384) and _rel(out, ref2) <= 1e-5


def test_work_list_ffn_variants_zero_rows_and_gate_operands():
    """The work-list variants (parity tests in
    ``test_torch_worklist_ffn.py``): zero rows give exact zeros, and a gate
    operand the act does not match raises."""
    idx = torch.zeros(1, 1, dtype=torch.int32)
    vals = torch.ones(1, 1, 128, 128)
    kw = dict(k_total=128, bk=128, bn=128)
    assert not ops.sparse_matmul_packed_wl(torch.zeros(8, 128), idx, vals,
                                           **kw).any()
    assert not ops.fused_sparse_ffn_wl(torch.zeros(8, 128), idx, vals,
                                       act="relu2", **kw).any()
    with pytest.raises(ValueError):
        ops.fused_sparse_ffn_wl(torch.zeros(8, 128), idx, vals, act="swiglu",
                                **kw)


@pytest.mark.parametrize("act,gated", [("swiglu", True), ("relu2", False)])
def test_build_sparse_ffn_matches_reference(act, gated):
    rng = np.random.default_rng(5)
    D, Fd = 200, 300                           # both padded to the chunk
    p = {"w_in": rng.normal(size=(D, Fd)).astype(np.float32),
         "w_out": rng.normal(size=(Fd, D)).astype(np.float32)}
    if gated:
        p["w_gate"] = rng.normal(size=(D, Fd)).astype(np.float32)
    kw = dict(density=0.35, num_shards=4, step=1)
    ref = r_sf.build_sparse_ffn(p, act, **kw)
    got = sf.build_sparse_ffn(p, act, device=CPU, **kw)
    np.testing.assert_array_equal(got.perm, ref.perm)
    for role in ("w_in", "w_out", "w_gate"):
        r, g = getattr(ref, role), getattr(got, role)
        if r is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.indices.numpy(),
                                      np.asarray(r.indices))
        np.testing.assert_array_equal(g.vals.numpy(), np.asarray(r.vals))
    x = rng.normal(size=(3, 7, D)).astype(np.float32)
    want = ref(jnp.asarray(x), interpret=True, sub_m=8)
    out = got(_t(x), sub_m=8)
    assert out.shape == (3, 7, ref.w_out.shape[1])
    assert _rel(out, want) <= 1e-5
    assert _rel(sf.dense_reference(got, _t(x)),
                r_sf.dense_reference(ref, jnp.asarray(x))) <= 1e-5
    assert _rel(out, sf.dense_reference(got, _t(x))) <= 1e-5
    want_c = ref(jnp.asarray(x), sub_m=8, schedule="compact",
                 executor="xla")
    assert _rel(got(_t(x), schedule="compact"), want_c) <= 1e-5
    with pytest.raises(ValueError):
        got(_t(x), schedule="tiled")


# (M, nb, bn, column group): Qwen3-4B's out- and in-projection and RWKV6-3B's
# in-projection at decode, then the card tests' shapes
GRID_SHAPES = [(128, 20, 128, 16), (128, 76, 128, 32), (128, 70, 128, 32),
               (256, 3, 128, 16), (384, 3, 64, 16), (128, 3, 96, 16)]


@pytest.mark.parametrize("M,nb,bn,col", GRID_SHAPES)
def test_grid_geometry_covers_output_once(M, nb, bn, col):
    geom = grid_geometry(M, nb, bm=128, bn=bn)
    assert geom.col_group == col
    cover = torch.zeros(M, nb * bn, dtype=torch.int32)
    for rows, cols in geom.tiles():
        cover[rows, cols] += 1
    assert bool((cover == 1).all())
    assert geom.blocks == len(list(geom.tiles()))
    if nb >= 20:
        # a decode step (the first 32 rows live) keeps every SM busy
        assert nb * geom.groups >= 132


@pytest.mark.parametrize("sub_m", [4, 8, 16, 128])
@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("M,K,nb,max_nz", [(384, 512, 3, 4),
                                           (128, 9728, 20, 76)])
def test_count_partials_reduce_to_subblock_macs(sub_m, two_sided, M, K, nb,
                                                max_nz):
    """The kernel's per-block MAC counts (the host model of its count rule)
    add up to the plain version's [nb, mb] counts: live rows in a few
    sub-blocks, -1 slots among stored ones."""
    rng = np.random.default_rng(sub_m + M)
    bk = 128
    x = torch.as_tensor(rng.normal(size=(M, K)).astype(np.float32))
    x[torch.as_tensor(rng.random(M // 4) < 0.6).repeat_interleave(4)] = 0
    x[:, :bk][torch.as_tensor(rng.random(M) < 0.5)] = 0
    kb = K // bk
    idx = torch.as_tensor(np.stack([rng.permutation(kb)[:max_nz]
                                    for _ in range(nb)]).astype(np.int32))
    idx[rng.random(idx.shape) < 0.2] = -1
    vals = torch.zeros(1, 1, 1, 1).expand(nb, max_nz, bk, 8)
    _, want = subblock_macs(x, idx, vals, bk=bk, bm=128, sub_m=sub_m,
                            two_sided=two_sided)
    geom = grid_geometry(M, nb, bm=128, bn=128)
    part = count_partials(geom, activation_occupancy(x, sub_m, bk), idx,
                          sub_m=sub_m, two_sided=two_sided)
    assert part.shape == geom.counts_shape
    assert bool((part[:, :, 1:] == 0).all())     # column group 0 counts
    assert torch.equal(geom.reduce_counts(part), want)


def test_lm_grid_rejects_what_the_copies_cannot_take():
    x = torch.zeros(128, 256)
    check_lm_grid(x, [("vals", torch.zeros(2, 2, 128, 128))], 128, 128)
    for bk, bn in ((100, 128), (128, 60), (128, 136)):
        with pytest.raises(ValueError):
            check_lm_grid(x, [], bk, bn)
    with pytest.raises(ValueError):              # not 16-byte aligned
        check_lm_grid(torch.zeros(128 * 256 + 1)[1:].reshape(128, 256), [],
                      128, 128)
    with pytest.raises(ValueError):              # row blocks of 32 rows
        grid_geometry(96, 3, bm=48, bn=128)
