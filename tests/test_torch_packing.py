"""Port parity, host packing: ``repro_torch`` core/sparsity modules against
the JAX reference on the same numpy inputs. Host arrays must be equal to
the reference's, not merely close."""
import jax
import numpy as np
import pytest
import torch

from repro.core import balance as rbal
from repro.core import bitmask as rbm
from repro.core import simulator as rsim
from repro.core import sparse as rsparse
from repro.core import telescope as rtel
from repro.sparsity import conv as rconv
from repro.sparsity import structured as rstruct
from repro_torch.core import balance as tbal
from repro_torch.core import bitmask as tbm
from repro_torch.core import simulator as tsim
from repro_torch.core import sparse as tsparse
from repro_torch.core import telescope as ttel
from repro_torch.sparsity import conv as tconv
from repro_torch.sparsity import structured as tstruct

CPU = torch.device("cpu")


def _sparse_matrix(rng, K=256, N=256, bk=128, bn=128, tile_keep=0.5):
    w = rng.normal(size=(K, N)).astype(np.float32)
    keep = rng.random((K // bk, N // bn)) < tile_keep
    return w * np.repeat(np.repeat(keep, bk, 0), bn, 1)


@pytest.mark.parametrize("n,cap", [(300, None), (128, 7), (5, None)])
def test_bitmask_vector_encode_decode_match(rng, n, cap):
    a = rng.normal(size=n).astype(np.float32)
    a[rng.random(n) < 0.6] = 0
    b = rng.normal(size=n).astype(np.float32)
    b[rng.random(n) < 0.5] = 0
    ra, ta = rbm.encode(a, cap), tbm.encode(a, cap, device=CPU)
    np.testing.assert_array_equal(ta.mask.numpy(), np.asarray(ra.mask))
    np.testing.assert_array_equal(ta.values.numpy(), np.asarray(ra.values))
    np.testing.assert_array_equal(tbm.decode(ta).numpy(),
                                  np.asarray(rbm.decode(ra)))
    rb, tb = rbm.encode(b, cap), tbm.encode(b, cap, device=CPU)
    np.testing.assert_allclose(float(tbm.match_and_multiply(ta, tb)),
                               float(rbm.match_and_multiply(ra, rb)),
                               rtol=1e-5)
    assert int(tbm.match_count(ta, tb)) == int(rbm.match_count(ra, rb))


@pytest.mark.parametrize("bk,bn,pad_to", [(128, 128, None), (32, 64, None),
                                          (64, 128, 5)])
def test_block_sparsify_densify_equal(rng, bk, bn, pad_to):
    w = _sparse_matrix(rng, bk=bk, bn=bn)
    r = rbm.block_sparsify(w, bk, bn, pad_to)
    t = tbm.block_sparsify(w, bk, bn, pad_to, device=CPU)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(r.indices))
    np.testing.assert_array_equal(t.indices_np, r.indices_np)
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(r.vals))
    assert (t.shape, t.bk, t.bn, t.n_blocks, t.max_nz) == \
        (r.shape, r.bk, r.bn, r.n_blocks, r.max_nz)
    assert t.density() == r.density()
    np.testing.assert_array_equal(tbm.block_densify(t).numpy(), w)
    np.testing.assert_array_equal(tbm.chunk_occupancy(torch.as_tensor(w),
                                                      32, bk).numpy(),
                                  np.asarray(rbm.chunk_occupancy(w, 32, bk)))


def test_host_indices_reads_back_once(rng):
    t = tbm.block_sparsify(_sparse_matrix(rng), device=CPU)
    t.indices_np = None
    np.testing.assert_array_equal(t.host_indices(), t.indices.numpy())
    assert t.host_indices() is t.indices_np


@pytest.mark.parametrize("hw,k,stride,padding", [
    ((224, 224), (7, 7), (2, 2), "SAME"), ((9, 11), (3, 3), (1, 1), "SAME"),
    ((13, 9), (3, 3), (2, 1), "VALID"), ((227, 227), (11, 11), (4, 4), "SAME"),
    ((5, 5), (3, 3), (3, 3), "same")])
def test_padtype_to_pads_matches_lax(hw, k, stride, padding):
    exp = jax.lax.padtype_to_pads(hw, k, stride, padding.upper())
    got = tsparse.padtype_to_pads(hw, k, stride, padding)
    assert [tuple(p) for p in got] == [tuple(int(v) for v in p) for p in exp]


def test_stem_pads_odd_pixel_at_the_end():
    assert tsparse.resolve_pads((224, 224), 7, 7, 2, "SAME") == \
        ((2, 3), (2, 3))


def test_normalize_stride_padding_and_prune(rng):
    for s in (2, (1, 3)):
        assert tsparse.normalize_stride(s) == rsparse.normalize_stride(s)
    for p in ("same", ((1, 2), (0, 1))):
        assert tsparse.normalize_padding(p) == rsparse.normalize_padding(p)
    w = rng.normal(size=(3, 3, 16, 24)).astype(np.float32)
    np.testing.assert_array_equal(tsparse.prune_by_magnitude(w, 0.3),
                                  rsparse.prune_by_magnitude(w, 0.3))


def test_balance_copies_equal(rng):
    dens = rng.random(37)
    for d in (0, 1):
        np.testing.assert_array_equal(tbal.greedy_balance(dens, 8, d),
                                      rbal.greedy_balance(dens, 8, d))
    w = rng.normal(size=(3, 3, 5, 7))
    w[w < 0.3] = 0
    np.testing.assert_array_equal(tbal.filter_density(w),
                                  rbal.filter_density(w))
    perm = rng.permutation(5)
    np.testing.assert_array_equal(tbal.fold_permutation(w, perm, 2),
                                  rbal.fold_permutation(w, perm, 2))
    np.testing.assert_array_equal(tbal.invert_permutation(perm),
                                  rbal.invert_permutation(perm))
    for step in range(5):
        np.testing.assert_array_equal(tbal.round_robin_permutation(4, step),
                                      rbal.round_robin_permutation(4, step))
    with pytest.raises(ValueError):
        tbal.round_robin_assignment(5, 4, 0)


def test_telescope_combine_equal(rng):
    ids = rng.integers(-1, 6, size=200)
    for lat in (None, 3.5):
        assert ttel.combine_schedule_requests(ids, lat) == \
            rtel.combine_schedule_requests(ids, lat)
    assert ttel.combine_schedule_requests([-1, -1]) == \
        rtel.combine_schedule_requests([-1, -1])


def test_simulator_tables_equal():
    assert set(tsim.BENCHMARKS) == set(rsim.BENCHMARKS)
    for name, b in rsim.BENCHMARKS.items():
        t = tsim.BENCHMARKS[name]
        assert (t.filter_density, t.map_density) == \
            (b.filter_density, b.map_density)
        assert [(l.oh, l.ow, l.k, l.d, l.n) for l in t.layers] == \
            [(l.oh, l.ow, l.k, l.d, l.n) for l in b.layers]
        assert t.layers[0].macs(2) == b.layers[0].macs(2)


@pytest.mark.parametrize("shape", [(3, 3, 3, 64), (3, 3, 64, 64),
                                   (3, 3, 64, 128), (3, 3, 256, 512),
                                   (11, 11, 3, 96), (3, 3, 96, 256)])
def test_structured_layout_and_prune_equal(rng, shape):
    assert tstruct.choose_chunk_layout(shape) == \
        rstruct.choose_chunk_layout(shape)
    layout, bk, bn = rstruct.choose_chunk_layout(shape)
    if layout != "tap":
        return
    w = rng.normal(size=shape).astype(np.float32)
    rw, rinfo = rstruct.prune_chunk_aligned(w, 0.334, bk=bk, bn=bn)
    tw, tinfo = tstruct.prune_chunk_aligned(w, 0.334, bk=bk, bn=bn)
    np.testing.assert_array_equal(tw, rw)
    np.testing.assert_array_equal(tinfo.keep, rinfo.keep)
    np.testing.assert_array_equal(tinfo.quota, rinfo.quota)
    for d in (0, 1):
        np.testing.assert_array_equal(
            tstruct.bank_balance_permutation(tinfo.keep, bn, shape[3], d),
            rstruct.bank_balance_permutation(rinfo.keep, bn, shape[3], d))


@pytest.mark.parametrize("layout,bk,bn", [("channel", 128, 128),
                                          ("channel", 32, 64),
                                          ("tap", 64, 64)])
def test_matrixize_and_pack_filters_equal(rng, layout, bk, bn):
    w = rng.normal(size=(3, 3, 64, 40)).astype(np.float32)
    w *= rsparse.prune_by_magnitude(w, 0.4)
    np.testing.assert_array_equal(
        tconv.matrixize_filters(w, layout=layout, bk=bk, bn=bn),
        rconv.matrixize_filters(w, layout=layout, bk=bk, bn=bn))
    r = rconv.pack_conv_filters(w, layout=layout, bk=bk, bn=bn)
    t = tconv.pack_conv_filters(w, layout=layout, bk=bk, bn=bn, device=CPU)
    np.testing.assert_array_equal(t.indices_np, r.indices_np)
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(r.vals))
    mat = rconv.matrixize_filters(w, layout=layout, bk=bk, bn=bn)
    np.testing.assert_array_equal(tconv.chunk_block_steps(mat, bk, bn),
                                  rconv.chunk_block_steps(mat, bk, bn))


def test_mesh_shard_assignment_equal(rng):
    steps = rng.integers(1, 9, size=11)
    for d in (1, 2, 4):
        a, ma = tconv.mesh_shard_assignment(steps, d)
        b, mb_ = rconv.mesh_shard_assignment(steps, d)
        np.testing.assert_array_equal(a, b)
        assert ma == mb_


def _chain_weights(rng):
    shapes = [(3, 3, 3, 64), (3, 3, 64, 128), (3, 3, 128, 128)]
    return [(rng.normal(size=s) * np.sqrt(2.0 / np.prod(s[:3])))
            .astype(np.float32) for s in shapes]


@pytest.mark.parametrize("pattern,mesh", [("unstructured", None),
                                          ("chunk", None), ("chunk", 2)])
def test_build_sparse_chain_equal(rng, pattern, mesh):
    ws = _chain_weights(rng)
    ref = rconv.build_sparse_chain(ws, density=0.334, pattern=pattern,
                                   mesh_devices=mesh)
    got = tconv.build_sparse_chain(ws, density=0.334, pattern=pattern,
                                   mesh_devices=mesh, device=CPU)
    assert len(got) == len(ref)
    for t, r in zip(got, ref):
        np.testing.assert_array_equal(t.w_dense, r.w_dense)
        np.testing.assert_array_equal(t.perm, r.perm)
        np.testing.assert_array_equal(t.packed.indices_np,
                                      r.packed.indices_np)
        np.testing.assert_array_equal(t.packed.vals.numpy(),
                                      np.asarray(r.packed.vals))
        assert (t.layout, t.pattern, t.packed.bk, t.packed.bn,
                t.packed.shape) == (r.layout, r.pattern, r.packed.bk,
                                    r.packed.bn, r.packed.shape)
        assert t.chunk_density() == r.chunk_density()
        assert t.scalar_density() == r.scalar_density()
        if mesh is None:
            assert t.shard is None and r.shard is None
        else:
            np.testing.assert_array_equal(t.packed.shard_of,
                                          r.packed.shard_of)
            assert (t.shard.mode, t.shard.imbalance) == \
                (r.shard.mode, r.shard.imbalance)


def test_strict_chain_is_not_ported(rng):
    with pytest.raises(NotImplementedError):
        tconv.build_sparse_chain(_chain_weights(rng), strict=True,
                                 device=CPU)
