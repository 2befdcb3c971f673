"""Port parity, work-list core: the host schedules must be array-equal to
the reference's, and the walker's plain version (run on CPU tensors) must
agree with the reference's XLA executor within rel err 1e-5, with equal
occupancy maps."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import worklist_core as rwl
from repro_torch.kernels import worklist_core as twl

CPU = torch.device("cpu")
FLAT = ("n", "m", "k", "j", "first", "last", "ragged_idx", "steps_per_pair")


def _indices(rng, nb=3, kb=6, max_nz=4, dead_block=True):
    idx = np.full((nb, max_nz), -1, np.int32)
    for n in range(nb):
        cnt = 0 if (dead_block and n == nb - 1) else \
            int(rng.integers(1, max_nz + 1))
        idx[n, :cnt] = np.sort(rng.choice(kb, cnt, replace=False))
    return idx


def _assert_wl_equal(t, r):
    for f in FLAT:
        np.testing.assert_array_equal(getattr(t, f), getattr(r, f), err_msg=f)
    for f in ("nb", "mb", "max_nz", "mb_per_img", "num_steps", "mac_steps",
              "flush_only_steps", "dense_grid_steps", "num_pairs"):
        assert getattr(t, f) == getattr(r, f), f
    for f in ("k2", "shard_of"):
        a, b = getattr(t, f), getattr(r, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("occ,gate,mpi,shard", [
    (False, False, None, False), (True, False, None, False),
    (True, False, 2, True), (True, True, 2, False), (False, True, 4, True)])
def test_build_worklist_array_equal(rng, occ, gate, mpi, shard):
    idx = _indices(rng)
    mb = 4
    kw = {}
    if occ:
        kw["occ_blk"] = rng.random((mb, 6)) < 0.5
    if gate:
        kw["gate_indices"] = _indices(rng, dead_block=False)
    if mpi is not None:
        kw["mb_per_img"] = mpi
    if shard:
        kw["shard_of"] = np.array([0, 0, 1], np.int32)
    _assert_wl_equal(twl.build_worklist(idx, mb, **kw),
                     rwl.build_worklist(idx, mb, **kw))


def test_build_worklist_rejects_bad_geometry(rng):
    idx = _indices(rng)
    with pytest.raises(ValueError):
        twl.build_worklist(idx, 4, mb_per_img=3)
    with pytest.raises(ValueError):
        twl.build_worklist(idx, 4, shard_of=np.zeros(2, np.int32))
    with pytest.raises(ValueError):
        twl.build_worklist(idx, 4, occ_blk=np.ones((3, 6), bool))


@pytest.mark.parametrize("mpi", [None, 1, 2])
def test_combined_schedule_and_counters_equal(rng, mpi):
    idx = _indices(rng)
    gate = _indices(rng, dead_block=False)
    occ = rng.random((4, 6)) < 0.6
    for g in (None, gate):
        t = twl.build_worklist(idx, 4, occ_blk=occ, gate_indices=g,
                               mb_per_img=2)
        r = rwl.build_worklist(idx, 4, occ_blk=occ, gate_indices=g,
                               mb_per_img=2)
        tc, rc = t.combined(mpi), r.combined(mpi)
        for f in ("fetch_stream", "fetch_n", "fetch_k", "fetch_at"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(rc, f))
        for f in ("mb_per_img", "images", "requests", "per_image_fetches",
                  "num_fetches", "cross_request_combine_factor",
                  "combine_factor"):
            assert getattr(tc, f) == getattr(rc, f), f
        assert t.combined(mpi) is tc     # cached per granularity
        assert twl.schedule_counters(t, combine=True, mb_per_img=mpi,
                                     predicated_steps=40) == \
            rwl.schedule_counters(r, combine=True, mb_per_img=mpi,
                                  predicated_steps=40)


def test_shard_counters_equal(rng):
    idx = _indices(rng, nb=4)
    shard = np.array([0, 0, 1, 1], np.int32)
    t = twl.build_worklist(idx, 3, shard_of=shard)
    r = rwl.build_worklist(idx, 3, shard_of=shard)
    np.testing.assert_array_equal(twl.per_shard_steps(t, 3),
                                  rwl.per_shard_steps(r, 3))
    assert twl.schedule_counters(t, mesh=True) == \
        rwl.schedule_counters(r, mesh=True)
    counts = rwl.per_shard_steps(r)
    assert twl.shard_imbalance(counts) == rwl.shard_imbalance(counts)
    assert twl.shard_scaling_efficiency(counts) == \
        rwl.shard_scaling_efficiency(counts)
    with pytest.raises(ValueError):
        twl.per_shard_steps(twl.build_worklist(idx, 3))


@pytest.mark.parametrize("mode", ["patches", "occ", "mb", "gate"])
def test_schedule_stats_matches_reference_and_build(rng, mode):
    idx = _indices(rng)
    gate = _indices(rng, dead_block=False)
    bk, bm_rows, mb = 16, 8, 4
    x = np.abs(rng.normal(size=(mb * bm_rows, 6 * bk))).astype(np.float32)
    x[rng.random(x.shape) < 0.97] = 0
    occ = (x.reshape(mb, bm_rows, 6, bk) != 0).any(axis=(1, 3))
    kw_t, kw_r = {}, {}
    if mode == "patches":
        args_t, args_r = (torch.as_tensor(x),), (jnp.asarray(x),)
    else:
        args_t = args_r = (None,)
        if mode in ("occ", "gate"):
            kw_t["occ"] = torch.as_tensor(occ)
            kw_r["occ"] = jnp.asarray(occ)
        else:
            kw_t["mb"] = kw_r["mb"] = mb
        if mode == "gate":
            kw_t["gate_indices"] = torch.as_tensor(gate)
            kw_r["gate_indices"] = jnp.asarray(gate)
    t = twl.schedule_stats(*args_t, torch.as_tensor(idx), bk=bk,
                           bm_rows=bm_rows, **kw_t)
    r = rwl.schedule_stats(*args_r, jnp.asarray(idx), bk=bk,
                           bm_rows=bm_rows, **kw_r)
    assert {k: int(v) for k, v in t.items()} == \
        {k: int(v) for k, v in r.items()}
    wl = twl.build_worklist(
        idx, mb, occ_blk=None if mode == "mb" else occ,
        gate_indices=gate if mode == "gate" else None)
    assert int(t["scheduled_steps"]) == wl.num_steps
    assert int(t["live_chunk_steps"]) == wl.mac_steps


@pytest.mark.parametrize("act", [None, "relu", "relu2", "gelu", "swiglu",
                                 "geglu"])
def test_activate_matches_reference(rng, act):
    h = rng.normal(size=(4, 16)).astype(np.float32)
    g = rng.normal(size=(4, 16)).astype(np.float32)
    t = twl.activate(torch.as_tensor(h), torch.as_tensor(g), act)
    r = rwl.activate(jnp.asarray(h), jnp.asarray(g), act)
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6,
                               atol=1e-6)


def test_activation_occupancy_equal(rng):
    x = rng.normal(size=(64, 96)).astype(np.float32)
    x[rng.random(x.shape) < 0.97] = 0
    np.testing.assert_array_equal(
        twl.activation_occupancy(torch.as_tensor(x), 8, 32).numpy(),
        np.asarray(rwl.activation_occupancy(jnp.asarray(x), 8, 32)))


def _spmm_operands(rng, mb=4, bm_rows=16, kb=6, bk=32, nb=3, bn=64,
                   max_nz=4):
    idx = _indices(rng, nb=nb, kb=kb, max_nz=max_nz)
    vals = rng.normal(size=(nb, max_nz, bk, bn)).astype(np.float32)
    vals[idx < 0] = 0
    x = rng.normal(size=(mb * bm_rows, kb * bk)).astype(np.float32)
    x[rng.random(x.shape) < 0.5] = 0
    x[:8] = 0                                   # a dead sub-block
    return x, idx, vals


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("compact", [False, True])
def test_plain_walker_matches_reference_xla(rng, act, compact):
    bk, bn, bm_rows, sub_m = 32, 64, 16, 8
    x, idx, vals = _spmm_operands(rng, bk=bk, bn=bn, bm_rows=bm_rows)
    mb = x.shape[0] // bm_rows
    occ = (x.reshape(mb, bm_rows, -1, bk) != 0).any(axis=(1, 3)) \
        if compact else None
    t_wl = twl.build_worklist(idx, mb, occ_blk=occ, mb_per_img=2)
    r_wl = rwl.build_worklist(idx, mb, occ_blk=occ, mb_per_img=2)
    t_out, t_occ = twl.worklist_spmm(
        torch.as_tensor(x), torch.as_tensor(vals), t_wl, bk=bk, bn=bn,
        bm_rows=bm_rows, sub_m=sub_m, mb_per_img=2, ncolors=2, act=act,
        emit_occupancy=True)
    r_out, r_occ = rwl.worklist_spmm(
        jnp.asarray(x), jnp.asarray(vals), r_wl, bk=bk, bn=bn,
        bm_rows=bm_rows, sub_m=sub_m, mb_per_img=2, ncolors=2, act=act,
        emit_occupancy=True, executor="xla")
    r_out = np.asarray(r_out)
    rel = np.abs(t_out.numpy() - r_out).max() / np.abs(r_out).max()
    assert rel <= 1e-5
    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(r_occ))


def test_plain_walker_dead_pairs_write_zeros(rng):
    x, idx, vals = _spmm_operands(rng, bm_rows=16)
    wl = twl.build_worklist(idx, x.shape[0] // 16)
    out, = twl.worklist_spmm(torch.as_tensor(x), torch.as_tensor(vals), wl,
                             bk=32, bn=64, bm_rows=16)
    assert not out[:, 2 * 64:].any()            # n-block 2 has no chunks


def test_device_schedule_cached_and_csr_consistent(rng):
    idx = _indices(rng)
    wl = twl.build_worklist(idx, 4, occ_blk=rng.random((4, 6)) < 0.5)
    ds = wl.on_device(CPU)
    assert wl.on_device("cpu") is ds
    ptr = ds.pair_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == wl.num_steps
    np.testing.assert_array_equal(np.nonzero(wl.first)[0], ptr[:-1])
    np.testing.assert_array_equal(np.nonzero(wl.last)[0], ptr[1:] - 1)
    assert [f.name for f in dataclasses.fields(ds)] == ["pair_ptr", "k", "j",
                                                        "k2"]
    assert ds.k2 is None                        # a one-stream list
    live = wl.k >= 0
    steps = wl.live_steps(CPU)
    assert wl.live_steps("cpu") is steps
    for got, want in zip(steps, (wl.n, wl.m, wl.k, wl.j)):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want[live])


def test_walker_rejects_what_is_not_ported(rng):
    x, idx, vals = _spmm_operands(rng, bm_rows=16)
    xt, vt = torch.as_tensor(x), torch.as_tensor(vals)
    wl = twl.build_worklist(idx, 4)
    # the stream count must match the list's, and the act the table
    with pytest.raises(ValueError):
        twl.worklist_spmm(xt, vt, wl, bk=32, bn=64, bm_rows=16, vals2=vt)
    with pytest.raises(ValueError):
        twl.worklist_spmm(xt, vt, twl.build_worklist(idx, 4,
                                                      gate_indices=idx),
                          bk=32, bn=64, bm_rows=16, act="swiglu")
    with pytest.raises(ValueError):
        twl.worklist_spmm(xt, vt, wl, bk=32, bn=64, bm_rows=16, act="tanh")
    with pytest.raises(ValueError):
        twl.worklist_spmm(xt, vt, twl.build_worklist(idx, 2), bk=32, bn=64,
                          bm_rows=16)
