"""Port parity, the work-list ("compact") FFN schedule: the walker's
two-stream plain version against the reference's XLA executor for every
act, the ``ops`` work-list entry points with their schedule counters, the
static-schedule cache, and ``SparseFFN`` / ``sparse_ffn_apply`` with
``schedule="compact"`` on the smoke configs of Qwen3-4B (gated SwiGLU) and
Nemotron-4 (squared ReLU). The reference's Pallas walker does not trace on
this jax, so it is held to ``executor="xla"``. Small sizes: 3 n-blocks,
3 chunks of 128, 8-row blocks, inputs with zero rows and sub-blocks."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.kernels import ops as r_ops
from repro.kernels import worklist_core as rwl
from repro.models import model as RM
from repro.sparsity import sparse_ffn as r_sf
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import worklist_core as twl
from repro_torch.sparsity import sparse_ffn as sf

CPU = torch.device("cpu")
ACTS = ["swiglu", "geglu", "relu2", "relu", "gelu"]
GATED = ("swiglu", "geglu")
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _t(a):
    return torch.as_tensor(np.array(a))


def _operands(seed=0, M=64, K=384):
    """x [M, K] with zero rows, zero 8-row sub-blocks and a zero chunk of
    one sub-block; in (max_nz 3) and gate (max_nz 2) chunk lists over 3
    n-blocks, -1 padded, zero tiles behind every -1."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[50:] = 0
    x[8:24] = 0
    x[32:40, 128:256] = 0
    idx = np.array([[0, 2, -1], [1, -1, -1], [2, 1, 0]], np.int32)
    vals = rng.normal(size=(3, 3, 128, 128)).astype(np.float32) * 0.05
    vals[idx < 0] = 0
    gidx = np.array([[1, -1], [0, 2], [-1, -1]], np.int32)
    gvals = rng.normal(size=(3, 2, 128, 128)).astype(np.float32) * 0.05
    gvals[gidx < 0] = 0
    return x, idx, vals, gidx, gvals


def _aligned(idx, vals, gidx, gvals):
    """The gate lists padded to the in lists' slot axis."""
    pad = idx.shape[1] - gidx.shape[1]
    return (np.pad(gidx, ((0, 0), (0, pad)), constant_values=-1),
            np.pad(gvals, ((0, 0), (0, pad), (0, 0), (0, 0))))


# ---------------------------------------------------------------------------
# the walker: two streams, every act, fp32 and bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act,streams", [(a, 2) for a in ACTS]
                         + [(a, 1) for a in ACTS if a not in GATED])
@pytest.mark.parametrize("compact", [True, False])
def test_plain_walker_matches_reference_xla(act, streams, compact):
    x, idx, vals, gidx, gvals = _operands()
    gidx, gvals = _aligned(idx, vals, gidx, gvals)
    bm_rows = 8
    mb = x.shape[0] // bm_rows
    occ = np.asarray(rwl.activation_occupancy(jnp.asarray(x), 8, 128)) \
        .astype(bool) if compact else None
    kw = dict(occ_blk=occ, gate_indices=gidx if streams == 2 else None)
    r_wl = rwl.build_worklist(idx, mb, **kw)
    t_wl = twl.build_worklist(idx, mb, **kw)
    np.testing.assert_array_equal(t_wl.k, r_wl.k)
    if streams == 2:
        np.testing.assert_array_equal(t_wl.k2, r_wl.k2)
        # a step live in the gate stream only: the in stream is dead there
        assert ((t_wl.k < 0) & (t_wl.k2 >= 0)).any()
    v2 = gvals if streams == 2 else None
    ref = rwl.worklist_spmm(
        jnp.asarray(x), jnp.asarray(vals), r_wl,
        vals2=None if v2 is None else jnp.asarray(v2), bk=128, bn=128,
        bm_rows=bm_rows, act=act, executor="xla")[0]
    out = twl.worklist_spmm(_t(x), _t(vals), t_wl,
                            vals2=None if v2 is None else _t(v2), bk=128,
                            bn=128, bm_rows=bm_rows, act=act)[0]
    assert out.shape == (64, 384) and out.dtype == torch.float32
    assert _rel(out, ref) <= TOL
    assert bool((out[50:] == 0).all())         # zero rows stay exact zeros


@pytest.mark.parametrize("act", ACTS)
def test_plain_walker_bf16(act):
    """bf16 storage: the output is bit for bit the bf16 rounding of the
    same function's fp32 sums on the widened inputs, which are within
    1e-5 of the reference's bf16 run widened the same way."""
    x, idx, vals, gidx, gvals = _operands(seed=1)
    gidx, gvals = _aligned(idx, vals, gidx, gvals)
    bf = ml_dtypes.bfloat16
    xb, vb, gb = (a.astype(bf).astype(np.float32) for a in (x, vals, gvals))
    wl = twl.build_worklist(idx, 8, gate_indices=gidx)
    kw = dict(bk=128, bn=128, bm_rows=8, act=act)
    out16 = twl.worklist_spmm(_t(xb).bfloat16(), _t(vb).bfloat16(), wl,
                              vals2=_t(gb).bfloat16(), **kw)[0]
    out32 = twl.worklist_spmm(_t(xb), _t(vb), wl, vals2=_t(gb), **kw)[0]
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, out32.to(torch.bfloat16))
    ref = rwl.worklist_spmm(jnp.asarray(x.astype(bf)),
                            jnp.asarray(vals.astype(bf)),
                            rwl.build_worklist(idx, 8, gate_indices=gidx),
                            vals2=jnp.asarray(gvals.astype(bf)),
                            executor="xla", **kw)[0]
    assert _rel(out32, np.asarray(rwl.worklist_spmm(
        jnp.asarray(xb), jnp.asarray(vb),
        rwl.build_worklist(idx, 8, gate_indices=gidx),
        vals2=jnp.asarray(gb), executor="xla", **kw)[0])) <= TOL
    # one bf16 ulp at the reference's magnitude, both rounded once
    r = np.asarray(ref).astype(np.float32)
    ulp = np.maximum(np.abs(r), 1e-30) * 2.0 ** -7
    assert (np.abs(out16.float().numpy() - r) <= ulp).all()


def test_live_steps_per_stream():
    x, idx, _, gidx, gvals = _operands()
    gidx, _ = _aligned(idx, None, gidx, gvals)
    occ = np.asarray(rwl.activation_occupancy(jnp.asarray(x), 8, 128)) \
        .astype(bool)
    wl = twl.build_worklist(idx, 8, occ_blk=occ, gate_indices=gidx)
    ds = wl.on_device(CPU)
    np.testing.assert_array_equal(ds.k2.numpy(), wl.k2)
    for stream, ks in ((0, wl.k), (1, wl.k2)):
        live = ks >= 0
        got = wl.live_steps(CPU, stream)
        assert wl.live_steps("cpu", stream) is got
        for g, want in zip(got, (wl.n, wl.m, ks, wl.j)):
            np.testing.assert_array_equal(g.numpy(), want[live])
    with pytest.raises(ValueError):
        twl.build_worklist(idx, 8).live_steps(CPU, 1)


# ---------------------------------------------------------------------------
# ops entry points and the schedule counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("compact", [True, False])
def test_wl_entry_points_match_reference(act, compact):
    """Leading dims, an unpadded K and in/gate lists of unequal widths go
    through both work-list launches; outputs within 1e-5 and the schedule
    counters exactly the reference's."""
    x, idx, vals, gidx, gvals = _operands()
    gated = act in GATED
    x3 = x[:10, :300].reshape(2, 5, 300)
    kw = dict(act=act, k_total=384, bk=128, bn=128, sub_m=8,
              compact_activations=compact, return_schedule=True)
    ref, r_sched = r_ops.fused_sparse_ffn_wl(
        jnp.asarray(x3), jnp.asarray(idx), jnp.asarray(vals),
        jnp.asarray(gidx) if gated else None,
        jnp.asarray(gvals) if gated else None, executor="xla", **kw)
    h, sched = ops.fused_sparse_ffn_wl(
        _t(x3), _t(idx), _t(vals), _t(gidx) if gated else None,
        _t(gvals) if gated else None, **kw)
    assert h.shape == (2, 5, 384) and _rel(h, ref) <= TOL
    assert sched == r_sched
    kw2 = dict(k_total=384, bk=128, bn=128, sub_m=8,
               compact_activations=compact, return_schedule=True)
    ref2, r_sched2 = r_ops.sparse_matmul_packed_wl(
        ref, jnp.asarray(idx), jnp.asarray(vals), executor="xla", **kw2)
    out, sched2 = ops.sparse_matmul_packed_wl(h, _t(idx), _t(vals), **kw2)
    assert out.shape == (2, 5, 384) and _rel(out, ref2) <= TOL
    assert sched2 == r_sched2
    # the dense grid's plain version computes the same function
    dense = ops.fused_sparse_ffn(
        _t(x3), _t(idx), _t(vals), _t(gidx) if gated else None,
        _t(gvals) if gated else None, act=act, k_total=384, bk=128, bn=128,
        sub_m=8)
    assert _rel(h, dense) <= TOL


def test_wl_cache_reuses_static_schedules():
    x, idx, vals, _, _ = _operands()
    cache, r_cache = {}, {}
    kw = dict(k_total=384, bk=128, bn=128, sub_m=8,
              compact_activations=False)
    a = ops.sparse_matmul_packed_wl(_t(x), _t(idx), _t(vals),
                                    wl_cache=cache, **kw)
    r_ops.sparse_matmul_packed_wl(jnp.asarray(x), jnp.asarray(idx),
                                  jnp.asarray(vals), wl_cache=r_cache,
                                  executor="xla", **kw)
    assert set(cache) == set(r_cache) == {8}
    wl = cache[8]
    for f in ("n", "m", "k", "j", "first", "last"):
        np.testing.assert_array_equal(getattr(wl, f), getattr(r_cache[8], f))
    assert wl.k2 is None and wl.mac_steps == int((idx >= 0).sum()) * 8
    b = ops.sparse_matmul_packed_wl(_t(x), _t(idx), _t(vals),
                                    wl_cache=cache, **kw)
    assert cache[8] is wl and torch.equal(a, b)
    # a different row count gets its own entry; the compact schedule skips
    # the dead sub-blocks the static one walks, for the same output
    ops.sparse_matmul_packed_wl(_t(x[:16]), _t(idx), _t(vals),
                                wl_cache=cache, **kw)
    assert set(cache) == {2, 8}
    c, sched = ops.sparse_matmul_packed_wl(
        _t(x), _t(idx), _t(vals), k_total=384, bk=128, bn=128, sub_m=8,
        return_schedule=True)
    assert sched["live_chunk_steps"] < wl.mac_steps
    assert _rel(c, a) <= TOL


def test_wl_schedules_are_eager_only(monkeypatch):
    """As the reference refuses tracers, the host-built schedule refuses a
    call under ``torch.compile`` (or ``torch.jit`` tracing)."""
    x, idx, vals, _, _ = _operands()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with pytest.raises(ValueError):
        ops.sparse_matmul_packed_wl(_t(x), _t(idx), _t(vals), k_total=384,
                                    bk=128, bn=128)


# ---------------------------------------------------------------------------
# SparseFFN / sparse_ffn_apply(schedule="compact") on the smoke configs
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _leaves(arch):
    """Period-0 packed FFN leaves of the reference's sparse smoke model and
    the port's packing of the same dense weights."""
    rcfg = dataclasses.replace(r_base.load_smoke(arch), sparse_ffn=True)
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    rps = r_sf.sparsify_model(rp, rcfg, density=0.35, num_shards=4)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device=CPU)
    tps = sf.sparsify_model(tp, rcfg, density=0.35, num_shards=4)
    ref = {k: np.asarray(v)[0]
           for k, v in rps["blocks"]["p0"]["ffn_sparse"].items()}
    return rcfg, ref, tps["blocks"][0]["p0"]["ffn_sparse"]


@pytest.mark.parametrize("arch", ["qwen3_4b", "nemotron_4_340b"])
@pytest.mark.parametrize("rows", [2, 13])
def test_sparse_ffn_apply_compact_matches_reference(arch, rows):
    cfg, r_sp, t_sp = _leaves(arch)
    for k, v in r_sp.items():
        np.testing.assert_array_equal(t_sp[k].numpy(), v)
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(1, rows, cfg.d_model)).astype(np.float32)
    x[0, 1] = 0                                 # a dead row
    r_sp = {k: jnp.asarray(v) for k, v in r_sp.items()}
    for compact in (True, False):
        r_cache, t_cache = {}, {}
        want = r_sf.sparse_ffn_apply(
            r_sp, jnp.asarray(x), cfg.act, schedule="compact",
            executor="xla", compact_activations=compact, wl_cache=r_cache)
        got = sf.sparse_ffn_apply(t_sp, _t(x), cfg.act, schedule="compact",
                                  compact_activations=compact,
                                  wl_cache=t_cache)
        assert got.shape == x.shape and _rel(got, want) <= TOL
        assert {k: set(v) for k, v in t_cache.items()} == \
            {k: set(v) for k, v in r_cache.items()}
    dense = sf.sparse_ffn_apply(t_sp, _t(x), cfg.act)
    assert _rel(got, dense) <= TOL
    with pytest.raises(ValueError):
        sf.sparse_ffn_apply(t_sp, _t(x), cfg.act, schedule="tiled")


@pytest.mark.parametrize("act", ["swiglu", "relu2"])
def test_sparse_ffn_object_compact_matches_reference(act):
    rng = np.random.default_rng(5)
    D, Fd = 200, 300
    p = {"w_in": rng.normal(size=(D, Fd)).astype(np.float32),
         "w_out": rng.normal(size=(Fd, D)).astype(np.float32)}
    if act == "swiglu":
        p["w_gate"] = rng.normal(size=(D, Fd)).astype(np.float32)
    ref = r_sf.build_sparse_ffn(p, act, density=0.35, num_shards=4)
    got = sf.build_sparse_ffn(p, act, density=0.35, num_shards=4,
                              device=CPU)
    x = np.maximum(rng.normal(size=(3, 7, D)), 0).astype(np.float32)
    for compact in (True, False):
        want = ref(jnp.asarray(x), schedule="compact", executor="xla",
                   compact_activations=compact)
        out = got(_t(x), schedule="compact", compact_activations=compact)
        assert _rel(out, want) <= TOL
    # the static schedules cached on the packed matrices, per row blocks
    assert set(got.w_in.wl_cache) == set(ref.w_in.wl_cache) == {3}
    assert set(got.w_out.wl_cache) == set(ref.w_out.wl_cache) == {3}


def test_decode2_compaction_as_bench_serve():
    """Decode batch 2 on the Qwen3 smoke FFN: one scheduled step against
    16 predicated sub-block steps per period — ``BENCH_serve.json``'s
    ``decode2`` record."""
    cfg, r_sp, t_sp = _leaves("qwen3_4b")
    x = np.random.default_rng(0).normal(size=(2, cfg.d_model)) \
        .astype(np.float32)
    args = [t_sp[k] for k in ("in_indices", "in_vals", "gate_indices",
                              "gate_vals")]
    h, sched = ops.fused_sparse_ffn_wl(
        _t(x), *args, act=cfg.act, k_total=128, bk=128, bn=128, sub_m=8,
        return_schedule=True)
    assert sched == {"scheduled_steps": 1, "live_chunk_steps": 1,
                     "flush_only_steps": 0, "dense_grid_steps": 1,
                     "predicated_grid_steps": 16, "compaction_factor": 16.0}
    _, r_sched = r_ops.fused_sparse_ffn_wl(
        jnp.asarray(x), *(jnp.asarray(r_sp[k]) for k in (
            "in_indices", "in_vals", "gate_indices", "gate_vals")),
        act=cfg.act, k_total=128, bk=128, bn=128, sub_m=8, executor="xla",
        return_schedule=True)
    assert sched == r_sched
    dense = ops.fused_sparse_ffn(_t(x), *args, act=cfg.act, k_total=128,
                                 bk=128, bn=128, sub_m=8)
    assert _rel(h, dense) <= TOL
