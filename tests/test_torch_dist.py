"""Port parity, the distribution substrate without a process group:
``repro_torch.dist.elastic`` against the reference over a hypothesis grid,
``exchange_overlap_fraction``, the partition-spec trees of every smoke
config (baseline, FSDP, head-aligned factored rules) entry for entry
against the reference's ``PartitionSpec``s, ``shard_worklist_args`` with its
errors, the plain padded walk against the port's whole walk (bitwise) and
the reference's ``worklist_spmm_padded`` (rel err 1e-5), and the per-device
local work lists K1 walks on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_stubs import given, settings, st

from repro.configs.base import load_smoke as r_load_smoke
from repro.dist import collective_matmul as r_cm
from repro.dist import elastic as r_el
from repro.dist import partitioning as r_part
from repro.kernels import worklist_core as r_wc
from repro.models import model as r_M
from repro_torch.configs import load_smoke
from repro_torch.configs.base import ARCHS
from repro_torch.dist import collective_matmul as cm
from repro_torch.dist import elastic as el
from repro_torch.dist import partitioning as part
from repro_torch.dist import dp_axes, dp_extent, tp_axes
from repro_torch.kernels.worklist_core import (build_worklist,
                                               local_worklist,
                                               per_shard_steps,
                                               shard_worklist_args,
                                               worklist_spmm,
                                               worklist_spmm_padded,
                                               worklist_spmm_padded_plain)
from repro_torch.models import model as M
from repro_torch.sparsity.conv import mesh_shard_assignment
from repro_torch.tree import map_tree_with_path


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


# ---------------------------------------------------------------------------
# elastic planning
# ---------------------------------------------------------------------------
def _plan_or_error(mod, *args, **kw):
    try:
        p = mod.plan_mesh(*args, **kw)
    except ValueError as e:
        return ("error", str(e))
    return (p.pod, p.data, p.model, p.devices, p.axis_shape())


@settings(deadline=None, max_examples=200)
@given(st.integers(min_value=0, max_value=2048),
       st.sampled_from([1, 2, 4, 8, 16, 32]),
       st.sampled_from([8, 64, 256, 512]))
def test_plan_mesh_equal_to_reference(alive, mp, pod):
    assert _plan_or_error(el, alive, model_parallel=mp, pod_size=pod) == \
        _plan_or_error(r_el, alive, model_parallel=mp, pod_size=pod)


@settings(deadline=None, max_examples=60)
@given(st.lists(st.lists(st.floats(min_value=0.1, max_value=10.0),
                         min_size=5, max_size=5), min_size=1, max_size=12),
       st.integers(min_value=1, max_value=4),
       st.floats(min_value=1.05, max_value=3.0))
def test_straggler_detector_equal_to_reference(rounds, patience, threshold):
    a = el.StragglerDetector(5, patience=patience, threshold=threshold)
    b = r_el.StragglerDetector(5, patience=patience, threshold=threshold)
    for times in rounds:
        assert a.update(times) == b.update(times)


@settings(deadline=None, max_examples=60)
@given(st.dictionaries(st.integers(min_value=0, max_value=20),
                       st.integers(min_value=0, max_value=3), max_size=6),
       st.integers(min_value=0, max_value=25))
def test_failure_simulator_equal_to_reference(fail_at, step):
    assert el.FailureSimulator(fail_at).surviving(step, 64) == \
        r_el.FailureSimulator(fail_at).surviving(step, 64)


def test_straggler_detector_refuses_a_wrong_width():
    with pytest.raises(ValueError):
        el.StragglerDetector(3).update([1.0, 2.0])


@pytest.mark.parametrize("walk", [0, 1, 3, 7, 100])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("cost", [0.5, 1.0, 4.0])
def test_exchange_overlap_fraction_equal_to_reference(walk, d, cost):
    assert cm.exchange_overlap_fraction(walk, d, cost) == \
        r_cm.exchange_overlap_fraction(walk, d, cost)


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------
_STACKED = ("blocks", "enc_blocks")


def _ref_specs(tree):
    """{path: spec tuple} of a reference spec tree (string keys)."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, r_part.P))[0]:
        out[tuple(str(getattr(k, "key", k)) for k in path)] = tuple(spec)
    return out


def _port_specs(tree, abs_params):
    """``(reference path, period, spec)`` of each leaf of a port spec tree
    (walked along its params tree: a spec is a tuple): the period index
    after ``blocks``/``enc_blocks`` dropped, as the reference stacks the
    periods on a leading axis."""
    out = []

    def walk(path, leaf, spec):
        ref_path, period = [], None
        for i, k in enumerate(path):
            if isinstance(k, int) and i and path[i - 1] in _STACKED:
                period = k
                continue
            ref_path.append(str(k))
        out.append((tuple(ref_path), period, tuple(spec)))
        return spec

    map_tree_with_path(walk, abs_params, tree)
    return out


def _compare(port, ref):
    seen = set()
    for path, period, spec in port:
        want = ref[path]
        if period is not None:
            # the reference's leading stacked-periods axis is never sharded
            assert want[0] is None, (path, want)
            want = want[1:]
        assert spec == want, (path, spec, want)
        seen.add(path)
    assert seen == set(ref), set(ref) ^ seen


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp", [0, 2])
def test_param_specs_equal_to_reference(arch, fsdp):
    cfg, rcfg = load_smoke(arch), r_load_smoke(arch)
    abs_p, r_abs = M.abstract_params(cfg), r_M.abstract_params(rcfg)
    port = _port_specs(part.param_specs(abs_p, fsdp=fsdp), abs_p)
    _compare(port, _ref_specs(r_part.param_specs(r_abs, fsdp=fsdp)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("axes", [{"data": 16, "model": 16},
                                  {"data": 16, "model1": 8, "model2": 2},
                                  {"pod": 2, "data": 8, "model": 4}])
def test_rules_specs_equal_to_reference(arch, axes):
    cfg, rcfg = load_smoke(arch), r_load_smoke(arch)
    rules = part.make_rules(_FakeMesh(axes), cfg.n_heads, cfg.n_kv_heads)
    r_rules = r_part.make_rules(_FakeMesh(axes), rcfg.n_heads,
                                rcfg.n_kv_heads)
    assert (rules.tp, rules.q_axes, rules.kv_axes, dict(rules.sizes)) == \
        (r_rules.tp, r_rules.q_axes, r_rules.kv_axes, dict(r_rules.sizes))
    abs_p, r_abs = M.abstract_params(cfg), r_M.abstract_params(rcfg)
    port = _port_specs(part.param_specs(abs_p, rules=rules), abs_p)
    _compare(port, _ref_specs(r_part.param_specs(r_abs, rules=r_rules)))


@pytest.mark.parametrize("heads", [(56, 8), (32, 8), (8, 1), (64, 64)])
def test_make_rules_and_leaf_spec_equal_to_reference(heads):
    mesh = _FakeMesh({"data": 16, "model1": 8, "model2": 2})
    r, rr = part.make_rules(mesh, *heads), r_part.make_rules(mesh, *heads)
    assert (r.tp, r.q_axes, r.kv_axes) == (rr.tp, rr.q_axes, rr.kv_axes)
    for path, shape in [(("blocks", "attn", "wq"), (1, 64, 128)),
                        (("blocks", "attn", "wk"), (1, 64, 32)),
                        (("blocks", "attn", "wo"), (1, 128, 64)),
                        (("blocks", "ffn", "w_in"), (1, 64, 256)),
                        (("blocks", "moe", "w_in"), (1, 16, 64, 256)),
                        (("embed",), (512, 64)), (("lm_head",), (64, 512)),
                        (("blocks", "ln1"), (1, 64))]:
        assert tuple(part.leaf_spec(path, shape, rules=r)) == \
            tuple(r_part.leaf_spec(path, shape, rules=rr)), path
        assert tuple(part.leaf_spec(path, shape)) == \
            tuple(r_part.leaf_spec(path, shape)), path


@pytest.mark.parametrize("axes", [{"data": 16, "model": 16},
                                  {"data": 16, "model1": 8, "model2": 2},
                                  {"pod": 2, "data": 4, "model": 4},
                                  {"model": 8}])
@pytest.mark.parametrize("name", ["k", "v", "cross_k", "state", "conv"])
@pytest.mark.parametrize("max_len", [128, 130])
def test_cache_and_batch_specs_equal_to_reference(axes, name, max_len):
    mesh = _FakeMesh(axes)
    for rules in (None, part.make_rules(mesh, 32, 8)):
        r_rules = None if rules is None else r_part.make_rules(mesh, 32, 8)
        for ndim in (3, 5):
            assert tuple(part.cache_spec(mesh, max_len, name, ndim,
                                         rules=rules)) == \
                tuple(r_part.cache_spec(mesh, max_len, name, ndim,
                                        rules=r_rules))
    assert tuple(part.batch_spec(mesh)) == tuple(r_part.batch_spec(mesh))
    assert tuple(part.image_batch_spec(mesh)) == \
        tuple(r_part.image_batch_spec(mesh))
    assert dp_axes(mesh) == r_part.dp_axes(mesh)
    assert tp_axes(mesh) == r_part.tp_axes(mesh)


def test_partition_spec_entries():
    assert tuple(part.P("data", None)) == ("data", None)
    assert part.P(("pod", "data"), None)[0] == ("pod", "data")
    assert dp_extent(_FakeMesh({"pod": 2, "data": 4, "model": 8})) == 8
    assert dp_extent(_FakeMesh({"model": 8})) == 1


# ---------------------------------------------------------------------------
# per-device schedules
# ---------------------------------------------------------------------------
def _sharded_case(rng, nb=8, kb=6, max_nz=4, mb=3, d=4, occ=None):
    idx = np.full((nb, max_nz), -1, np.int32)
    for n in range(nb):
        k = rng.integers(0, max_nz + 1)
        idx[n, :k] = np.sort(rng.choice(kb, size=k, replace=False))
    steps = np.maximum((idx >= 0).sum(1), 1).astype(np.int64)
    assign, _ = mesh_shard_assignment(steps, d)
    # the per-device walk takes equal block counts: else the contiguous split
    if np.bincount(assign, minlength=d).tolist() != [nb // d] * d:
        assign = np.repeat(np.arange(d), nb // d).astype(np.int32)
    order = np.argsort(assign, kind="stable")
    idx, assign = idx[order], assign[order].astype(np.int32)
    occ_blk = None if occ is None else rng.random((mb, kb)) < occ
    return idx, assign, occ_blk


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("occ", [None, 0.6])
def test_shard_worklist_args_equal_to_reference(rng, d, occ):
    idx, assign, occ_blk = _sharded_case(rng, d=d, occ=occ)
    wl = build_worklist(idx, 3, occ_blk=occ_blk, shard_of=assign)
    rwl = r_wc.build_worklist(idx, 3, occ_blk=occ_blk, shard_of=assign)
    got, want = shard_worklist_args(wl, d), r_wc.shard_worklist_args(rwl, d)
    assert sorted(got) == sorted(want)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])
        assert got[f].dtype == want[f].dtype


def test_shard_worklist_args_errors_equal_to_reference(rng):
    idx, assign, _ = _sharded_case(rng, d=4)
    cases = [(build_worklist(idx, 2), r_wc.build_worklist(idx, 2), 4),
             (build_worklist(idx, 2, shard_of=assign),
              r_wc.build_worklist(idx, 2, shard_of=assign), 3),
             (build_worklist(idx, 2, shard_of=assign[::-1].copy()),
              r_wc.build_worklist(idx, 2, shard_of=assign[::-1].copy()), 4)]
    for wl, rwl, d in cases:
        with pytest.raises(ValueError) as a:
            shard_worklist_args(wl, d)
        with pytest.raises(ValueError) as b:
            r_wc.shard_worklist_args(rwl, d)
        assert str(a.value) == str(b.value)


def _operands(rng, idx, mb, bk=8, bn=16, bm=4):
    nb, max_nz = idx.shape
    kb = 6
    x = rng.standard_normal((bm * mb, kb * bk)).astype(np.float32)
    x[:bm, :bk] = 0.0
    vals = rng.standard_normal((nb, max_nz, bk, bn)).astype(np.float32)
    return x, vals, bk, bn, bm


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("act", [None, "relu"])
def test_padded_walk_equal_to_whole_walk_and_reference(rng, d, act):
    idx, assign, _ = _sharded_case(rng, d=d)
    mb = 3
    x, vals, bk, bn, bm = _operands(rng, idx, mb)
    wl = build_worklist(idx, mb, shard_of=assign)
    whole, wocc = worklist_spmm(torch.as_tensor(x), torch.as_tensor(vals),
                                wl, bk=bk, bn=bn, bm_rows=bm, act=act,
                                emit_occupancy=True)
    rwl = r_wc.build_worklist(idx, mb, shard_of=assign)
    args = r_wc.shard_worklist_args(rwl, d)
    nbl = wl.nb // d
    for dev in range(d):
        cols = slice(dev * nbl * bn, (dev + 1) * nbl * bn)
        local_vals = torch.as_tensor(vals[dev * nbl:(dev + 1) * nbl])
        slab, occ = worklist_spmm_padded(
            torch.as_tensor(x), local_vals, wl, dev, d, bk=bk, bn=bn,
            bm_rows=bm, act=act, emit_occupancy=True)
        assert torch.equal(slab, whole[:, cols])
        assert torch.equal(occ, wocc[:, dev * nbl:(dev + 1) * nbl])
        plain = worklist_spmm_padded_plain(
            torch.as_tensor(x), local_vals,
            *(torch.as_tensor(args[f][dev]) for f in ("n", "m", "k", "j",
                                                       "valid")),
            bk=bk, bn=bn, bm_rows=bm, nb_local=nbl, mb=mb, act=act)
        assert torch.equal(plain, slab)
        ref = np.asarray(r_wc.worklist_spmm_padded(
            jnp.asarray(x), jnp.asarray(vals[dev * nbl:(dev + 1) * nbl]),
            *(jnp.asarray(args[f][dev]) for f in ("n", "m", "k", "j",
                                                   "valid")),
            bk=bk, bn=bn, bm_rows=bm, nb_local=nbl, mb=mb, act=act))
        err = np.abs(slab.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= 1e-5, err


def test_padded_walk_refuses_what_it_cannot_walk(rng):
    idx, assign, _ = _sharded_case(rng, d=4)
    x, vals, bk, bn, bm = _operands(rng, idx, 2)
    xt, vt = torch.as_tensor(x), torch.as_tensor(vals)
    with pytest.raises(ValueError, match="shard_of"):
        worklist_spmm_padded(xt, vt[:2], build_worklist(idx, 2), 0, 4,
                             bk=bk, bn=bn, bm_rows=bm)
    wl = build_worklist(idx, 2, shard_of=assign)
    with pytest.raises(ValueError, match="row blocks"):
        worklist_spmm_padded(xt, vt, wl, 0, 4, bk=bk, bn=bn, bm_rows=bm)
    with pytest.raises(ValueError):
        worklist_spmm_padded(xt, vt[:2], wl, 4, 4, bk=bk, bn=bn, bm_rows=bm)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("occ", [None, 0.5])
def test_local_worklist_is_the_device_stream(rng, d, occ):
    idx, assign, occ_blk = _sharded_case(rng, d=d, occ=occ)
    mb = 3
    wl = build_worklist(idx, mb, occ_blk=occ_blk, mb_per_img=1,
                        shard_of=assign)
    args = shard_worklist_args(wl, d)
    per = per_shard_steps(wl, num_shards=d)
    nbl = wl.nb // d
    for dev in range(d):
        loc = local_worklist(wl, dev, d)
        assert loc is local_worklist(wl, dev, d)          # cached
        assert loc.num_steps == per[dev]
        live = loc.k >= 0
        t = int(args["valid"][dev].sum())
        for f in ("n", "m", "k", "j"):
            np.testing.assert_array_equal(getattr(loc, f)[live],
                                          args[f][dev, :t])
        ref = build_worklist(idx[dev * nbl:(dev + 1) * nbl], mb,
                             occ_blk=occ_blk, mb_per_img=1)
        for f in ("n", "m", "k", "j", "first", "last", "steps_per_pair",
                  "ragged_idx"):
            np.testing.assert_array_equal(getattr(loc, f), getattr(ref, f))
        assert (loc.nb, loc.mb, loc.max_nz, loc.mb_per_img) == \
            (ref.nb, ref.mb, ref.max_nz, ref.mb_per_img)
        np.testing.assert_array_equal(loc.pair_ptr(), ref.pair_ptr())
