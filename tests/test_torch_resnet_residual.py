"""ResNet-50 v1.5 with its shortcuts on the port's normal path, on the CPU:
the residual graph built by ``build_residual_model`` (per-map channel
permutations, balanced, crossing the adds) against the benchmark's plain
reference ``bench/reference/residual.py`` through the eager forward,
``compile_forward``, the dense oracle, ``oracle_check`` and
``VisionEngine``; the shortcut in the walker's plain version and the
dense-grid conv; the verifier on the graph and on miswired copies; the
paths that walk a chain refusing a graph; and chains packed and run as
before. Small sizes: stage widths 8/16/32/64 (x4 expansion), one or two
blocks a stage, 32 px."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import residual as R  # noqa: E402
from repro_torch.analysis import verify_model  # noqa: E402
from repro_torch.kernels.autotune import autotune_model  # noqa: E402
from repro_torch.kernels.sparse_conv import (shortcut_rows,  # noqa: E402
                                             sparse_conv2d_nhwc)
from repro_torch.kernels.worklist_core import (build_worklist,  # noqa: E402
                                               worklist_spmm)
from repro_torch.sparsity.conv import (build_sparse_chain,  # noqa: E402
                                       build_sparse_graph, map_groups,
                                       pack_conv_filters)
from repro_torch.vision import model as VM  # noqa: E402
from repro_torch.vision.engine import ImageRequest, VisionEngine  # noqa: E402

CPU = torch.device("cpu")
SIZE = 32
SEED = 2**31 + 33
WIDTHS = (8, 16, 32, 64)
BLOCKS = {"one_block": (1, 1, 1, 1), "two_blocks": (2, 1, 2, 1)}
TOL = 1e-5          # the port's gate against a plain fp32 reference


def config_of(blocks):
    return {"arch": "ResNet50", "input_size": SIZE, "pattern": "unstructured",
            "density": 0.421,
            "pack": {"num_shards": 16, "balance_filters": True,
                     "micro_ranges": 3},
            "layers": R.bottleneck_layers(WIDTHS, blocks)}


def dense_filters(cfg, seed=SEED):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(l["k"], l["k"], l["cin"], l["cout"]))
             * np.sqrt(2.0 / (l["k"] ** 2 * l["cin"]))).astype(np.float32)
            for l in cfg["layers"]]


def build(cfg, filters, **kw):
    pack = cfg["pack"]
    args = dict(input_size=SIZE, density=cfg["density"],
                num_shards=pack["num_shards"],
                balance_filters=pack["balance_filters"],
                micro_ranges=pack["micro_ranges"], device=CPU)
    args.update(kw)
    return VM.build_residual_model(cfg["arch"], filters, cfg["layers"],
                                   **args)


def images(n, seed=SEED):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, SIZE, SIZE, 3, generator=g).abs_()


@pytest.fixture(scope="module", params=list(BLOCKS))
def net(request):
    cfg = config_of(BLOCKS[request.param])
    filters = dense_filters(cfg)
    model = build(cfg, filters)
    x = images(3)
    pruned = R.prune_filters(cfg, filters)
    ref = R.forward(cfg, R.device_filters(pruned, CPU), x)
    return cfg, filters, model, x, ref


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


# ---------------------------------------------------------------------------
# the port against the plain reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", ["eager", "compiled", "dense_oracle",
                                  "oracle_check", "collect_stats"])
def test_residual_net_matches_the_plain_reference(net, path):
    cfg, _, model, x, ref = net
    if path == "eager":
        out, _ = VM.forward(model, x, compiled=False)
    elif path == "compiled":
        out = VM.compile_forward(model)(x)
    elif path == "dense_oracle":
        out = VM.dense_forward(model, x)
    elif path == "oracle_check":
        out, stats, rel = VM.oracle_check(model, x)
        assert rel <= TOL and len(stats) == len(cfg["layers"])
    else:
        out, stats = VM.forward(model, x, collect_stats=True)
        assert [s["layer"] for s in stats] == list(range(len(model.layers)))
        assert all(s["spec_oh"] is None for s in stats)
    assert out.shape == ref.shape
    assert float(ref.abs().max()) > 0
    assert _rel(out, ref) <= TOL


def test_compiled_forward_is_the_eager_forward_bitwise(net):
    _, _, model, x, _ = net
    eager, _ = VM.forward(model, x, compiled=False)
    assert torch.equal(VM.compile_forward(model)(x), eager)
    assert torch.equal(VM.graphed_forward(model)(x), eager)


def test_engine_matches_solo_forward_bitwise(net):
    _, _, model, _, _ = net
    x = images(5, seed=SEED + 1)
    eng = VisionEngine(model, num_slots=4)
    reqs = [ImageRequest(i, x[i].numpy(), arrival=i // 2) for i in range(5)]
    produced = eng.run(reqs)
    assert sorted(produced) == list(range(5))
    solo = VM.compile_forward(model)
    for r in reqs:
        np.testing.assert_array_equal(
            produced[r.rid], solo(torch.as_tensor(r.image[None]))[0].numpy())
    assert eng.stats.images == 5


def test_permutations_cross_the_adds(net):
    """Balanced maps are permuted, the maps an add joins share one
    permutation, and the last map leaves unpermuted."""
    cfg, _, model, _, _ = net
    perms = [l.conv.perm for l in model.layers]
    ident = [np.array_equal(p, np.arange(p.size)) for p in perms]
    adds = [l["add"] for l in cfg["layers"]]
    group = map_groups(adds)
    joined = [i for i, a in enumerate(adds) if a is not None]
    assert not all(ident[i] for i in joined)
    for i in joined:
        assert np.array_equal(perms[i], perms[adds[i]])
    last = group[-1]
    assert all(ident[i] for i, g in enumerate(group) if g == last)


def test_layer_geometry_follows_the_wiring(net):
    cfg, _, model, _, _ = net
    geo = VM.layer_geometry(model, SIZE)
    sides = R.output_sides(cfg, SIZE)
    assert [g["oh"] for g in geo] == [s["oh"] for s in sides]
    assert [g["ow"] for g in geo] == [s["oh"] for s in sides]


# ---------------------------------------------------------------------------
# the shortcut in the kernels' plain versions
# ---------------------------------------------------------------------------
def _packed_case(seed=5, m_img=49, b=2, k=64, cout=256):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(1, 1, k, cout)).astype(np.float32)
    w *= rng.random(w.shape) < 0.4
    packed = pack_conv_filters(w, device=CPU)
    x = torch.as_tensor(np.maximum(rng.normal(size=(b, 7, 7, k)), 0),
                        dtype=torch.float32)
    s = torch.as_tensor(rng.normal(size=(b, 7, 7, cout)), dtype=torch.float32)
    return packed, x, s


@pytest.mark.parametrize("act", ["relu", None])
def test_walker_plain_adds_the_shortcut_before_the_activation(act):
    """The fused add gives what the walk without it, then the add and the
    activation, give: bit for bit (one fp32 add, then the activation),
    its occupancy that of the sum."""
    packed, x, s = _packed_case()
    b, m_pad, ld = x.shape[0], 128, packed.n_blocks * packed.bn
    flat = F.pad(x.reshape(b, 49, -1), (0, 0, 0, m_pad - 49)).reshape(
        b * m_pad, -1)
    flat = F.pad(flat, (0, packed.shape[0] - flat.shape[1]))
    wl = build_worklist(packed.host_indices(), b, mb_per_img=1)
    res = shortcut_rows(s, m_pad, ld)
    kw = dict(bk=packed.bk, bn=packed.bn, bm_rows=128, sub_m=8)
    fused, occ = worklist_spmm(flat, packed.vals, wl, act=act,
                               emit_occupancy=True, residual=res, **kw)
    plain = worklist_spmm(flat, packed.vals, wl, act=None, **kw)[0] + res
    plain = torch.clamp_min(plain, 0.0) if act == "relu" else plain
    assert torch.equal(fused, plain)
    want = (plain.reshape(-1, 8, packed.n_blocks, packed.bn) != 0) \
        .any(3).any(1).int()
    assert torch.equal(occ, want)


@pytest.mark.parametrize("fuse_relu", [True, False])
def test_conv_shortcut_dense_grid_equals_compact_bitwise(fuse_relu):
    packed, x, s = _packed_case(seed=6)
    kw = dict(padding="VALID", layout="channel", fuse_relu=fuse_relu,
              emit_occupancy=True, residual=s)
    a, aux_a = sparse_conv2d_nhwc(x, packed, 1, 1, 256, schedule="compact",
                                  **kw)
    d, aux_d = sparse_conv2d_nhwc(x, packed, 1, 1, 256, schedule="dense",
                                  **kw)
    assert torch.equal(a, d)
    assert torch.equal(aux_a["occupancy"], aux_d["occupancy"])
    bare, _ = sparse_conv2d_nhwc(x, packed, 1, 1, 256, padding="VALID",
                                 layout="channel", fuse_relu=False)
    want = bare + s
    assert torch.equal(a, torch.clamp_min(want, 0.0) if fuse_relu else want)


@pytest.mark.parametrize("kind", ["own_output", "copy"])
def test_shortcut_rows_view_or_copy(kind):
    """A layer's own padded output is read where it lies; any other map is
    copied into the same rows, its pad rows and columns zero."""
    b, oh, ow, c, m_pad = 2, 7, 7, 128, 128
    buf = torch.randn(b, m_pad, c)
    s = buf[:, :oh * ow, :].reshape(b, oh, ow, c)
    if kind == "copy":
        s = s.clone()
    rows = shortcut_rows(s, m_pad, c)
    assert (rows.data_ptr() == buf.data_ptr()) == (kind == "own_output")
    assert torch.equal(rows.reshape(b, m_pad, c)[:, :oh * ow], buf[:, :oh * ow])
    wide = shortcut_rows(s, m_pad, 2 * c).reshape(b, m_pad, 2 * c)
    assert torch.equal(wide[:, :oh * ow, :c], buf[:, :oh * ow])
    assert not wide[:, oh * ow:].any() and not wide[:, :, c:].any()


@pytest.mark.parametrize("padding", [0, 1])
def test_max_pool_with_padding(padding):
    x = torch.randn(2, 9, 9, 4).clamp_min(0)
    y = VM.max_pool(x, 3, 2, padding)
    want = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding)
    assert torch.equal(y, want.permute(0, 2, 3, 1))
    assert y.shape[1] == VM.pooled_size(9, 9, (3, 2, padding))[0]


# ---------------------------------------------------------------------------
# the verifier
# ---------------------------------------------------------------------------
def _errors(diags):
    return {d.rule for d in diags}


def test_verify_model_accepts_the_graph(net):
    _, _, model, _, _ = net
    assert verify_model(model, check_values=True) == []


def _miswired(model, kind):
    layers = list(model.layers)
    i = next(j for j, l in enumerate(layers) if l.add is not None
             and not np.array_equal(l.conv.perm, np.arange(l.conv.cout)))
    if kind == "wrong_src":              # conv3 reads its own shortcut
        layers[i] = dataclasses.replace(layers[i], src=layers[i].add)
    elif kind == "later_src":
        layers[i] = dataclasses.replace(layers[i], src=i + 1)
    elif kind == "add_permutation":     # the add's maps in two orders
        conv = layers[i].conv
        layers[i] = dataclasses.replace(layers[i], conv=dataclasses.replace(
            conv, perm=conv.perm[::-1].copy()))
    elif kind == "add_shape":           # a shortcut of another side
        layers[i] = dataclasses.replace(layers[i], add=0)
    return dataclasses.replace(model, layers=layers, _fwd_cache={})


@pytest.mark.parametrize("kind,rule", [("wrong_src", "CH-GEOM"),
                                       ("later_src", "CH-WIRING"),
                                       ("add_permutation", "CH-ADD"),
                                       ("add_shape", "CH-ADD")])
def test_verify_model_rejects_a_miswired_copy(net, kind, rule):
    _, _, model, _, _ = net
    bad = _miswired(model, kind)
    assert rule in _errors(verify_model(bad, check_values=False))


def test_strict_graph_packing_verifies():
    cfg = config_of(BLOCKS["one_block"])
    layers = cfg["layers"]
    convs = build_sparse_graph(dense_filters(cfg),
                               [l["src"] for l in layers],
                               [l["add"] for l in layers], density=0.421,
                               strict=True, device=CPU)
    assert len(convs) == len(layers)


# ---------------------------------------------------------------------------
# what walks a chain refuses a graph; chains are as before
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("walker", ["autotune_model", "require_chain"])
def test_chain_walks_raise_on_a_graph(net, walker):
    _, _, model, _, _ = net
    with pytest.raises(ValueError, match="is a graph"):
        if walker == "autotune_model":
            autotune_model(model, SIZE)
        else:
            VM.require_chain(model, "a walk")


@pytest.mark.parametrize("pattern", ["unstructured", "chunk"])
@pytest.mark.parametrize("balance", [True, False])
def test_graph_packing_of_a_chain_is_the_chain_packing(pattern, balance):
    """A graph whose every layer names the layer before as its source (as
    a configuration's ``src`` does) packs as the chain."""
    rng = np.random.default_rng(3)
    shapes = [(3, 3, 3, 128), (3, 3, 128, 128), (1, 1, 128, 256),
              (3, 3, 256, 128)]
    ws = [rng.normal(size=s).astype(np.float32) for s in shapes]
    kw = dict(density=0.334, pattern=pattern, balance_filters=balance,
              device=CPU)
    chain = build_sparse_chain(ws, **kw)
    graph = build_sparse_graph(ws, [-1, 0, 1, 2], [None] * 4, **kw)
    for a, b in zip(chain, graph):
        assert np.array_equal(a.w_dense, b.w_dense)
        assert np.array_equal(a.perm, b.perm)
        assert torch.equal(a.packed.vals, b.packed.vals)
        assert np.array_equal(a.packed.host_indices(), b.packed.host_indices())
        assert (a.layout, a.pattern) == (b.layout, b.pattern)


def test_a_chain_model_is_a_chain():
    m = VM.build_vision_model("VGGNet", num_layers=3, density=0.334,
                              device=CPU)
    assert VM.is_chain(m)
    assert all((l.src, l.add, l.relu) == (None, None, True)
               for l in m.layers)
    x = images(2)[:, :16, :16]
    out, _ = VM.forward(m, x)
    # the chain's walk, layer by layer, as before the wiring existed
    y = x
    for layer in m.layers:
        c = layer.conv
        y, _ = sparse_conv2d_nhwc(y, c.packed, c.kh, c.kw, c.cout,
                                  stride=layer.stride, padding=layer.padding,
                                  layout=c.layout, wl_cache=c.wl_cache)
        if layer.pool_after is not None:
            y = VM.max_pool(y, *layer.pool_after)
    assert torch.equal(out, y)


def test_the_cluster_balance_pass_packs_a_chain_only():
    cfg = config_of(BLOCKS["one_block"])
    layers = cfg["layers"]
    with pytest.raises(ValueError, match="packs a chain"):
        build_sparse_graph(dense_filters(cfg), [l["src"] for l in layers],
                           [l["add"] for l in layers], mesh_devices=2,
                           device=CPU)


def test_build_rejects_wiring_to_a_later_layer():
    cfg = config_of(BLOCKS["one_block"])
    layers = [dict(l) for l in cfg["layers"]]
    layers[1]["src"] = 2
    with pytest.raises(ValueError, match="earlier layers"):
        build_sparse_graph(dense_filters(cfg), [l["src"] for l in layers],
                           [l["add"] for l in layers], device=CPU)


@pytest.mark.parametrize("kind", ["chain", "graph"])
def test_walk_maps_drops_a_map_after_its_last_conv_before_the_pool(kind):
    """A map lives until the conv of its last reader has run and no
    longer: it is gone when that layer's pool runs, as a loop over a
    chain's layers would have let it go."""
    import types
    import weakref
    if kind == "chain":
        wiring = [(None, None, (2, 2)), (None, None, (2, 2)),
                  (None, None, None)]
    else:                         # layer 2 adds layer 0's map, then pools
        wiring = [(-1, None, None), (0, None, None), (1, 0, (2, 2)),
                  (2, None, None)]
    layers = [types.SimpleNamespace(src=s, add=a, pool_after=p)
              for s, a, p in wiring]
    model = types.SimpleNamespace(layers=layers)
    image = torch.zeros(2)        # the caller holds the image
    read = {}                     # layer -> weakrefs of the maps it read
    pooled = []

    def conv(i, layer, inp, shortcut):
        read[i] = [weakref.ref(t) for t in (inp, shortcut)
                   if t is not None and t is not image]
        return inp + 1

    def pool(y, window, stride):
        i = max(read)             # every map it read, it read last
        assert all(r() is None for r in read[i]), i
        pooled.append(i)
        return y * 1

    out = VM.walk_maps(model, image, conv, pool)
    assert pooled == ([0, 1] if kind == "chain" else [2])
    assert out.tolist() == ([3.0, 3.0] if kind == "chain" else [4.0, 4.0])
