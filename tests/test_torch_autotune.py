"""Port parity, the per-layer tile autotuner: the reference's cases
(``tests/test_autotune.py``) on the port, held to the reference where they
meet. The candidates, every candidate's cost and counts (static and
occupancy mode), the tuning records of a VGG head and its tuned forward
(within 1e-5 of the reference's XLA executor) are equal; the port's tuned
forward is bitwise its default one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as rat
from repro.sparsity.conv import build_sparse_chain as r_chain
from repro.vision import model as rvm
from repro_torch.kernels import autotune as tat
from repro_torch.kernels.sparse_conv import conv_out_size, sparse_conv2d_nhwc
from repro_torch.kernels.worklist_core import build_worklist, schedule_stats
from repro_torch.sparsity.conv import build_sparse_chain as t_chain
from repro_torch.vision import build_vision_model, compile_forward, forward

CPU = torch.device("cpu")


def _weights(rng):
    return [rng.normal(size=(3, 3, 3, 64)).astype(np.float32) * 0.1,
            rng.normal(size=(3, 3, 64, 64)).astype(np.float32) * 0.1]


def _chains(rng, density=1 / 3):
    ws = _weights(rng)
    return (r_chain(ws, density=density, pattern="chunk"),
            t_chain(ws, density=density, pattern="chunk", device=CPU))


def _models(layers=2):
    kw = dict(density=1 / 3, num_layers=layers, pattern="chunk", seed=0)
    return rvm.build_vision_model("VGGNet", **kw), \
        build_vision_model("VGGNet", device=CPU, **kw)


def _cfg(c):
    return (c.bm_rows, c.bn, c.sub_m, c.im2col)


# ---------------------------------------------------------------------------
# candidates and scores equal the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m_img", [144, 576, 3136])
def test_candidates_and_scores_equal_reference(rng, m_img):
    rc, tc = _chains(rng)
    for r, t in zip(rc, tc):
        rcands = rat.candidate_configs(r, m_img, batch=2)
        tcands = tat.candidate_configs(t, m_img, batch=2)
        assert [_cfg(c) for c in tcands] == [_cfg(c) for c in rcands]
        for rcfg, tcfg in zip(rcands, tcands):
            rcost, rcounts = rat.score_config(rcfg, r, m_img, batch=2)
            tcost, tcounts = tat.score_config(tcfg, t, m_img, batch=2)
            assert tcost == rcost and tcounts == rcounts, tcfg


def test_scores_equal_reference_in_occupancy_mode(rng):
    rc, tc = _chains(rng)
    r, t = rc[1], tc[1]
    kb = t.packed.shape[0] // t.packed.bk
    for cfg in tat.candidate_configs(t, 144):
        mb1 = -(-144 // cfg.bm_rows)
        occ = rng.random((mb1, kb)) < 0.6
        rcfg = rat.ConvTileConfig(*_cfg(cfg))
        assert tat.score_config(cfg, t, 144, batch=3, occ_blk=occ) == \
            rat.score_config(rcfg, r, 144, batch=3, occ_blk=occ)


def test_predicted_counts_match_worklist_for_every_candidate(rng):
    """The model's step counts are the counts of the work list the walker
    would run, for every candidate."""
    for conv in _chains(rng)[1]:
        m_img = 144
        for cfg in tat.candidate_configs(conv, m_img):
            _, counts = tat.score_config(cfg, conv, m_img)
            indices = tat._indices_at(conv, cfg.bn)
            m_pad = m_img + (-m_img) % cfg.bm_rows
            wl = build_worklist(indices, m_pad // cfg.bm_rows)
            assert counts["live_chunk_steps"] == wl.mac_steps, cfg
            assert counts["dead_pairs"] == wl.flush_only_steps, cfg
            assert counts["scheduled_steps"] == wl.num_steps, cfg
            assert counts["dense_grid_steps"] == wl.dense_grid_steps, cfg


def test_static_and_occupancy_stats_modes_equal_patch_mode(rng):
    conv = _chains(rng)[1][1]
    indices = torch.as_tensor(conv.packed.host_indices())
    bk = conv.packed.bk
    ones = torch.ones((3 * 64, conv.packed.shape[0]))
    a = schedule_stats(ones, indices, bk=bk, bm_rows=64)
    b = schedule_stats(None, indices, bk=bk, bm_rows=64, mb=3)
    assert {k: int(v) for k, v in a.items()} == \
        {k: int(v) for k, v in b.items()}
    patches = np.zeros((4 * 32, conv.packed.shape[0]), np.float32)
    patches[:32] = rng.normal(size=(32, patches.shape[1]))
    patches[64:96, :bk] = 1.0
    kb = patches.shape[1] // bk
    occ = (patches.reshape(4, 32, kb, bk) != 0).any(axis=(1, 3))
    a = schedule_stats(torch.as_tensor(patches), indices, bk=bk, bm_rows=32)
    b = schedule_stats(None, indices, bk=bk, bm_rows=32, occ=occ)
    assert {k: int(v) for k, v in a.items()} == \
        {k: int(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# determinism, caching, repacking
# ---------------------------------------------------------------------------
def test_tuner_deterministic_and_cached(rng):
    conv = _chains(rng)[1][1]
    rec1 = tat.autotune_conv(conv, 144)
    assert conv.tuned is rec1
    rec2 = tat.autotune_conv(conv, 144)
    assert rec1.config == rec2.config and rec1.cost == rec2.cost
    assert rec1.counts == rec2.counts
    assert [(c, s) for c, s, _ in rec1.table] == \
        [(c, s) for c, s, _ in rec2.table]
    assert rec1.as_dict()["candidates"] == len(rec1.table)


def test_tuner_repacks_on_bn_win_and_clears_wl_cache(rng):
    conv = _chains(rng)[1][1]
    conv.wl_cache[999] = "stale"
    narrow = tat.ConvTileConfig(bm_rows=128, bn=32, sub_m=8, im2col="taps")
    rec = tat.autotune_conv(conv, 144, candidates=[narrow])
    assert rec.config is narrow
    assert conv.packed.bn == 32 and conv.packed.vals.device == CPU
    assert conv.wl_cache == {}
    packed = conv.packed
    tat.autotune_conv(conv, 144,
                      candidates=[tat.ConvTileConfig(bn=32, im2col="taps")])
    assert conv.packed is packed


def test_autotune_model_records_equal_reference_on_vgg_head():
    """autotune_model tunes every layer at its true patch-row count and
    picks what the reference picks, with its costs and counts."""
    rm, tm = _models(3)
    fn_before = compile_forward(tm)
    rrecs = rat.autotune_model(rm, 24, batch=2)
    trecs = tat.autotune_model(tm, 24, batch=2)
    assert set(trecs) == set(rrecs) == {0, 1, 2}
    H = W = 24
    for i, layer in enumerate(tm.layers):
        r, t = rrecs[i], trecs[i]
        assert _cfg(t.config) == _cfg(r.config)
        assert t.cost == r.cost and t.counts == r.counts
        assert [(_cfg(c), s) for c, s, _ in t.table] == \
            [(_cfg(c), s) for c, s, _ in r.table]
        assert layer.conv.tuned is t
        oh, ow = conv_out_size(H, W, layer.conv.kh, layer.conv.kw,
                               layer.stride, layer.padding)
        assert t.m_img == oh * ow
        H, W = oh, ow
        if layer.pool_after is not None and min(H, W) >= layer.pool_after[0]:
            win, st = layer.pool_after
            H, W = (H - win) // st + 1, (W - win) // st + 1
        np.testing.assert_array_equal(layer.conv.packed.host_indices(),
                                      rm.layers[i].conv.packed.host_indices())
    assert tm._fwd_cache == {}
    assert compile_forward(tm, use_tuned=True) is not fn_before


def test_compile_forward_cache_keys_on_tuned_configs():
    _, model = _models(2)
    tat.autotune_model(model, 24)
    fn1 = compile_forward(model, use_tuned=True)
    assert compile_forward(model, use_tuned=True) is fn1
    tat.autotune_conv(model.layers[1].conv, 576, candidates=[
        tat.ConvTileConfig(bm_rows=64, im2col="taps")])
    fn2 = compile_forward(model, use_tuned=True)
    assert fn2 is not fn1
    assert compile_forward(model) is not fn2        # untuned: its own key


# ---------------------------------------------------------------------------
# bitwise safety of tuned configs, and the reference's numbers
# ---------------------------------------------------------------------------
def test_tuned_layer_output_bitwise_equals_default(rng):
    chain = _chains(rng)[1]
    x = np.abs(rng.normal(size=(1, 12, 12, 3))).astype(np.float32)
    h = torch.as_tensor(x)
    for conv in chain:
        default, _ = sparse_conv2d_nhwc(h, conv.packed, conv.kh, conv.kw,
                                        conv.cout, layout=conv.layout)
        cfg = tat.autotune_conv(conv, h.shape[1] * h.shape[2]).config
        tuned, _ = sparse_conv2d_nhwc(
            h, conv.packed, conv.kh, conv.kw, conv.cout, sub_m=cfg.sub_m,
            bm_rows=cfg.bm_rows, im2col=cfg.im2col, layout=conv.layout)
        assert torch.equal(tuned, default)
        h = default


def test_tuned_whole_net_bitwise_default_and_matches_reference(rng):
    rm, tm = _models(3)
    x = np.abs(rng.normal(size=(2, 24, 24, 3))).astype(np.float32)
    x[rng.random(x.shape) >= 0.4] = 0.0
    xt = torch.as_tensor(x)
    default = compile_forward(tm)(xt)
    recs = tat.autotune_model(tm, 24, batch=2)
    rat.autotune_model(rm, 24, batch=2)
    assert any(r.config.im2col == "lazy" for r in recs.values())
    tuned = compile_forward(tm, use_tuned=True)(xt)
    assert torch.equal(tuned, default)
    eager, _ = forward(tm, xt, compiled=False)
    assert torch.equal(eager, default)
    ref = np.asarray(rvm.compile_forward(rm, executor="xla", use_tuned=True)(
        jnp.asarray(x)))
    rel = np.abs(tuned.numpy() - ref).max() / np.abs(ref).max()
    assert rel <= 1e-5, rel


def test_measured_mode_runs_and_records(rng):
    conv = _chains(rng)[1][1]
    x = torch.as_tensor(np.abs(rng.normal(size=(1, 12, 12, 64)))
                        .astype(np.float32))
    rec = tat.autotune_conv(conv, 144, measure=True, x=x)
    assert rec.measured and rec.cost > 0
    assert all(cost > 0 for _, cost, _ in rec.table)
    assert rec.counts["scheduled_steps"] >= rec.counts["live_chunk_steps"]
    with pytest.raises(ValueError, match="calibration"):
        tat.autotune_conv(conv, 144, measure=True)
    _, model = _models(2)
    xm = torch.as_tensor(np.abs(rng.normal(size=(1, 16, 16, 3)))
                         .astype(np.float32))
    recs = tat.autotune_model(model, 16, measure=True, x=xm)
    assert all(r.measured for r in recs.values())
