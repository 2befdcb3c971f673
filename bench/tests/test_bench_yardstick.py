"""The yardstick: two-sided MACs against a brute-force count, bytes from
shapes, and the bound a forward is held to."""
import itertools

import numpy as np
import pytest
import torch

from bench.inputs import make_inputs
from bench.reference import chain, counts
from conftest import tiny_config


def brute_force_macs(config, filters, x):
    """Per image and layer: every (output pixel, output channel, tap,
    input channel) whose activation and filter value are both non-zero,
    counted one by one, with the reference's activations."""
    acts = []
    y = torch.as_tensor(x)
    for i in range(len(config["layers"])):
        acts.append(y.numpy())
        sub = dict(config, layers=config["layers"][i:i + 1])
        y = chain.forward(sub, chain.device_filters([filters[i]], "cpu"),
                          y)
    out = np.zeros((x.shape[0], len(config["layers"])), np.int64)
    for li, (l, w, a) in enumerate(zip(config["layers"], filters, acts)):
        k, s = l["k"], l["stride"]
        ph = chain.same_pads(a.shape[1], k, s)
        pw = chain.same_pads(a.shape[2], k, s)
        ap = np.pad(a, ((0, 0), ph, pw, (0, 0)))
        oh = (ap.shape[1] - k) // s + 1
        ow = (ap.shape[2] - k) // s + 1
        for b, r, c, i, j in itertools.product(
                range(a.shape[0]), range(oh), range(ow), range(k), range(k)):
            live_x = ap[b, r * s + i, c * s + j] != 0          # [cin]
            live_w = w[i, j] != 0                               # [cin, cout]
            out[b, li] += int((live_x[:, None] & live_w).sum())
    return out


@pytest.mark.parametrize("pattern", ["unstructured", "chunk"])
def test_two_sided_macs_equal_a_brute_force_count(pattern):
    cfg = tiny_config(pattern)
    filters, pool = make_inputs(cfg, 2, 16, 9, "cpu")
    pruned = chain.prune_filters(cfg, [f.numpy() for f in filters])
    per_layer = []
    chain.forward(cfg, chain.device_filters(pruned, "cpu"), pool,
                masks_out=per_layer)
    got = torch.stack(per_layer, 1).numpy()
    want = brute_force_macs(cfg, pruned, pool.numpy())
    np.testing.assert_array_equal(got, want)
    # zeros on both sides are skipped: fewer than the one-sided count
    sides = chain.output_sides(cfg, 16)
    dense = sum(oh * oh * l["k"] ** 2 * l["cin"] * l["cout"]
                for l, (_, oh) in zip(cfg["layers"], sides))
    assert 0 < got.sum(1).max() < dense


def test_map_and_filter_bytes_from_shapes():
    cfg = tiny_config()
    # 16 -> 8 (stem, stride 2) -> pool 4 -> 4 -> 4 -> pool 2 -> 2
    want = (16 * 16 * 3 + 8 * 8 * 16) + (4 * 4 * 16 + 4 * 4 * 32) \
        + (4 * 4 * 32 + 4 * 4 * 32) + (2 * 2 * 32 + 2 * 2 * 16)
    assert chain.map_bytes(cfg, 16) == 4 * want
    w = [np.array([[0.0, 1.0], [2.0, 0.0]], np.float32)]
    assert counts.filter_bytes(w) == 8


def test_forward_bound_takes_the_larger_side():
    cfg = tiny_config()
    peaks = {"float32_flops": 1e12, "hbm_bytes_per_s": 1e9}
    per_img = chain.map_bytes(cfg, 16)
    # bytes-bound: 2 images, few MACs
    got = counts.forward_bound_s(10, 2, per_img, 400, peaks)
    assert got == pytest.approx((2 * per_img + 400) / 1e9)
    # compute-bound: many MACs
    got = counts.forward_bound_s(10**12, 2, per_img, 400, peaks)
    assert got == pytest.approx(2.0)


def test_peaks_by_card_name():
    assert counts.peaks_for("NVIDIA H100 80GB HBM3")["float32_flops"] == 67e12
    with pytest.raises(KeyError):
        counts.peaks_for("cpu")
