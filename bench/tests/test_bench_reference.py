"""The plain reference: its chain against a direct numpy convolution, its
frozen pruning rule against the port's packing, and the control (TF32 in
the program's place) failing the cells' check at a small size."""
import numpy as np
import pytest
import torch

from bench import harness
from bench.inputs import make_inputs
from bench.reference import chain
from conftest import layer, tiny_config


def numpy_chain(config, filters, x):
    """Direct convolution, ReLU and max-pool in float64 numpy."""
    y = x.astype(np.float64)
    for l, w in zip(config["layers"], filters):
        k, s = l["k"], l["stride"]
        b, h, wd, c = y.shape
        if l["padding"] == "SAME":
            ph, pw = chain.same_pads(h, k, s), chain.same_pads(wd, k, s)
        else:
            ph = pw = (0, 0)
        yp = np.pad(y, ((0, 0), ph, pw, (0, 0)))
        oh = (yp.shape[1] - k) // s + 1
        ow = (yp.shape[2] - k) // s + 1
        out = np.zeros((b, oh, ow, w.shape[3]))
        for i in range(k):
            for j in range(k):
                patch = yp[:, i:i + s * oh:s, j:j + s * ow:s, :]
                out += np.einsum("bhwc,cn->bhwn", patch, w[i, j])
        y = np.maximum(out, 0.0)
        pool = l.get("pool_after")
        if pool and min(y.shape[1], y.shape[2]) >= pool[0]:
            pk, ps = pool
            ph_ = (y.shape[1] - pk) // ps + 1
            pw_ = (y.shape[2] - pk) // ps + 1
            y = np.max(np.stack([y[:, a:a + ps * ph_:ps, c:c + ps * pw_:ps]
                                 for a in range(pk) for c in range(pk)]), 0)
    return y


@pytest.mark.parametrize("size", [16, 13])
def test_reference_matches_numpy_chain(size):
    cfg = tiny_config()
    cfg["layers"][0]["padding"] = "VALID" if size == 13 else "SAME"
    filters, pool = make_inputs(cfg, 3, size, 11, "cpu")
    pruned = chain.prune_filters(cfg, [f.numpy() for f in filters])
    ref = chain.forward(cfg, chain.device_filters(pruned, "cpu"), pool)
    want = numpy_chain(cfg, pruned, pool.numpy())
    assert ref.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=1e-5)


def test_output_sides_follow_the_chain():
    cfg = tiny_config()
    filters, pool = make_inputs(cfg, 1, 16, 0, "cpu")
    ref = chain.forward(cfg, chain.device_filters(
        [f.numpy() for f in filters], "cpu"), pool)
    sides = chain.output_sides(cfg, 16)
    assert sides[0] == (16, 8)
    # the last layer keeps its input side (1x1, no pool after it)
    assert ref.shape[1] == sides[-1][1]


@pytest.mark.parametrize("pattern", ["unstructured", "chunk"])
def test_reference_pruning_equals_the_ports(pattern):
    """The port packs the same dense filters; with its balance
    permutations undone its pruned filters are the reference's."""
    from repro_torch.sparsity.conv import build_sparse_chain
    cfg = tiny_config(pattern)
    cfg["layers"].insert(3, layer(3, 32, 64))
    cfg["layers"][4]["cin"] = 64            # a balance permutation to fold
    filters, _ = make_inputs(cfg, 1, 16, 3, "cpu")
    dense = [f.numpy() for f in filters]
    pruned = chain.prune_filters(cfg, dense)
    packed = build_sparse_chain(dense, density=cfg["density"],
                                pattern=pattern, device="cpu")
    prev = np.arange(dense[0].shape[2])
    for w_ref, conv in zip(pruned, packed):
        want = w_ref[:, :, prev, :][..., conv.perm]
        np.testing.assert_array_equal(conv.w_dense, want)
        assert (w_ref != 0).any()
        prev = conv.perm
    assert (packed[-1].perm == np.arange(packed[-1].cout)).all()


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -2.5 - 2**-20])
    got = chain.to_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -2.5]


@pytest.mark.parametrize("pattern", ["unstructured", "chunk"])
def test_control_fails_the_check(pattern):
    """The control, the reference at TF32 in the program's place, reads
    far above a sound answer and fails the cells' limit."""
    cfg = tiny_config(pattern)
    filters, pool = make_inputs(cfg, 8, 16, 5, "cpu")
    pruned = chain.prune_filters(cfg, [f.numpy() for f in filters])
    ref = chain.device_filters(pruned, "cpu")
    items = [(i, i, 16) for i in range(8)]
    control = harness.reference_outputs(chain, cfg, ref, pool, items, 16,
                                        "tf32")
    samples = {16: [it + (o.numpy(),) for it, o in zip(items, control)]}
    checks = harness.check(chain, cfg, ref, pool, samples, 0,
                           {"max_rel_err": 1e-4})
    assert checks["max_rel_err"]["value"] > 1e-4
    assert not harness.is_correct(checks)
