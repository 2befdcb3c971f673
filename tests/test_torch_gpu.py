"""Card-only checks of the two CUDA kernels against their plain versions,
and of the port's bitwise invariants on the card. Every test is marked
``gpu`` and skips (through the ``cuda`` fixture) where there is no card.
This file imports neither JAX nor the reference, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.bitmask import block_sparsify
from repro_torch.kernels.sparse_conv import (CONV_GRID, sparse_conv_spmm,
                                             sparse_conv_spmm_plain)
from repro_torch.kernels.worklist_core import (WALK, build_worklist,
                                               worklist_spmm,
                                               worklist_spmm_plain)
from repro_torch.vision import (VisionEngine, ImageRequest,
                                build_vision_model, compile_forward,
                                oracle_check)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(rng, dev, M=512, K=576, N=128, bk=64, bn=64, keep=0.4):
    w = rng.normal(size=(K, N)).astype(np.float32)
    tiles = rng.random((K // bk, N // bn)) < keep
    w *= np.repeat(np.repeat(tiles, bk, 0), bn, 1)
    x = np.abs(rng.normal(size=(M, K))).astype(np.float32)
    x[rng.random(x.shape) < 0.5] = 0
    x[:72] = 0                                  # dead sub-blocks and a slice
    return torch.as_tensor(x, device=dev), block_sparsify(w, bk, bn,
                                                          device=dev)


@pytest.mark.parametrize("bk,bn", [(32, 64), (64, 64), (128, 128), (96, 96)])
@pytest.mark.parametrize("act", [None, "relu"])
def test_walker_matches_plain(rng, cuda, bk, bn, act):
    x, w = _operands(rng, cuda, K=6 * bk, N=3 * bn, bk=bk, bn=bn)
    wl = build_worklist(w.host_indices(), x.shape[0] // 128)
    before = WALK.launches
    out, occ = worklist_spmm(x, w.vals, wl, bk=bk, bn=bn, sub_m=8, act=act,
                             emit_occupancy=True)
    assert WALK.launches == before + 1
    pout, pocc = worklist_spmm_plain(x, w.vals, wl, bk=bk, bn=bn,
                                     bm_rows=128, sub_m=8, act=act,
                                     emit_occupancy=True)
    torch.cuda.synchronize()
    rel = float((out - pout).abs().max() / pout.abs().max())
    assert rel <= 1e-5
    assert torch.equal(occ, pocc)


def test_walker_batched_equals_per_image_bitwise(rng, cuda):
    x, w = _operands(rng, cuda, M=4 * 256)
    whole = worklist_spmm(x, w.vals, build_worklist(w.host_indices(), 8),
                          bk=64, bn=64, act="relu")[0]
    wl1 = build_worklist(w.host_indices(), 2)
    parts = [worklist_spmm(x[i * 256:(i + 1) * 256].contiguous(), w.vals,
                           wl1, bk=64, bn=64, act="relu")[0]
             for i in range(4)]
    assert torch.equal(whole, torch.cat(parts))


@pytest.mark.parametrize("two_sided", [True, False])
@pytest.mark.parametrize("bk,bn", [(32, 64), (128, 128)])
def test_dense_grid_matches_plain(rng, cuda, two_sided, bk, bn):
    x, w = _operands(rng, cuda, K=6 * bk, N=3 * bn, bk=bk, bn=bn)
    before = CONV_GRID.launches
    out, occ, cnt = sparse_conv_spmm(x, w.indices, w.vals, bk=bk, bn=bn,
                                     sub_m=8, two_sided=two_sided,
                                     emit_occupancy=True, count_macs=True)
    assert CONV_GRID.launches == before + 1
    pout, pocc, pcnt = sparse_conv_spmm_plain(
        x, w.indices, w.vals, bk=bk, bn=bn, bm_rows=128, sub_m=8,
        two_sided=two_sided, fuse_relu=True, emit_occupancy=True,
        count_macs=True)
    torch.cuda.synchronize()
    assert float((out - pout).abs().max() / pout.abs().max()) <= 1e-5
    assert torch.equal(occ, pocc)
    assert torch.equal(cnt, pcnt)
    # same fp32 sum order as the walker: the two kernels agree bitwise
    wl = build_worklist(w.host_indices(), x.shape[0] // 128)
    assert torch.equal(out, worklist_spmm(x, w.vals, wl, bk=bk, bn=bn,
                                          act="relu")[0])


def test_vgg_head_oracle_and_engine_on_card(rng, cuda):
    model = build_vision_model("VGGNet", num_layers=3, pattern="chunk",
                               device=cuda)
    imgs = np.abs(rng.normal(size=(3, 32, 32, 3))).astype(np.float32)
    _, _, rel = oracle_check(model, torch.as_tensor(imgs[:1], device=cuda))
    assert rel <= 1e-5
    produced = VisionEngine(model, num_slots=2).run(
        [ImageRequest(i, imgs[i], arrival=i) for i in range(3)])
    solo = compile_forward(model)
    for i in range(3):
        one = solo(torch.as_tensor(imgs[i:i + 1], device=cuda))
        np.testing.assert_array_equal(produced[i], one[0].cpu().numpy())
