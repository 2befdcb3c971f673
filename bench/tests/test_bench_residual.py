"""The residual topology's files: the plain reference's counts (two-sided
MACs per conv, map bytes with the shortcuts' reads) against hand counts on
a tiny net, its forward against a loop of ``F.conv2d`` written out here,
its TF32 control failing the cell's limit on ResNet-50's first blocks, the
committed configuration being Table 1's 50-layer column in v1.5 form,
``load_cell`` resolving the new cell to ``residual`` for both modules, and
the fused-add reader reading only the launches that add a shortcut."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench import harness
from bench.reference import residual as R
from test_bench_metrics import K1, closed_record, metric, trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "resnet50_residual.offline_b32"
K1_RES = "void (anonymous namespace)::tile_kernel_residual<float, 8, 128>"


def tiny_net():
    """Stem (3 -> 4, 3x3 stride 2, pad 1, pool 3/2/1) on 8 px, then one
    block with a projection: 1x1 4 -> 2, 3x3 2 -> 2, projection 1x1 4 -> 8
    without ReLU, 1x1 2 -> 8 adding it."""
    def conv(k, cin, cout, stride, src, add=None, relu=True, pool=None):
        p = (k - 1) // 2
        return {"k": k, "cin": cin, "cout": cout, "stride": stride,
                "padding": [[p, p], [p, p]], "src": src, "add": add,
                "relu": relu, "pool_after": pool}
    return {"density": 1.0, "pattern": "unstructured",
            "pack": {"micro_ranges": 3},
            "layers": [conv(3, 3, 4, 2, -1, pool=[3, 2, 1]),
                       conv(1, 4, 2, 1, 0), conv(3, 2, 2, 1, 1),
                       conv(1, 4, 8, 1, 0, relu=False),
                       conv(1, 2, 8, 1, 2, add=3)]}


def test_map_bytes_by_hand():
    # 8 px -> stem 4 px -> pool 2 px; the block runs at 2 px
    cfg = tiny_net()
    want = (8 * 8 * 3 + 4 * 4 * 4          # stem: image in, its output
            + 2 * 2 * 4 + 2 * 2 * 2        # conv1
            + 2 * 2 * 2 + 2 * 2 * 2        # conv2
            + 2 * 2 * 4 + 2 * 2 * 8        # projection
            + 2 * 2 * 2 + 2 * 2 * 8        # conv3
            + 2 * 2 * 8)                   # conv3's add reads the shortcut
    assert R.map_bytes(cfg, 8) == want * 4
    assert [s["out"] for s in R.output_sides(cfg, 8)] == [2, 2, 2, 2, 2]


def test_masks_out_by_hand():
    """All-ones images and filters: every product has both operands
    non-zero where the window lies inside the map."""
    cfg = tiny_net()
    filters = [torch.ones(l["cout"], l["cin"], l["k"], l["k"])
               for l in cfg["layers"]]
    x = torch.ones(2, 8, 8, 3)
    masks = []
    R.forward(cfg, filters, x, masks_out=masks)
    # the stem's 4x4 outputs at stride 2, pad 1: taps inside the 8x8 map
    rows = [sum(0 <= 2 * o + d - 1 < 8 for d in range(3)) for o in range(4)]
    stem = sum(a * b for a in rows for b in rows) * 3 * 4
    # conv2 (3x3, pad 1) on 2x2: each output sees the 2x2 map, 4 taps
    want = [stem, 2 * 2 * 4 * 2, 2 * 2 * 4 * 2 * 2, 2 * 2 * 4 * 8,
            2 * 2 * 2 * 8]
    assert [m.tolist() for m in masks] == [[w, w] for w in want]


def test_forward_is_the_written_out_net():
    cfg = tiny_net()
    g = torch.Generator().manual_seed(5)
    filters = [torch.randn(l["cout"], l["cin"], l["k"], l["k"], generator=g)
               for l in cfg["layers"]]
    x = torch.randn(2, 8, 8, 3, generator=g).abs()
    f = filters
    y0 = F.max_pool2d(torch.relu(F.conv2d(x.permute(0, 3, 1, 2), f[0],
                                          stride=2, padding=1)), 3, 2, 1)
    y1 = torch.relu(F.conv2d(y0, f[1]))
    y2 = torch.relu(F.conv2d(y1, f[2], padding=1))
    y3 = F.conv2d(y0, f[3])
    y4 = torch.relu(F.conv2d(y2, f[4]) + y3)
    assert torch.allclose(R.forward(cfg, filters, x),
                          y4.permute(0, 2, 3, 1), rtol=0, atol=1e-6)


def test_the_config_is_resnet50_v1_5():
    cfg = json.loads((ROOT / "bench/configs/resnet50_residual.json")
                     .read_text())
    assert cfg["topology"] == "residual"
    assert cfg["layers"] == R.bottleneck_layers()
    layers = cfg["layers"]
    assert len(layers) == 53
    assert sum(l["add"] is not None for l in layers) == 16
    assert sum(not l["relu"] for l in layers) == 4
    strided_3x3 = [l for l in layers if l["k"] == 3 and l["stride"] == 2]
    assert len(strided_3x3) == 3           # v1.5: the stride on the 3x3
    sides = R.output_sides(cfg, 224)
    assert sides[0]["out"] == 56 and sides[-1]["out"] == 7
    macs = sum(s["oh"] ** 2 * l["k"] ** 2 * l["cin"] * l["cout"]
               for l, s in zip(layers, sides))
    assert macs == 4087136256
    assert R.map_bytes(cfg, 224) == 109182976


def test_load_cell_resolves_the_residual_modules():
    cell = harness.load_cell(CELL)
    assert Path(cell.program.__file__) == ROOT / "bench/programs/residual.py"
    assert Path(cell.reference.__file__) == \
        ROOT / "bench/reference/residual.py"
    assert cell.config["topology"] == "residual"
    names = [m["name"] for m in cell.per_layer]
    assert "residual_ms_per_step.offline" in names
    assert "k1_roofline.offline" in names
    other = harness.load_cell("resnet50.offline_b32")
    assert "residual_ms_per_step.offline" not in \
        [m["name"] for m in other.per_layer]


def test_tf32_control_fails_the_limit_on_the_first_blocks():
    """The cell's comparison would refuse answers computed one precision
    lower: the stem and stage 2's three blocks at 224 px, 2 images."""
    cfg = json.loads((ROOT / "bench/configs/resnet50_residual.json")
                     .read_text())
    cfg["layers"] = cfg["layers"][:11]
    limit = json.loads((ROOT / f"bench/workloads/{CELL}.json")
                       .read_text())["limits"]["max_rel_err"]
    rng = np.random.default_rng(11)
    dense = [(rng.normal(size=(l["k"], l["k"], l["cin"], l["cout"]))
              * np.sqrt(2.0 / (l["k"] ** 2 * l["cin"]))).astype(np.float32)
             for l in cfg["layers"]]
    filters = R.device_filters(R.prune_filters(cfg, dense), "cpu")
    x = torch.as_tensor(np.abs(rng.normal(size=(2, 224, 224, 3))),
                        dtype=torch.float32)
    ref = R.forward(cfg, filters, x)
    low = R.forward(cfg, filters, x, "tf32")
    assert max(harness.rel_err(a, b) for a, b in zip(low, ref)) > limit


def test_residual_reader_reads_only_the_fused_launches():
    read = metric("residual_ms_per_step.offline")
    # a chain cell's trace: K1 without the add
    assert read(closed_record(trace=trace())) is None
    assert read(closed_record()) is None
    t = trace()
    t.device.append((K1_RES, 8.0, 8.5))
    got = read(closed_record(trace=t))
    assert got == pytest.approx(0.5 / 2 * 1e3)
    # the fused launches are K1's: the other readers count them as K1
    assert K1 in dict(t.device_ops())
    assert metric("im2col_share.offline")(closed_record(trace=t)) == \
        pytest.approx(100 * 2.0 / t.busy_s)
