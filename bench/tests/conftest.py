"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
root of the repo (the repo's test run does not collect them). Card-only
tests carry the ``gpu`` marker and skip inside a fixture without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def layer(k, cin, cout, stride=1, pool=None, padding="SAME"):
    return {"k": k, "cin": cin, "cout": cout, "stride": stride,
            "padding": padding, "pool_after": pool}


def tiny_config(pattern="unstructured", density=0.4):
    """A four-layer chain at 16 px with every kind of step the cells have:
    a 3-channel stem at stride 2, 3x3 and (unstructured) 1x1 layers and
    pools. Under the chunk pattern every layer has nine tiles or more, so
    none is pruned away."""
    return {"name": "tiny", "arch": "VGGNet", "input_size": 16,
            "precision": "float32", "pattern": pattern, "density": density,
            "pack": {"num_shards": 16, "balance_filters": True,
                     "micro_ranges": 3},
            "layers": [layer(3, 3, 16, stride=2, pool=[2, 2]),
                       layer(3, 16, 32), layer(3, 32, 32, pool=[2, 2]),
                       layer(1 if pattern == "unstructured" else 3, 32, 16)]}


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
