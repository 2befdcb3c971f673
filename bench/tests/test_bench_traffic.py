"""The one traffic generator: deterministic per seed, and the mixes'
shapes."""
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from bench import arrivals

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def test_sides_of_a_list():
    assert arrivals.sides_of({"sides": [224]}) == [224]
    assert arrivals.sides_of({"sides": [112, 224]}) == [112, 224]


def test_closed_loop_draws_are_deterministic_and_block_free():
    tr = {"loop": "closed", "sides": [224], "pool": 256, "queue_depth": 64}
    a = list(itertools.islice(arrivals.closed_requests(tr, 3), 10000))
    b = list(itertools.islice(arrivals.closed_requests(tr, 3), 10000))
    c = list(itertools.islice(arrivals.closed_requests(tr, 4), 10000))
    assert a == b and a != c
    assert {s for _, s in a} == {224}
    idx = np.array([i for i, _ in a])
    assert idx.min() == 0 and idx.max() == 255


@pytest.mark.parametrize("path", sorted(TRAFFIC.glob("*.json")),
                         ids=lambda p: p.stem)
def test_the_committed_mixes_load(path):
    mix = json.loads(path.read_text())
    assert mix["loop"] == "closed"
    assert arrivals.sides_of(mix)
    assert next(arrivals.closed_requests(mix, 0))
