"""The one general traffic generator: it reads a traffic mix's data file
(``bench/traffic/<mix>.json``) and draws the requests from the seed.

A mix gives:

* ``loop``: ``"closed"``, a batch job: the queue is kept at least
  ``queue_depth`` requests deep;
* ``sides``: the list of square image sides;
* ``pool``: how many distinct images the requests draw from.

The seed picks which pool image (and side) each request shows.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

# the closed loop draws its images in blocks of this many, so its sequence
# does not depend on how far a run gets
_CLOSED_BLOCK = 4096


def sides_of(traffic: Dict) -> List[int]:
    return [int(s) for s in traffic["sides"]]


def stream(seed: int, which: int) -> np.random.Generator:
    """The numpy generator of stream ``which`` of a seed (any integer)."""
    return np.random.default_rng([int(seed) & (2**63 - 1), which])


def closed_requests(traffic: Dict, seed: int) -> Iterator[Tuple[int, int]]:
    """Endless (pool image, side) draws of a closed loop."""
    rng = stream(seed, 1)
    sides = np.asarray(sides_of(traffic))
    pool = int(traffic["pool"])
    while True:
        idx = rng.integers(0, pool, _CLOSED_BLOCK)
        side = sides[rng.integers(0, sides.size, _CLOSED_BLOCK)]
        yield from zip(idx.tolist(), side.tolist())
