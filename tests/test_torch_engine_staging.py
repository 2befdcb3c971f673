"""``VisionEngine``'s staged batches on the CPU: the host stages the batch
step k+1 will admit into the second of two persistent host buffers while
step k's forward runs. A closed loop that keeps twice the slots queued (as
the benchmark's ``closed_224`` traffic does) finds every step after the
first staged; future arrivals and a short queue refilled between steps
miss and are assembled. In every case the forward's input is bitwise the
batch the engine assembled before it staged (zeros in free lanes), the
answers are bitwise the solo forward's, and admission, ``done_at`` and
``stats`` are those of the admission the engine had before (kept here as
the reference). The ``mesh=`` engine runs on two gloo CPU ranks in a
subprocess (``tests/torch_engine_staging_world.py``)."""
import os
import pickle
import subprocess
import sys
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.balance import round_robin_permutation
from repro_torch.vision import (ImageRequest, VisionEngine,
                                build_vision_model, compile_forward)

ROOT = Path(__file__).resolve().parents[1]
SIZE = 16
SLOTS = 4
WORLD_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def model():
    return build_vision_model("VGGNet", num_layers=2, pattern="chunk",
                              density=0.4, seed=0, device="cpu")


@pytest.fixture(scope="module")
def pool():
    rng = np.random.default_rng(7)
    imgs = np.abs(rng.normal(size=(12, SIZE, SIZE, 3))).astype(np.float32)
    imgs[rng.random(imgs.shape) >= 0.5] = 0.0
    return imgs


def _solo(model, img):
    return compile_forward(model)(torch.as_tensor(img[None]))[0].numpy()


class Recorded:
    """An engine whose forward records each input batch it is given (a
    copy) and the slot table it was given with."""

    def __init__(self, eng):
        self.eng = eng
        self.batches, self.slots = [], []
        fwd = eng._fwd

        def recording(x):
            self.batches.append(x.clone())
            self.slots.append(eng.slot_req.copy())
            return fwd(x)
        eng._fwd = recording


class LegacyAdmission:
    """The engine's admission before staging, as a model: each step takes
    the first queued requests arrived by its clock into the free slots,
    scanned in ``round_robin_permutation(num_slots, rr)`` order."""

    def __init__(self, num_slots):
        self.num_slots = num_slots
        self.queue = deque()
        self.rr = self.clock = 0
        self.done_at, self.slots = {}, []
        self.steps = self.images = self.active = self.idle_lanes = 0

    def step(self):
        slot_req = np.full(self.num_slots, -1, np.int64)
        for s in round_robin_permutation(self.num_slots, self.rr):
            req = next((r for r in self.queue if r.arrival <= self.clock),
                       None)
            if req is None:
                break
            self.queue.remove(req)
            slot_req[s] = req.rid
            self.rr += 1
        if (slot_req < 0).all():
            if self.queue:
                self.clock += 1
                return True
            return False
        self.slots.append(slot_req)
        for rid in slot_req[slot_req >= 0]:
            self.done_at[int(rid)] = self.clock
        n = int((slot_req >= 0).sum())
        self.steps += 1
        self.images += n
        self.active += n
        self.idle_lanes += self.num_slots - n
        self.clock += 1
        return True


class Req:
    """A request of the legacy model (``deque.remove`` compares rids)."""

    def __init__(self, rid, arrival):
        self.rid, self.arrival = rid, arrival

    def __eq__(self, other):
        return self.rid == other.rid


def _drive(model, pool, feed, *, compiled=True):
    """Run an engine and the legacy model side by side: before step i,
    ``feed(i, queued)`` gives the (rid, pool index, arrival) requests to
    submit, ``queued`` being the engine's queue length. Returns the
    recorded engine, the legacy model, the answers by rid (each taken from
    ``produced`` after its step, which is then cleared, as the benchmark's
    harness does) and the pool index by rid."""
    eng = VisionEngine(model, num_slots=SLOTS, compiled=compiled)
    rec = Recorded(eng)
    legacy = LegacyAdmission(SLOTS)
    answers, pool_of = {}, {}
    i = 0
    while True:
        for rid, idx, arrival in feed(i, len(eng.queue)):
            eng.submit(ImageRequest(rid, pool[idx], arrival=arrival))
            legacy.queue.append(Req(rid, arrival))
            pool_of[rid] = idx
        went, legacy_went = eng.step(), legacy.step()
        assert went == legacy_went
        if not went:
            break
        answers.update({r: a.copy() for r, a in eng.produced.items()})
        eng.produced.clear()
        i += 1
    return rec, legacy, answers, pool_of


def _check(model, pool, rec, legacy, answers, pool_of):
    """The engine against the legacy admission and the solo forward, and
    every forward input against the batch assembled from scratch."""
    eng = rec.eng
    st = eng.stats
    assert eng.done_at == legacy.done_at
    assert (st.engine_steps, st.images, st.active_lane_steps,
            st.idle_lane_steps) == (legacy.steps, legacy.images,
                                    legacy.active, legacy.idle_lanes)
    assert st.staged_hits + st.staged_misses == st.engine_steps
    assert eng.clock == legacy.clock
    # the warm-up's zero batch first, then one input a step
    assert len(rec.batches) == 1 + st.engine_steps
    assert not rec.batches[0].any()
    for x, slots, want in zip(rec.batches[1:], rec.slots[1:], legacy.slots):
        np.testing.assert_array_equal(slots, want)
        batch = np.zeros((eng.num_slots, SIZE, SIZE, 3), np.float32)
        for s in np.nonzero(slots >= 0)[0]:
            batch[s] = pool[pool_of[int(slots[s])]]
        assert np.array_equal(x.numpy(), batch)
    assert sorted(answers) == sorted(pool_of)
    for rid, got in answers.items():
        np.testing.assert_array_equal(got, _solo(model, pool[pool_of[rid]]))


def _closed(depth, steps, n_pool):
    """The benchmark harness's closed loop: the queue topped up to
    ``depth`` before each of ``steps`` steps, then drained."""
    rid = [0]

    def feed(i, queued):
        if i >= steps:
            return []
        out = []
        for _ in range(depth - queued):
            out.append((rid[0], (rid[0] * 5) % n_pool, 0))
            rid[0] += 1
        return out
    return feed


@pytest.mark.parametrize("compiled", [True, False])
def test_closed_loop_stages_every_step_after_the_first(model, pool,
                                                       compiled):
    rec, legacy, answers, pool_of = _drive(
        model, pool, _closed(2 * SLOTS, 6, len(pool)), compiled=compiled)
    _check(model, pool, rec, legacy, answers, pool_of)
    st = rec.eng.stats
    # six topped-up steps, then the SLOTS still queued drain in one
    assert st.engine_steps == 7
    assert (st.staged_misses, st.staged_hits) == (1, st.engine_steps - 1)


def test_future_arrivals_and_a_short_refilled_queue_miss(model, pool):
    # clock 0 admits rids 0-3 and stages rid 4 alone (rid 5 arrives at 2):
    # clock 1 admits just that, a hit, and stages rid 5; two more queued
    # before clock 2 make its batch 5, 6, 7, a miss; rid 8 arrives at 5,
    # after two ticks without a forward, and nothing was staged for it
    plan = {0: [(0, 0, 0), (1, 1, 0), (2, 2, 0), (3, 3, 0), (4, 4, 0),
                (5, 5, 2)],
            2: [(6, 6, 0), (7, 7, 0)],
            3: [(8, 8, 5)]}
    rec, legacy, answers, pool_of = _drive(
        model, pool, lambda i, queued: plan.get(i, []))
    _check(model, pool, rec, legacy, answers, pool_of)
    st = rec.eng.stats
    assert rec.eng.done_at == {0: 0, 1: 0, 2: 0, 3: 0, 4: 1, 5: 2, 6: 2,
                               7: 2, 8: 5}
    assert (st.engine_steps, st.staged_misses, st.staged_hits) == (4, 3, 1)


def test_a_partial_batch_after_full_ones_has_zero_free_lanes(model, pool):
    # 4 + 4 + 1: the third batch reuses the first's buffer, whose other
    # three lanes held images and must read zero again
    feed = {0: [(r, r, 0) for r in range(9)]}
    rec, legacy, answers, pool_of = _drive(
        model, pool, lambda i, queued: feed.get(i, []))
    _check(model, pool, rec, legacy, answers, pool_of)
    st = rec.eng.stats
    assert (st.engine_steps, st.staged_misses, st.staged_hits) == (3, 1, 2)
    last, slots = rec.batches[-1], rec.slots[-1]
    assert (slots >= 0).sum() == 1
    assert not last[torch.as_tensor(slots < 0)].any()
    # and a miss into a buffer with held lanes zeroes them too
    feed2 = {0: [(r, r, 0) for r in range(8)], 2: [(8, 8, 0)]}
    rec, legacy, answers, pool_of = _drive(
        model, pool, lambda i, queued: feed2.get(i, []))
    _check(model, pool, rec, legacy, answers, pool_of)
    assert (rec.eng.stats.staged_misses, rec.eng.stats.staged_hits) == (2, 1)


def test_an_answer_held_across_later_steps_is_unchanged(model, pool):
    eng = VisionEngine(model, num_slots=SLOTS)
    for r in range(3 * SLOTS):
        eng.submit(ImageRequest(r, pool[r]))
    assert eng.step()
    held = eng.produced[0]
    kept = held.copy()
    eng.produced.clear()            # the step's other answers are dropped
    assert eng.step() and eng.step()
    assert held is not eng.produced[2 * SLOTS]
    np.testing.assert_array_equal(held, kept)
    np.testing.assert_array_equal(held, _solo(model, pool[0]))
    assert eng.stats.staged_hits == 2


def test_batch_buffers_are_allocated_once(model, pool):
    eng = VisionEngine(model, num_slots=SLOTS)
    eng.run([ImageRequest(r, pool[r]) for r in range(SLOTS)])
    bufs = list(eng._batches)
    ptrs = [b.data_ptr() for b in bufs]
    assert len(bufs) == 2 and not any(b.is_pinned() for b in bufs)
    eng.run([ImageRequest(100 + r, pool[r]) for r in range(3 * SLOTS)])
    assert [b.data_ptr() for b in eng._batches] == ptrs
    assert all(a is b for a, b in zip(eng._batches, bufs))


def test_mesh_engine_on_two_cpu_ranks_is_bitwise(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable,
                        str(ROOT / "tests" / "torch_engine_staging_world.py"),
                        str(tmp_path), "2"], env=env, capture_output=True,
                       text=True, timeout=WORLD_TIMEOUT_S)
    for rank in range(2):
        path = tmp_path / f"rank{rank}.pkl"
        assert path.exists(), r.stderr[-3000:]
        with open(path, "rb") as f:
            status, val = pickle.load(f)
        assert status == "ok", val
        steps, hits, misses, equal = val
        assert equal
        assert (hits, misses) == (steps - 1, 1)
    assert r.returncode == 0, r.stderr[-3000:]
