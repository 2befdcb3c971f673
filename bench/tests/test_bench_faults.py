"""A whole run on the CPU at a tiny size, past the harness's look for a
card: sound, it comes out correct; with the timed path broken underneath
it comes out not correct, for each fault these cells can have. (One chip:
no exchange between chips to leave out.)"""
import io

import pytest
import torch

from bench import harness
from bench.run import run_cell
from conftest import tiny_config

CLOSED = {"loop": "closed", "sides": [16], "pool": 8, "queue_depth": 8}
WL = {"num_slots": 4, "warm_steps": 2, "sample_steps": 2,
      "limits": {"max_rel_err": 1e-4}}
SEED = 2**31 + 77


def altered(out, state):
    """One channel of every answer off by a thousandth where it is
    produced."""
    out = out.clone()
    out[..., 0] *= 1.001
    return out


def half_batch(out, state):
    """Half of the lanes left out (zero answers)."""
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def one_lane(out, state):
    """The answer of one lane of the batch altered; the others sound."""
    out = out.clone()
    out[1] *= 1.001
    return out


def stale(out, state):
    """The step returns what the previous one produced."""
    prev = state.get(out.shape)
    state[out.shape] = out.clone()
    return out if prev is None else prev


def cell():
    cfg = tiny_config()
    return harness.Cell("t.offline", 1, cfg, WL, CLOSED,
                        [{"name": "setup_s", "unit": "s"}], [],
                        *harness.modules_of(cfg))


def run(fault, monkeypatch):
    if fault is not None:
        import repro_torch.vision.model as VM
        real = VM.graphed_forward

        def broken(*a, **kw):
            fwd = real(*a, **kw)
            state = {}
            return lambda x: fault(fwd(x), state)
        monkeypatch.setattr(VM, "graphed_forward", broken)
    return run_cell(cell(), SEED, 0.5, False, torch.device("cpu"),
                    log=io.StringIO())


def test_sound_run_is_correct(monkeypatch):
    res = run(None, monkeypatch)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [altered, half_batch, one_lane, stale],
                         ids=lambda f: f.__name__)
def test_broken_run_is_not_correct(fault, monkeypatch):
    res = run(fault, monkeypatch)
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_rel_err"]["value"] > 1e-4
