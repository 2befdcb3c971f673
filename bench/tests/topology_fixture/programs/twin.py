"""A test's program module under a stem of its own: the chain's program,
with each call written down in ``CALLS``, so that a test sees a run
reach this module."""
from bench.programs import chain

CALLS = []


def build(config, filters, device):
    CALLS.append("build")
    return chain.build(config, filters, device)
