"""A test's reference module under a stem of its own: the chain's
reference, with each call written down in ``CALLS``, so that a test sees
the check and the yardstick reach this module."""
from bench.reference import chain

CALLS = []


def prune_filters(config, dense):
    CALLS.append("prune_filters")
    return chain.prune_filters(config, dense)


def device_filters(pruned, device):
    CALLS.append("device_filters")
    return chain.device_filters(pruned, device)


def forward(config, filters, x, precision="float32", masks_out=None):
    CALLS.append("forward")
    return chain.forward(config, filters, x, precision, masks_out)


def map_bytes(config, size):
    """The chain's count: no map that two layers read."""
    CALLS.append("map_bytes")
    return chain.map_bytes(config, size)
