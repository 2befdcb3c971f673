"""Device time of the kernels that are neither K1, nor pooling, nor a copy
between host and card, over the card's busy time, in percent: the conv
layer's im2col copies, and the layout copies beside the pools."""
from bench.trace import is_copy, is_k1, is_pool, traced


def read(run):
    t = traced(run, "closed")
    if t is None:
        return None
    other = t.device_s(lambda n: not (is_k1(n) or is_pool(n) or is_copy(n)))
    return 100.0 * other / t.busy_s
