"""K1's share of its roofline over the traced stretch, in percent: the sum
over the stretch's engine steps of the least time the step's forward could
take, max(2 x two-sided MACs / fp32 peak, bytes / HBM bandwidth), over the
summed device time of K1's launches (``tile_kernel``, ``walk_kernel``)."""
from bench.trace import is_k1, traced


def read(run):
    t = traced(run, "closed")
    if t is None or run.yardstick is None or not run.traced_steps:
        return None
    k1 = t.device_s(is_k1)
    if k1 <= 0:
        return None
    y = run.yardstick()
    bound = sum(y.step_bound_s(s[2]) for s in run.traced_steps
                if s[2])
    return 100.0 * bound / k1
