"""Seconds from the start of the process to the start of the window:
imports, inputs, packing, admission, the kernel build on a checkout's
first run, and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
