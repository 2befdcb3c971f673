"""One torch thread per test process."""
import torch

# The suite runs in six pytest-xdist workers on the CPU, and each worker
# imports every test module while collecting, before any test runs. At
# torch's default of one intra-op thread per core the six workers would
# oversubscribe the cores several times over and spend most of their time
# preempting one another.
torch.set_num_threads(1)


def test_one_torch_thread_per_worker():
    assert torch.get_num_threads() == 1
