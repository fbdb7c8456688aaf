"""PyTorch's CPU threads in the test workers.

Under pytest-xdist every worker imports every test module while it
collects, this one included, so this module sets the thread count of the
whole worker before any test runs: each worker's PyTorch takes its share
of the machine's cores for its intra-op threads.  PyTorch's default is a
thread a core in every worker, and six workers on eight cores then hold
48 OpenMP threads that wait on each other at every small op: the small
zamba2 hybrid's ten SFT steps (``test_torch_ssm_training.py``) took 38 s
alone and 85 s beside five copies of themselves at one thread each, and
did not end within 500 s beside five copies at PyTorch's default.  A run
in one process keeps the default.  The count changes no result beyond
the order of a parallel float sum, which every tolerance here covers.

The cores are those this process may run on (its CPU affinity), not the
machine's count.  The setting relies on collection importing this module
in every worker, as a run of the whole ``tests/`` directory does; a run
of a subset that leaves this file out keeps PyTorch's default.  A
``pytest_configure`` hook in ``conftest.py`` would not depend on that.
"""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
SHARE = max(1, len(os.sched_getaffinity(0)) // WORKERS)
if WORKERS > 1:
    torch.set_num_threads(SHARE)


def test_each_worker_takes_its_share_of_the_cores():
    if WORKERS > 1:
        assert torch.get_num_threads() == SHARE
    else:
        assert torch.get_num_threads() >= 1
