"""An autouse fixture for the port's CPU test files: two PyTorch intra-op
threads while a test module runs (`from torch_threads import two_threads`).

The tier-1 suite runs six pytest workers on a machine of a few cores, and
PyTorch's default intra-op pool (a thread a core in every worker) makes
the workers' many small ops wait on each other. On an 8-core machine,
twelve of the port's test files took 1049 s on six workers with the
default pool and 436 s with two threads a worker (OMP_NUM_THREADS=2); the
whole tier-1 suite went from 1305 s to 636 s with this fixture in the
port's files.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
