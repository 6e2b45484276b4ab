"""One intra-op thread for the port's CPU tests.

The suite runs its files in parallel workers on shared cores. torch
starts one intra-op thread a core in every worker, so the workers
oversubscribe the cores many times over and small ops wait on threads
that are not running. The models in these tests are small: one thread
costs little alone. Each `test_torch_*.py` imports the fixture below,
which holds for its module and restores the count after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
