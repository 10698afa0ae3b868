"""One torch thread a test module, for the port's CPU tests.

Their ops are tiny.  With several test workers on one host, torch's
intra-op thread pools oversubscribe the cores and each op waits on the
others' spinning threads: an engine run of ~0.3 s alone took ~10 s in a
six-worker run of the suite.  A module imports the fixture to run with
one thread, restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
