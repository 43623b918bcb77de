"""One torch intra-op thread in each port test module (an autouse
fixture the `tests/test_torch_*.py` modules import). The suite runs
on several worker processes at once on one host, and torch's default
of one thread a core makes every worker's small CPU ops contend for
all the cores: six of the slowest port files took 573 s together on
six workers of an 8-core host at the default, and 179 s at one thread
each. The thread count is restored when the module ends."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
