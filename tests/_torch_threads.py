"""One torch intra-op thread for each port test module.

The suite runs several pytest workers side by side, and torch starts a
thread per core in each of them: the pools oversubscribe the cores, and a
CPU-bound test then runs several times slower than alone (the reduced
tinyllama train CLI: 26 s at one thread against 128 s at eight, with six
busy processes beside it).  A test module takes the fixture by importing
it; it is module-scoped, so it also covers the module's own
module-scoped fixtures, which pytest sets up after it."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
