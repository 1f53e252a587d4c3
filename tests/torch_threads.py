"""Two intra-op torch threads for a port test module: the suite runs six
workers on a few cores, and the port's conv-heavy CPU tests at torch's
default thread count oversubscribe them. Import ``two_threads`` into a
test module; it is autouse, module-scoped, and restores the count after."""
import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
