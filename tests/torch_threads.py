"""One torch intra-op thread for a test module: import the fixture into it.

The tier-1 run puts several pytest workers on the machine's cores. The small
CPU tensors of these tests gain nothing from torch's thread pool there, and
its threads contend with the other workers' (one such file took 8x its time
alone). The count before the module comes back after it."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
