import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke runs are many tiny ops: one intra-op thread a worker keeps
    the test run's workers from crowding each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
