import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # chains of tiny CPU ops spin against each other under several workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
