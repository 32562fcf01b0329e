"""One intra-op torch thread for a test module: ``from torch_threads import
one_thread  # noqa: F401`` makes it autouse there.

The port's CPU tests run tiny shapes in several pytest workers at once.
torch's default pool (a thread per core in every worker) then
oversubscribes the cores: the spinning threads made the port's tests
several times slower in a full run than alone, and slowed the JAX tests
beside them.  One thread per test process keeps each worker on its core.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
