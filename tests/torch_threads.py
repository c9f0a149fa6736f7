"""The port's test files share one fixture: torch on one thread.

The engines, the smoke models and the sharded sweep's workers (through
``ShardPool``'s rule) run many tiny operations; under the test runner's
parallel workers each op's thread pool fights the other workers' for
the cores, and a run slows down many times over. A test file takes the
fixture for every test with

    from torch_threads import one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
