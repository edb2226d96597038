"""A fixture the port's CPU test modules share: import it into a module
(``from _torch_threads import _one_thread  # noqa: F401``) and every test
there runs with one intra-op thread."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for a module's tiny tensors: the suite runs
    several workers at once, and their default thread pools oversubscribe
    the cores (a test of a few seconds then takes minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
