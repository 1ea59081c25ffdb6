"""The benchmark's CPU tests run beside the repository's under several
workers: each test here keeps torch to two threads, so that its small
models do not take every core from tests that wait on timeouts."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one); run with -m gpu")


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
