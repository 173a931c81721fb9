"""The harness's CPU tests: the tiny sizes of `tiny.py`, the port's plain
versions, one torch thread. Tests that need the card are marked `cuda` and
skip inside the `cuda_device` fixture when there is none."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); skips without one")


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
