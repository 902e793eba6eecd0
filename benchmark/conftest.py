"""pytest settings of the benchmark's own tests (benchmark/tests): the
`gpu` marker, and the `card` fixture that decides, inside the test, whether
a CUDA card is there."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.cuda.get_device_name(0)
