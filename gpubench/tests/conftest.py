"""The benchmark's own tests. Run them from the repository's root:

    python -m pytest gpubench/tests -q              # on the CPU; card tests skip
    python -m pytest gpubench/tests -q -m card      # on a machine with the card

Tests marked ``card`` need a CUDA device; the ``cuda_device`` fixture decides
that when the test runs, never while a module is imported.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (an NVIDIA H100)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card tests run on the H100")
    return torch.device("cuda", 0)
