"""Fixtures of the benchmark's tests: `card` skips a test where no CUDA
device is present (decided when the test runs, never at import)."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")
