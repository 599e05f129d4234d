"""pytest settings of the benchmark's own tests (`benchmark/tests/`):
the `card` marker, and this folder and the checkout on the path, as
`run.py` puts them."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where none is visible")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip "
                    "(python3 -m pytest benchmark/tests -m card)")
    return torch.device("cuda", 0)
