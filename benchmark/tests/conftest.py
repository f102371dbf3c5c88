"""Tests of the benchmark (``python -m pytest benchmark/tests -q``).

They import the harness as ``run.py`` does (``benchmark/`` and the checkout's
root on the path). Tests marked ``cuda`` need a card and skip without one;
on the card: ``python -m pytest benchmark/tests -q -m cuda``.
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _path in (ROOT, BENCH):
    if _path not in sys.path:
        sys.path.insert(0, _path)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
