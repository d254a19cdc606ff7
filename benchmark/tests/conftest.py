"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q` from
the repository's root. Tests marked `cuda` skip without a card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def device(request):
    """The device of a test parametrized over "cpu" and "cuda"; a cuda
    case skips without a card."""
    import torch

    dev = request.param
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return dev


@pytest.fixture
def small_crowd(monkeypatch, request):
    """The cells' traffic mixes cut to a crowd a test run can hold: the
    keys of the test's `SMALL` replace the mix's wherever the harness
    finds a cell's files."""
    from benchmark import harness

    found = harness.cell_files

    def cell_files(name, spec=None):
        cell, cfg, mix, limits = found(name, spec)
        return cell, cfg, {**mix, **request.module.SMALL}, limits

    monkeypatch.setattr(harness, "cell_files", cell_files)
