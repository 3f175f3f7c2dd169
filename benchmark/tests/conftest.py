"""Shared fixtures of the benchmark's own tests: the CPU tests run a cell's
configuration on a tiny mesh; the card tests are marked `gpu` and skip
inside the test where there is no card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture(scope="session")
def grid_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("grids")


def tiny(cell, level=2, levels=6, check_steps=(2, 4), warmup=2):
    """The cell on generate_mesh(level) with `levels` levels: its
    configuration and inputs, a size the CPU runs in seconds."""
    cell.traffic = dict(cell.traffic, grid_level=level, levels=levels,
                        check_steps=list(check_steps), warmup_steps=warmup)
    return cell
