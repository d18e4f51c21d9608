"""CPU tests of the benchmark: small cells, the `cuda` marker for what only
the card runs (decided inside the test, never at import)."""

import math
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a small geometry: 39 fields of 100 ids, 8 batches of 128 rows
SMALL_CONFIG = {"nfeat": 3900}
SMALL_TRAFFIC = {"rows": 1024, "batch": 128}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is absent")


def cell(name):
    """The cell `name` of BENCHMARK.json (a fresh copy to change)."""
    from portbench import spec

    return spec.load_cell(name)


def small(name, **traffic):
    """The cell `name` at the small geometry."""
    cell_ = cell(name)
    full = cell_.config["nfeat"] + cell_.config["nemb"]
    cell_.config.update(SMALL_CONFIG)
    cell_.traffic.update(SMALL_TRAFFIC, **traffic)
    # the table keeps the entries' range it has at full size
    shrink = math.sqrt((cell_.config["nfeat"] + cell_.config["nemb"]) / full)
    cell_.traffic["weight_scale"] = {
        k: v * shrink
        for k, v in cell_.traffic.get("weight_scale", {}).items()}
    return cell_


@pytest.fixture
def small_cell():
    return small


@pytest.fixture
def need_cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
