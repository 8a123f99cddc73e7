"""Fixtures of the benchmark's CPU tests (no JAX here).

Run: ``python3 -m pytest portbench/tests -q`` from the root of a
checkout; the ``cuda`` tests run on the card with ``-m cuda``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell at a size the CPU runs in about a second
SMALL = {
    "geomorphons_l50": {"config": {"raster": [96, 128], "lookup_pixels": 10},
                        "traffic": {"sample_outputs": 3}},
    "mosaic_trio": {"config": {"extent": 600, "tile_size": 256,
                               "lookup_pixels": 10},
                    "traffic": {"sample_pixels_per_tile": 2}},
}


def small(cell):
    return SMALL[cell.split(".")[0]]


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
