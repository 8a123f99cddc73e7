"""Geomorphon terrain classification (reference neilpy/neilpy.py:1600-1610
count_openness, 1617-1654 geomorphons).

PyTorch counterpart of the geomorphon part of
``neilpy_tpu/ops/visibility.py``, with the same names and arguments plus
``device=``.  The openness counts come from ``ops/cuda_scan.py``: the
CUDA kernel for a CUDA tensor, its plain PyTorch version for a CPU
tensor.  Both compare the openness difference with the threshold in
tangent space, as the JAX package's Pallas kernel does, and give counts
and classes equal to it; on the test fixtures they also equal the JAX
package's atan-space XLA path (only an f32 decision tie could differ).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.codes import jasiewicz_stepinski_table
from .cuda_scan import openness_counts

__all__ = ["count_openness", "classes_from_counts", "geomorphons",
           "get_geomorphons", "get_geomorphon_from_openness"]


def as_raster(Z, device=None):
    """``Z`` as a float32 tensor on ``device``.

    A tensor stays on its own device unless ``device`` is given.  Any
    other input (numpy array, nested lists) goes to ``device``, which
    defaults to CUDA; without a CUDA device that raises rather than
    running on the CPU unasked — pass ``device='cpu'`` for the plain
    PyTorch version on the host."""
    if not isinstance(Z, torch.Tensor):
        arr = np.ascontiguousarray(Z, dtype=np.float32)
        if not arr.flags.writeable:  # e.g. a read-only memmap
            arr = arr.copy()
        Z = torch.from_numpy(arr)
        if device is None:
            device = torch.device("cuda")
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch version on the host")
        Z = Z.to(device)
    return Z.to(torch.float32).contiguous()


def count_openness(Z, cellsize, lookup_pixels, threshold_angle, fast=False,
                   how_fast=20, engine="auto", device=None):
    """Per-pixel counts of directions whose (positive - negative)
    openness difference exceeds +/- threshold (neilpy.py:1600-1610), as
    uint8 tensors ``(num_pos, num_neg)``."""
    return openness_counts(
        as_raster(Z, device), cellsize=float(cellsize),
        lookup_pixels=int(lookup_pixels),
        threshold_angle=float(threshold_angle), fast=bool(fast),
        how_fast=int(how_fast), engine=engine)


def classes_from_counts(num_pos, num_neg):
    """J&S 9x9 table lookup: class = table[num_pos, num_neg], a gather
    on the 81-entry table."""
    tbl = torch.from_numpy(jasiewicz_stepinski_table().ravel())
    idx = num_pos.long() * 9 + num_neg.long()
    return tbl.to(num_pos.device)[idx]


def geomorphons(Z, cellsize=1, lookup_pixels=1, threshold_angle=1,
                enhance=False, fast=False, how_fast=20, engine="auto",
                device=None):
    """Geomorphon classes 1-10 (uint8 tensor) from openness counts + the
    J&S 9x9 lookup (neilpy.py:1617-1654), with the optional 'enhance'
    correction-of-forms second pass.

    ``engine``: 'auto' runs the CUDA kernel for data on a CUDA device and
    the plain PyTorch version on the CPU; 'cuda' / 'torch' force one.
    ``device``: where numpy input goes (default CUDA; see
    :func:`as_raster`).
    """
    Z = as_raster(Z, device)

    def classes(lp, f=False):
        num_pos, num_neg = openness_counts(
            Z, cellsize=float(cellsize), lookup_pixels=int(lp),
            threshold_angle=float(threshold_angle), fast=f,
            how_fast=int(how_fast), engine=engine)
        return classes_from_counts(num_pos, num_neg)

    G = classes(lookup_pixels, bool(fast))
    if enhance and lookup_pixels > 16:
        G_sm = classes(max(int(np.floor(lookup_pixels / 4)), 4))
        G = G.masked_fill((G == 4) & (G_sm == 1), 1)
        G = G.masked_fill((G == 8) & (G_sm == 1), 1)
        G = torch.where((G == 2) | (G == 3), G_sm, G)
    return G


# Aliases used in the reference notebooks
get_geomorphons = geomorphons
get_geomorphon_from_openness = geomorphons
