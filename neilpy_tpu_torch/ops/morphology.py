"""Grayscale morphology with disk structuring elements.

PyTorch counterpart of ``neilpy_tpu/ops/morphology.py``, with the same
names and arguments plus ``device=`` (numpy input goes to CUDA unless
``device='cpu'``).  SMRF's progressive filter calls
``skimage.morphology.opening(surface, disk(w))`` for w = 1..18
(neilpy/neilpy.py:1667-1670): scipy ``grey_erosion`` then
``grey_dilation`` with reflect boundaries.

A disk decomposes exactly into horizontal runs: for each row offset dy
the footprint covers [-kx(dy), kx(dy)] with kx = floor(sqrt(r^2 - dy^2)),
so erosion is the min over dy of a sliding row min of half-width kx(dy),
shifted by dy.  All row mins come from one sparse table (log2(2r+1)
doubling passes; any width is the min of two overlapping power-of-two
windows).  ``torch.minimum`` / ``torch.maximum`` propagate NaN as
``jnp.minimum`` / ``jnp.maximum`` do, so the result equals the JAX
package's element for element.  Boundaries replicate scipy's
``mode='reflect'`` through ``core/shift.pad_reflect``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.codes import disk_run_halfwidths
from ..core.device import float_tensor, to_device
from ..core.shift import pad_reflect

__all__ = ["grey_erosion_disk", "grey_dilation_disk", "opening_disk",
           "grey_erosion", "grey_dilation", "opening", "erosion",
           "dilation"]


def _sparse_table(P, max_width, reduce_fn):
    """Anchored row-window reductions: levels[k][.., i] reduces
    P[.., i : i + 2**k].  Arrays shrink along the row axis as k grows."""
    levels = [P]
    k = 0
    while (1 << (k + 1)) <= max_width:
        prev = levels[-1]
        step = 1 << k
        levels.append(reduce_fn(prev[:, :-step], prev[:, step:]))
        k += 1
    return levels


def _row_window(levels, width, start_col, ncols, reduce_fn):
    """Reduction over columns [start_col, start_col + width) for every
    output column, via two overlapping power-of-two windows."""
    k = int(np.floor(np.log2(width)))
    step = 1 << k
    A = levels[k]
    left = A[:, start_col:start_col + ncols]
    right = A[:, start_col + width - step:start_col + width - step + ncols]
    return reduce_fn(left, right)


def _disk_morph_padded(P, radius, reduce_fn):
    """Disk min/max over a block already padded by ``radius`` on every
    side; returns the core.  The run decomposition reads only [-r, r]
    neighbourhoods, so the padding decides the boundary semantics."""
    r = int(radius)
    H, W = P.shape[0] - 2 * r, P.shape[1] - 2 * r
    dys, kxs = disk_run_halfwidths(r)
    levels = _sparse_table(P, int(2 * kxs.max() + 1), reduce_fn)

    # group row offsets by half-width so each row-min is computed once
    by_kx = {}
    for dy, kx in zip(dys, kxs):
        by_kx.setdefault(int(kx), []).append(int(dy))

    out = None
    for kx, dy_list in by_kx.items():
        # row reduction over [c - kx, c + kx] for output column c: the
        # padded start is (c + r) - kx
        rm = _row_window(levels, 2 * kx + 1, r - kx, W, reduce_fn)
        for dy in dy_list:
            band = rm[r + dy: r + dy + H, :]
            out = band if out is None else reduce_fn(out, band)
    return out


def _disk_morph(Z, radius, reduce_fn):
    """Disk min/max of a float32 or float64 tensor, reflect boundaries."""
    return _disk_morph_padded(pad_reflect(Z, int(radius)), radius,
                              reduce_fn)


def grey_erosion_disk(Z, radius, device=None):
    """Grayscale erosion by ``disk(radius)`` (scipy reflect boundary)."""
    return _disk_morph(float_tensor(Z, device), radius, torch.minimum)


def grey_dilation_disk(Z, radius, device=None):
    """Grayscale dilation by ``disk(radius)``."""
    return _disk_morph(float_tensor(Z, device), radius, torch.maximum)


def opening_disk(Z, radius, device=None):
    """Grayscale opening (erosion then dilation) by ``disk(radius)`` —
    the SMRF ladder's workhorse (parity: skimage opening at
    neilpy.py:1670)."""
    Z = float_tensor(Z, device)
    return _disk_morph(_disk_morph(Z, radius, torch.minimum), radius,
                       torch.maximum)


# ----------------------------------------------------------------------
# Generic footprints (small/odd) — unrolled offset reduction.
# ----------------------------------------------------------------------
def _generic_morph(Z, footprint, reduce_fn, device):
    Z = to_device(Z, device, torch.float32)
    fp = np.asarray(footprint).astype(bool)
    kh, kw = fp.shape
    ph, pw = kh // 2, kw // 2
    P = pad_reflect(Z, ((ph, kh - 1 - ph), (pw, kw - 1 - pw)))
    H, W = Z.shape
    out = None
    for dy in range(kh):
        for dx in range(kw):
            if not fp[dy, dx]:
                continue
            band = P[dy:dy + H, dx:dx + W]
            out = band if out is None else reduce_fn(out, band)
    return out


def grey_erosion(Z, footprint, device=None):
    """Grayscale erosion by an arbitrary boolean footprint (float32)."""
    return _generic_morph(Z, footprint, torch.minimum, device)


def grey_dilation(Z, footprint, device=None):
    """Grayscale dilation by an arbitrary boolean footprint
    (scipy convention: footprint mirrored; symmetric footprints are
    unaffected)."""
    fp = np.asarray(footprint)[::-1, ::-1]
    return _generic_morph(Z, fp, torch.maximum, device)


def erosion(Z, footprint, device=None):
    return grey_erosion(Z, footprint, device)


def dilation(Z, footprint, device=None):
    return grey_dilation(Z, footprint, device)


def opening(Z, footprint, device=None):
    """Grayscale opening by an arbitrary footprint (skimage.opening
    semantics)."""
    return grey_dilation(grey_erosion(Z, footprint, device),
                         np.asarray(footprint))
