"""Directional shift primitives — the core stencil building block.

PyTorch counterpart of ``neilpy_tpu/core/shift.py``.  The reference
library's primitive is ``ashift`` (reference: neilpy/neilpy.py:1290-1308):
copy a raster shifted ``n`` pixels in one of 8 compass directions
(clockwise from the upper-left), where positions whose source pixel
falls outside the array *keep their original value* (NOT wrap, NOT
zero, NOT edge-clamp).

Direction convention (clockwise from upper-left = direction 0)::

      0 1 2
      7 . 3
      6 5 4

``ashift(Z, d, n)[r, c] == Z[r + dr*n, c + dc*n]`` when in bounds, else
``Z[r, c]``, with (dr, dc) = OFFSETS[d].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .device import to_device

# (row, col) offset of the *source* pixel for each direction.
# direction d "grabs" the pixel n steps away toward compass direction d.
OFFSETS = (
    (-1, -1),  # 0: upper-left
    (-1, 0),   # 1: up
    (-1, 1),   # 2: upper-right
    (0, 1),    # 3: right
    (1, 1),    # 4: lower-right
    (1, 0),    # 5: down
    (1, -1),   # 6: lower-left
    (0, -1),   # 7: left
)

# Euclidean step length per unit shift for each direction (diagonals sqrt(2)).
# Matches reference dlist indexing: dlist[direction % 2] with
# dlist = [sqrt(2), 1] (neilpy.py:1337, 1346).
STEP_LENGTH = tuple(2.0 ** 0.5 if d % 2 == 0 else 1.0 for d in range(8))


def shift_valid_mask(shape, direction, n, device=None):
    """Boolean mask of positions whose shifted source is inside the array."""
    h, w = shape
    dr, dc = OFFSETS[direction]
    sr = torch.arange(h, device=device)[:, None] + dr * n
    sc = torch.arange(w, device=device)[None, :] + dc * n
    return (sr >= 0) & (sr < h) & (sc >= 0) & (sc < w)


def rolled(Z, direction, n):
    """``out[r, c] = Z[r + dr*n, c + dc*n]`` with wraparound (no masking)."""
    dr, dc = OFFSETS[direction]
    return torch.roll(Z, shifts=(-dr * n, -dc * n), dims=(0, 1))


def ashift(Z, direction, n=1):
    """Edge-fallback directional shift (parity with neilpy.py:1290-1308).

    Out-of-range positions keep the *original* value of ``Z`` at that
    position.  Directions outside 0-7 return ``Z`` unchanged — this
    reproduces the reference's fall-through behaviour, which
    ``wilson_gallant_curvature`` (neilpy.py:767-768) silently relies on.
    """
    Z = torch.as_tensor(Z)
    if direction not in range(8):
        return Z
    mask = shift_valid_mask(Z.shape, direction, n, device=Z.device)
    return torch.where(mask, rolled(Z, direction, n), Z)


def ashift_fill(Z, direction, n=1, fill=math.nan, device=None):
    """Directional shift with a constant ``fill`` (in ``Z``'s dtype) for
    out-of-range positions.  A tensor stays on its own device unless
    ``device`` is given; other input goes to ``device``
    (``core/device.py``)."""
    Z = to_device(Z, device)
    mask = shift_valid_mask(Z.shape, direction, n, device=Z.device)
    return torch.where(mask, rolled(Z, direction, n),
                       torch.tensor(fill, dtype=Z.dtype, device=Z.device))


def gradient2d(Z, spacing=1.0):
    """``np.gradient`` on a 2-D array: central differences in the
    interior, one-sided at the edges.  Returns (gy, gx), as
    ``neilpy_tpu.core.shift.gradient2d`` (reference neilpy.py:460, 475,
    849, 1785)."""
    Z = torch.as_tensor(Z)

    def axis_grad(A, axis):
        n = A.shape[axis]
        interior = (A.narrow(axis, 2, n - 2) - A.narrow(axis, 0, n - 2)) / (
            2.0 * spacing)
        first = (A.narrow(axis, 1, 1) - A.narrow(axis, 0, 1)) / spacing
        last = (A.narrow(axis, n - 1, 1) - A.narrow(axis, n - 2, 1)) / spacing
        return torch.cat([first, interior, last], dim=axis)

    return axis_grad(Z, 0), axis_grad(Z, 1)


def _pad_index(n, before, after, mode, device):
    """Source index of every position of an axis of length ``n`` padded by
    ``before`` / ``after``: clamped (``edge``) or mirrored with the edge
    repeated, period 2n (``symmetric``), as ``np.pad``."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    k = i.remainder(2 * n)
    return torch.where(k < n, k, 2 * n - 1 - k)


def _pad(Z, pad, mode):
    Z = torch.as_tensor(Z)
    pairs = np.broadcast_to(np.asarray(pad, dtype=np.int64), (Z.dim(), 2))
    if (pairs < 0).any():
        raise ValueError(f"pad widths must be >= 0, got {pad!r}")
    for axis, (before, after) in enumerate(pairs.tolist()):
        if before or after:
            Z = Z.index_select(axis, _pad_index(Z.shape[axis], before, after,
                                                mode, Z.device))
    return Z


def pad_edge(Z, pad):
    """Edge-replicate pad (scipy.ndimage mode='nearest'); ``pad`` as for
    ``np.pad``."""
    return _pad(Z, pad, "edge")


def pad_reflect(Z, pad):
    """Edge-inclusive reflect pad (scipy.ndimage mode='reflect'),
    i.e. ``(d c b a | a b c d)`` — numpy's 'symmetric'."""
    return _pad(Z, pad, "symmetric")
