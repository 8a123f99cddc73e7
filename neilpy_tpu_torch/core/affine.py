"""Pure-Python affine georeferencing transform (a copy of
``neilpy_tpu/core/affine.py``, which is numpy only).

Replacement for the small slice of ``rasterio.transform`` /
``affine.Affine`` the reference library relies on (reference:
neilpy/neilpy.py:1141 ``rasterio.transform.from_origin``, neilpy.py:1142
``~t * (x, y)``, neilpy.py:1564-1570 worldfile writing).

The transform maps *pixel* coordinates ``(col, row)`` to *world*
coordinates ``(x, y)``::

    x = a * col + b * row + c
    y = d * col + e * row + f

which matches the rasterio/affine convention, including element ordering
``(a, b, c, d, e, f)`` for indexing and iteration.

All arithmetic is float64 on host: georeferencing is precision-critical
(UTM coordinates ~1e5-1e6 with sub-metre cells), so index computation is
never pushed through the device f32 path.  Only bulk per-point work is.
"""

from __future__ import annotations

import numpy as np


class Affine:
    """A 2-D affine transform (a, b, c, d, e, f) in rasterio order."""

    __slots__ = ("a", "b", "c", "d", "e", "f")

    def __init__(self, a, b, c, d, e, f):
        self.a = float(a)
        self.b = float(b)
        self.c = float(c)
        self.d = float(d)
        self.e = float(e)
        self.f = float(f)

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @classmethod
    def identity(cls) -> "Affine":
        return cls(1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    @classmethod
    def from_origin(cls, west, north, xsize, ysize) -> "Affine":
        """North-up transform anchored at the upper-left corner.

        Equivalent to ``rasterio.transform.from_origin`` (used by the
        reference at neilpy/neilpy.py:1141).
        """
        return cls(xsize, 0.0, west, 0.0, -ysize, north)

    @classmethod
    def from_worldfile(cls, path) -> "Affine":
        vals = [float(v) for v in open(path).read().split()]
        a, d, b, e, cx, cy = vals[:6]
        # worldfile stores the *center* of the upper-left pixel
        c = cx - (a * 0.5 + b * 0.5)
        f = cy - (d * 0.5 + e * 0.5)
        return cls(a, b, c, d, e, f)

    # ------------------------------------------------------------------
    # Mapping
    # ------------------------------------------------------------------
    def __mul__(self, colrow):
        """Apply to a ``(col, row)`` pair (scalars or arrays)."""
        col, row = colrow
        col = np.asarray(col, dtype=np.float64)
        row = np.asarray(row, dtype=np.float64)
        x = self.a * col + self.b * row + self.c
        y = self.d * col + self.e * row + self.f
        if x.ndim == 0:
            return float(x), float(y)
        return x, y

    def __invert__(self) -> "Affine":
        det = self.a * self.e - self.b * self.d
        if det == 0.0:
            raise ValueError("Affine transform is singular")
        ia = self.e / det
        ib = -self.b / det
        id_ = -self.d / det
        ie = self.a / det
        ic = -(ia * self.c + ib * self.f)
        if_ = -(id_ * self.c + ie * self.f)
        return Affine(ia, ib, ic, id_, ie, if_)

    # ------------------------------------------------------------------
    # Sequence protocol (rasterio-style indexing/iteration)
    # ------------------------------------------------------------------
    def __getitem__(self, i):
        return (self.a, self.b, self.c, self.d, self.e, self.f)[i]

    def __iter__(self):
        return iter((self.a, self.b, self.c, self.d, self.e, self.f))

    def __len__(self):
        return 6

    def __eq__(self, other):
        return isinstance(other, Affine) and tuple(self) == tuple(other)

    def __hash__(self):
        return hash(tuple(self))

    def __repr__(self):
        return (f"Affine({self.a}, {self.b}, {self.c},\n"
                f"       {self.d}, {self.e}, {self.f})")

    # ------------------------------------------------------------------
    # Convenience
    # ------------------------------------------------------------------
    @property
    def xoff(self):
        return self.c

    @property
    def yoff(self):
        return self.f

    def world_to_pixel(self, x, y, op=np.floor, dtype=np.int64):
        """Vectorised inverse mapping to integer (col, row) indices.

        Matches the reference gridding convention (neilpy.py:1142-1143):
        ``c, r = ~t * (x, y)`` followed by ``floor`` and int64 cast.
        """
        col, row = (~self) * (x, y)
        return op(col).astype(dtype), op(row).astype(dtype)


def from_origin(west, north, xsize, ysize) -> Affine:
    """Module-level alias mirroring ``rasterio.transform.from_origin``."""
    return Affine.from_origin(west, north, xsize, ysize)
