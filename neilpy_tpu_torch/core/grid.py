"""Raster container and small grid utilities.

PyTorch counterpart of ``neilpy_tpu/core/grid.py``.  ``Raster`` is a
plain dataclass (a tensor needs no pytree registration); ``keep_xyz``,
``edges_from_IT``, ``unique_rows`` and ``cutter`` are host numpy, as in
the JAX package; ``normalize`` runs on the tensor's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .affine import Affine
from .device import to_device


@dataclasses.dataclass
class Raster:
    """A georeferenced grid: ``data`` (a tensor or array) with its
    transform, CRS and nodata value."""

    data: Any
    transform: Affine = dataclasses.field(default_factory=Affine.identity)
    crs: Optional[object] = None
    nodata: Optional[float] = None

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def cellsize(self) -> float:
        cx, cy = abs(self.transform.a), abs(self.transform.e)
        return (cx + cy) / 2.0 if abs(cx - cy) < 1e-8 else cx

    @property
    def bounds(self):
        """(west, south, east, north)."""
        h, w = self.data.shape[:2]
        x0, y0 = self.transform * (0, 0)
        x1, y1 = self.transform * (w, h)
        return (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))

    def with_data(self, data) -> "Raster":
        return dataclasses.replace(self, data=data)


# ----------------------------------------------------------------------
# Small conveniences (parity: neilpy.py:87-94, 1095-1102, 1221-1224,
# 1932-1934, 1961-1974)
# ----------------------------------------------------------------------

def keep_xyz(df, x=None, y=None, z=None):
    """Bounding-box filter on a point dataframe (neilpy.py:87-94)."""
    for col, rng in (("x", x), ("y", y), ("z", z)):
        if rng is not None:
            df = df[(df[col] >= rng[0]) & (df[col] <= rng[1])]
    return df


def edges_from_IT(image, transform):
    """x/y bin edges of a georeferenced image (neilpy.py:1095-1102)."""
    r, c = np.shape(image)[0], np.shape(image)[1]
    cols = np.arange(c + 1, dtype=np.float64)
    rows = np.arange(r + 1, dtype=np.float64)
    x_edges, _ = transform * (cols, np.zeros_like(cols))
    _, y_edges = transform * (np.zeros_like(rows), rows)
    return x_edges, y_edges


def unique_rows(a):
    """Deduplicate rows of a 2-D array (neilpy.py:1221-1224)."""
    return np.unique(np.ascontiguousarray(_host(a)), axis=0)


def cutter(x, r, c):
    """Split a raster into an r x c list-of-lists of tiles
    (neilpy.py:1932-1934)."""
    return [np.hsplit(row, c) for row in np.vsplit(_host(x), r)]


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def normalize(X, xrange=("min", "max"), yrange=(0, 1), device=None):
    """Piecewise-linear remap with min/max/mean/median keywords
    (neilpy.py:1961-1974), on ``X``'s device (numpy input: ``device``,
    CUDA by default)."""
    X = to_device(X, device)
    if not X.is_floating_point():
        X = X.to(torch.float32)
    finite = X[~torch.isnan(X)]
    fixed = []
    for item in xrange:
        if item == "max":
            item = finite.max()
        elif item == "min":
            item = finite.min()
        elif item == "mean":
            item = finite.mean()
        elif item == "median":
            item = _median(finite)
        fixed.append(torch.as_tensor(item, dtype=X.dtype, device=X.device))
    return _interp(X, torch.stack(fixed),
                   torch.as_tensor(yrange, dtype=X.dtype, device=X.device))


def _median(v):
    """``jnp.nanmedian`` of the non-NaN values ``v``: the mean of the two
    middle values of an even count (``torch.median`` takes the lower)."""
    v = v.flatten().sort().values
    n = v.numel()
    return v[n // 2] if n % 2 else (v[n // 2 - 1] + v[n // 2]) / 2


def _interp(x, xp, fp):
    """``jnp.interp``: piecewise-linear through (xp, fp), constant
    fp[0] / fp[-1] outside, NaN in -> NaN out (the same formula, with its
    guard against a zero-width interval)."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = torch.finfo(x.dtype).eps ** 2  # np.spacing(eps): eps is 2**-k
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
