"""ctypes binding for the native (C++) point-binning library.

PyTorch package's copy of ``neilpy_tpu/ops/binning_native.py``, with
the same names, signatures and refusals.  The exact gridding path
computes f64 bin indices on the host (``ops/pointgrid.py``); numpy
needs ~10 full-array temporaries for it.  ``native/binning.cpp`` does
the inverse-affine floor binning in one multithreaded pass, and the
origin shift of the device binning path.  The library is built at first
use by ``_host_build`` (never by ``make``); when it cannot be built,
``bin_points`` falls back to numpy and ``origin_shift_native`` returns
None, as in the JAX package.

The kernel computes ``floor((x - x0) * (1 / cs))`` where numpy computes
the algebraically equal ``ia*x + ic``: a point exactly on a cell edge is
the only one whose bin can differ.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _host_build

__all__ = ["native_available", "bin_points_native", "origin_shift_native"]

_D = ctypes.POINTER(ctypes.c_double)
_F = ctypes.POINTER(ctypes.c_float)


def _declare(lib):
    lib.bin_points_f64.restype = ctypes.c_long
    lib.bin_points_f64.argtypes = [
        _D, _D, ctypes.c_long, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
    lib.origin_shift_f64.restype = None
    lib.origin_shift_f64.argtypes = [_D, _D, ctypes.c_long, ctypes.c_double,
                                     ctypes.c_double, _F, _F]


def _load():
    return _host_build.load("binning", _declare)


def native_available():
    return _load() is not None


def origin_shift_native(x, y, x0, y0):
    """Multithreaded (x - x0, y0 - y) -> f32 for the device binning
    fast path; returns None when the library is missing."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    if x.shape != y.shape:
        raise ValueError("x and y must have the same length")
    xr = np.empty(x.size, dtype=np.float32)
    yr = np.empty(y.size, dtype=np.float32)
    lib.origin_shift_f64(x.ctypes.data_as(_D), y.ctypes.data_as(_D),
                         x.size, float(x0), float(y0),
                         xr.ctypes.data_as(_F), yr.ctypes.data_as(_F))
    return xr, yr


def bin_points_native(x, y, cellsize=1, edges=None):
    """Native drop-in for ``ops.pointgrid.bin_points``: returns
    (flat int32, valid bool, (ny, nx), t)."""
    from .pointgrid import _grid_frame
    lib = _load()
    if lib is None:
        raise RuntimeError("native binning library not built (g++ "
                           "failed or is missing; see the warning)")
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    if x.shape != y.shape:
        raise ValueError("x and y must have the same length")
    ny, nx, t, cellsize, _ = _grid_frame(x, y, cellsize, edges)
    if ny * nx >= 2 ** 31:
        raise ValueError("grid too large for int32 bin indices; use "
                         "bin_points(..., native=False) or tile first")
    n = x.size
    flat = np.empty(n, dtype=np.int32)
    valid = np.empty(n, dtype=np.uint8)
    lib.bin_points_f64(x.ctypes.data_as(_D), y.ctypes.data_as(_D), n,
                       float(t.c), float(t.f), float(cellsize), ny, nx,
                       flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                       valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return flat, valid.astype(bool), (ny, nx), t
