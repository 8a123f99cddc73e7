"""ctypes binding for the native (C++) LAS point decoder.

PyTorch package's copy of ``neilpy_tpu/io/las_native.py``, with the
same names and results.  ``native/las_decoder.cpp`` mmaps the file and
decodes records across hardware threads straight into flat numpy
arrays, with optional bbox filtering and stride decimation, so
``ops.pointgrid.create_dem_from_las`` and ``pipelines.smrf.smrf_las``
stream a cloud of any size in the memory of one chunk.  The library is
built at first use by ``_host_build``; without it these functions raise
and those callers fall back to ``io/las.read_las``, as in the JAX
package.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _host_build

__all__ = ["native_available", "read_header", "read_las_arrays",
           "read_las_chunks"]

_ARRAYS = [ctypes.POINTER(ctypes.c_double)] * 3 + [
    ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_long, ctypes.c_int]


def _declare(lib):
    lib.las_open_header.restype = ctypes.c_int
    lib.las_open_header.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_double)]
    lib.las_decode_range.restype = ctypes.c_long
    lib.las_decode_range.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double)] + _ARRAYS


def _load():
    return _host_build.load("las_decoder", _declare)


def native_available():
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("native LAS decoder not built (g++ failed or "
                           "is missing; see the warning); use "
                           "io.las.read_las")
    return lib


def read_header(filename):
    """The header facts the decoder uses.  ``minmax`` is the header's
    block in the file's order: (MaxX, MinX, MaxY, MinY, MaxZ, MinZ)."""
    out = (ctypes.c_double * 18)()
    rc = _lib().las_open_header(str(filename).encode(), out)
    if rc == -2:
        raise ValueError("LAZ not yet supported.")
    if rc != 0:
        raise ValueError(f"native LAS header parse failed (code {rc})")
    v = list(out)
    return {"scale": tuple(v[0:3]), "offset": tuple(v[3:6]),
            "minmax": tuple(v[6:12]), "num_point_records": int(v[13]),
            "point_data_offset": int(v[14]),
            "point_data_record_length": int(v[15]),
            "point_data_format_id": int(v[16]),
            "version": v[17] / 10.0}


def _decode(filename, first, count, stride, bbox, n_threads, hdr,
            n_records):
    """Records [first, first+count) with stride, as a dict of compacted
    flat arrays."""
    n_out = (n_records + stride - 1) // stride
    xs = np.empty(n_out, dtype=np.float64)
    ys = np.empty(n_out, dtype=np.float64)
    zs = np.empty(n_out, dtype=np.float64)
    inten = np.empty(n_out, dtype=np.uint16)
    klass = np.empty(n_out, dtype=np.uint8)
    rn = np.empty(n_out, dtype=np.uint8)
    rm = np.empty(n_out, dtype=np.uint8)
    bb = None
    if bbox is not None:
        bb = (ctypes.c_double * 4)(*[float(b) for b in bbox])

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    wrote = _lib().las_decode_range(
        str(filename).encode(), int(first), int(count), int(stride), bb,
        p(xs, ctypes.c_double), p(ys, ctypes.c_double),
        p(zs, ctypes.c_double), p(inten, ctypes.c_uint16),
        p(klass, ctypes.c_uint8), p(rn, ctypes.c_uint8),
        p(rm, ctypes.c_uint8), int(n_out), int(n_threads))
    if wrote < 0:
        raise ValueError(f"native LAS decode failed (code {wrote})")
    sl = slice(0, wrote)
    return {"header": hdr, "x": xs[sl], "y": ys[sl], "z": zs[sl],
            "intensity": inten[sl], "class": klass[sl],
            "return_number": rn[sl], "return_max": rm[sl]}


def read_las_arrays(filename, stride=1, bbox=None, n_threads=0):
    """Decode a LAS file natively into a dict of flat arrays
    (x, y, z float64; intensity uint16; class/return_number/return_max
    uint8).  ``bbox`` = (xmin, xmax, ymin, ymax) filters on the fly;
    ``stride`` keeps every stride-th point."""
    _lib()
    stride = max(1, int(stride))
    hdr = read_header(filename)
    return _decode(filename, 0, -1, stride, bbox, n_threads, hdr,
                   hdr["num_point_records"])


def read_las_chunks(filename, chunk_points=4_000_000, stride=1,
                    bbox=None, n_threads=0):
    """Iterate a LAS file in fixed-memory chunks of at most
    ``chunk_points`` records (before ``stride``/``bbox`` filtering),
    yielding the same dict as ``read_las_arrays`` per chunk.  The file
    is mmapped per chunk, so peak memory is one chunk's arrays whatever
    the file size."""
    _lib()
    if chunk_points < 1:
        raise ValueError("chunk_points must be >= 1")
    hdr = read_header(filename)
    n = hdr["num_point_records"]
    # the decoder restarts its stride phase at `first`, so chunk
    # boundaries sit on stride multiples: the streamed decimation then
    # selects the subset of the one-shot read_las_arrays(stride=)
    stride = max(1, int(stride))
    step = max(stride, (int(chunk_points) // stride) * stride)
    for first in range(0, n, step):
        count = min(step, n - first)
        yield _decode(filename, first, count, stride, bbox, n_threads,
                      hdr, count)
