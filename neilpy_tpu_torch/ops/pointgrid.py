"""Point-cloud to raster gridding (``create_dem``).

PyTorch counterpart of ``neilpy_tpu/ops/pointgrid.py``, with the same
names, arguments and results; every function also takes ``device=``
(numpy input goes to CUDA unless ``device='cpu'``).

Reference: neilpy/neilpy.py:1110-1166 — edges snapped to the cellsize
with a half-cell margin, a north-up affine, inverse-affine floor
binning, then a pandas ``groupby(flat_index).min()/.max()`` scatter.

* The grid frame and the exact bin indices are float64 host numpy, as in
  the JAX package (``_grid_frame``, ``bin_points``); UTM coordinates
  with metre cells cannot survive float32.  ``device_bin=True`` shifts
  the points to the grid origin on the host (one f64 pass) and floors
  the float32 offsets on the device.
* The reduction is ``Tensor.scatter_reduce_('amin' / 'amax',
  include_self=True)`` into a grid filled with the reduction's identity
  (±inf), after which only the identity maps to NaN: a cell whose only
  point is -inf under max reads NaN, as in the JAX scatter.
  ``method='sort'`` sorts the (bin, z) pairs and gathers each cell's
  segment extremum by ``searchsorted``, with no scatter; it returns the
  extremum wherever a cell was hit, ±inf included, as the JAX sort path.
* The int32 flat-index limit of the JAX kernel is kept: ``scatter_reduce``
  refuses grids beyond 2**31 - 1 cells, ``create_dem`` routes them
  through the (row, col) scatter and refuses ``method='sort'`` there.
* ``bin_points(native=None)`` takes the native binning library
  (``ops/binning_native.py``, built at first use) and falls back to
  numpy where the JAX package does; the origin shift of the device
  binning path takes it too.  ``create_dem_from_las`` streams the file
  through the native LAS decoder chunk by chunk into the device grid,
  in the memory of one chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.affine import Affine
from ..core.device import resolve_device, to_device

__all__ = ["create_dem", "create_dem_from_las", "bin_points",
           "bin_points_device",
           "scatter_reduce", "grid_points_device"]


def _floor2(x, v):
    return v * np.floor(x / v)


def _ceil2(x, v):
    return v * np.ceil(x / v)


def _grid_frame(x, y, cellsize=1, edges=None):
    """Shared host-side (f64) grid-frame computation: edge snapping and
    the north-up affine, exactly as the reference (neilpy.py:1117-1143):
    x edges from floor(min/cs)*cs - .5cs to ceil(max/cs)*cs + 1.5cs,
    y edges descending.  Returns (ny, nx, t, cellsize, in_range|None).
    """
    if np.size(x) == 0:
        raise ValueError("empty point set: cannot derive a grid frame")
    if edges is None:
        cellsize = float(cellsize)
        xedges = np.arange(_floor2(x.min(), cellsize) - .5 * cellsize,
                           _ceil2(x.max(), cellsize) + 1.5 * cellsize,
                           cellsize)
        yedges = np.arange(_ceil2(y.max(), cellsize) + .5 * cellsize,
                           _floor2(y.min(), cellsize) - 1.5 * cellsize,
                           -cellsize)
        in_range = None
    else:
        xedges, yedges = np.asarray(edges[0]), np.asarray(edges[1])
        out = ((x < xedges[0]) | (x > xedges[-1])
               | (y > yedges[0]) | (y < yedges[-1]))
        in_range = ~out
        cellsize = float(abs(xedges[1] - xedges[0]))
    nx, ny = len(xedges) - 1, len(yedges) - 1
    t = Affine.from_origin(xedges[0], yedges[0], cellsize, cellsize)
    return ny, nx, t, cellsize, in_range


def bin_points(x, y, cellsize=1, edges=None, native=None):
    """Compute grid shape, affine transform, and per-point flat bin
    indices (host, float64 — the exact path).

    Returns (flat_index int64 array, in_range bool array, (ny, nx), t).

    ``native=None`` (auto) dispatches to the multithreaded C++ kernel
    when it is built (identical output up to f64 associativity on
    bit-exact cell-edge hits: its flat index is int32) and falls back to
    numpy beyond the int32 grid limit; ``native=True`` raises where the
    kernel is missing or refuses; ``native=False`` forces numpy.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if native is None or native:
        from .binning_native import native_available, bin_points_native
        if native_available():
            try:
                return bin_points_native(x, y, cellsize, edges)
            except ValueError:
                if native:  # explicit request: surface the limit
                    raise
                # auto mode: >int32 grids fall back to numpy below
        elif native:
            raise RuntimeError("native binning requested but "
                               "libbinning.so is not built")
    ny, nx, t, cellsize, in_range = _grid_frame(x, y, cellsize, edges)
    if in_range is None:
        in_range = np.ones(x.shape, dtype=bool)
    c, r = (~t) * (x, y)
    c = np.floor(c).astype(np.int64)
    r = np.floor(r).astype(np.int64)
    # guard: out-of-range points map to bin 0 but are masked out
    c_cl = np.clip(c, 0, nx - 1)
    r_cl = np.clip(r, 0, ny - 1)
    in_range &= (c == c_cl) & (r == r_cl)
    flat = r_cl * nx + c_cl
    return flat, in_range, (ny, nx), t


def _origin_shift(x, y, t):
    """Host f64 shift to the grid origin, then float32: the offsets span
    only the grid extent, so float32 keeps sub-millimetre resolution.
    The native kernel (multithreaded) rounds the same f64 differences
    once, so both give the same bits."""
    from .binning_native import origin_shift_native
    shifted = origin_shift_native(x, y, t.c, t.f)
    if shifted is not None:
        return shifted
    return (x - t.c).astype(np.float32), (t.f - y).astype(np.float32)


def bin_points_device(x, y, cellsize=1, edges=None):
    """Fast-path frame computation for on-device binning: one f64 host
    pass per axis.  Returns (x_rel f32, y_rel f32 (downward-positive),
    (ny, nx), t)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    ny, nx, t, cellsize, _ = _grid_frame(x, y, cellsize, edges)
    x_rel, y_rel = _origin_shift(x, y, t)
    return x_rel, y_rel, (ny, nx), t


def _identity(bin_type):
    if bin_type not in ("max", "min"):
        raise ValueError("This type not supported.")
    return -np.inf if bin_type == "max" else np.inf


def _scatter_into(grid, idx, z, keep, bin_type):
    """Scatter-min/max ``z`` into the flat ``grid`` at ``idx`` (int64), in
    place; entries not ``keep`` carry the identity to cell 0, where they
    change nothing."""
    ident = _identity(bin_type)
    z = torch.where(keep, z, ident)
    idx = torch.where(keep, idx, 0)
    grid.scatter_reduce_(0, idx, z, "amax" if bin_type == "max" else "amin",
                         include_self=True)
    return grid


def _sentinel_to_nan(grid, bin_type):
    """Map only the reduction identity (never a legitimate ±inf data
    value) to NaN — matches scatter_reduce's empty-cell convention."""
    empty = (torch.isneginf(grid) if bin_type == "max"
             else torch.isposinf(grid))
    return torch.where(empty, torch.nan, grid)


def _segment_reduce_sorted(idx, z, n_cells, bin_type):
    """Sort-based segment min/max: sort the (bin, z) pairs by bin, then
    by z within a bin, and gather each cell's segment head (min) or tail
    (max) via ``searchsorted``.  Equivalent to the scatter path but with
    no scatter, as the JAX package's sort method."""
    n = idx.numel()
    if n == 0:
        return torch.full((n_cells,), torch.nan, dtype=z.dtype,
                          device=z.device)
    zs, order = torch.sort(z, stable=True)
    sidx, order2 = torch.sort(idx[order], stable=True)
    sz = zs[order2]
    cells = torch.arange(n_cells, dtype=sidx.dtype, device=sidx.device)
    if bin_type == "max":
        p = torch.searchsorted(sidx, cells, right=True) - 1
    else:
        p = torch.searchsorted(sidx, cells)
    pc = p.clamp(0, n - 1)
    hit = (p >= 0) & (p < n) & (sidx[pc] == cells)
    return torch.where(hit, sz[pc], torch.nan)


_INT32_MAX = 2**31 - 1


def scatter_reduce(flat_index, z, valid, n_cells, bin_type="max",
                   method="scatter", device=None):
    """Device min/max reduction of z into a flat float32 grid of
    n_cells, NaN where empty.

    Invalid points (``valid`` False, or an index off the grid) never
    contribute.  Grids with more than 2**31-1 cells cannot be addressed
    by the flat int32 index of the JAX kernel — they raise here, as
    there; ``create_dem`` routes such grids through the 2-D row/column
    scatter automatically.
    """
    if bin_type not in ("max", "min"):
        raise ValueError("This type not supported.")
    if n_cells > _INT32_MAX:
        raise ValueError(
            f"n_cells={n_cells} exceeds the int32 flat-index range; "
            "use the 2-D (row, col) scatter path (create_dem handles "
            "this automatically)")
    z = to_device(z, device, torch.float32)
    idx = to_device(flat_index, z.device, torch.int64)
    valid = to_device(valid, z.device, torch.bool)
    keep = valid & (idx >= 0) & (idx < n_cells)
    if method == "sort":
        return _segment_reduce_sorted(torch.where(keep, idx, n_cells), z,
                                      n_cells, bin_type)
    grid = torch.full((n_cells,), _identity(bin_type), dtype=torch.float32,
                      device=z.device)
    return _sentinel_to_nan(_scatter_into(grid, idx, z, keep, bin_type),
                            bin_type)


def _scatter_reduce_rc(r, c, z, valid, ny, nx, bin_type, device=None):
    """2-D (row, col) min/max scatter into an (ny, nx) grid: the
    overflow-safe path for grids beyond 2**31 cells (the flat index is
    int64 here, each component checked against its own extent)."""
    z = to_device(z, device, torch.float32)
    r = to_device(r, z.device, torch.int64)
    c = to_device(c, z.device, torch.int64)
    valid = to_device(valid, z.device, torch.bool)
    keep = valid & (r >= 0) & (r < ny) & (c >= 0) & (c < nx)
    grid = torch.full((ny * nx,), _identity(bin_type), dtype=torch.float32,
                      device=z.device)
    grid = _scatter_into(grid, r * nx + c, z, keep, bin_type)
    return _sentinel_to_nan(grid, bin_type).reshape(ny, nx)


def _floor_bins(x_rel, y_rel, inv_cs, ny, nx):
    """Device floor-binning of origin-relative float32 coordinates:
    (row, col) int64 and the in-grid mask."""
    c = torch.floor(x_rel * inv_cs).long()
    r = torch.floor(y_rel * inv_cs).long()
    return r, c, (c >= 0) & (c < nx) & (r >= 0) & (r < ny)


def _grid_fused(x_rel, y_rel, z, inv_cs, ny, nx, bin_type, method):
    """Floor-binning + validity + segment reduction on the device,
    returning the (ny, nx) grid; beyond the int32 flat-index range the
    scatter method switches to the 2-D (row, col) scatter."""
    r, c, valid = _floor_bins(x_rel, y_rel, inv_cs, ny, nx)
    if method == "scatter" and ny * nx > _INT32_MAX:
        return _scatter_reduce_rc(r, c, z, valid, ny, nx, bin_type)
    flat = torch.where(valid, r * nx + c, ny * nx)
    grid = scatter_reduce(flat, z, valid, ny * nx, bin_type=bin_type,
                          method=method)
    return grid.reshape(ny, nx)


def _grid_scatter_accum(grid, x_rel, y_rel, z, inv_cs, ny, nx, bin_type):
    """One streamed chunk: floor-binning + scatter min/max into the
    carried (ny, nx) sentinel grid, in place (±identity empty cells; NaN
    conversion happens once at the end of the stream)."""
    r, c, valid = _floor_bins(x_rel, y_rel, inv_cs, ny, nx)
    _scatter_into(grid.view(-1), r * nx + c, z, valid, bin_type)
    return grid


def _inv_cellsize(t, device):
    return torch.tensor(np.float32(1.0 / t.a), device=device)


def grid_points_device(x, y, z, cellsize=1, bin_type="max", edges=None,
                       method="scatter", chunks=1, device=None):
    """End-to-end device gridding: origin-shift on host, then binning
    and reduction on the device.  Returns (I, t).

    ``chunks>1`` streams the points in equal-size batches, so peak host
    memory is one batch's float32 offsets; min/max scatter is
    order-independent, so the streamed grid is bit-identical to the
    one-batch result.
    """
    if chunks <= 1:
        x_rel, y_rel, (ny, nx), t = bin_points_device(x, y, cellsize,
                                                      edges)
        dev = resolve_device(device)
        grid = _grid_fused(to_device(x_rel, dev), to_device(y_rel, dev),
                           to_device(z, dev, torch.float32),
                           _inv_cellsize(t, dev), ny, nx, bin_type, method)
        return grid, t
    if method != "scatter":
        raise ValueError("chunked streaming requires method='scatter' "
                         "(min/max scatter is order-independent; the "
                         "sort path would re-sort the whole stream)")
    ident = _identity(bin_type)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z)
    ny, nx, t, _, _ = _grid_frame(x, y, cellsize, edges)
    dev = resolve_device(device)
    grid = torch.full((ny, nx), ident, dtype=torch.float32, device=dev)
    inv = _inv_cellsize(t, dev)
    size = -(-x.size // int(chunks))
    for lo in range(0, x.size, size):
        xr, yr = _origin_shift(x[lo:lo + size], y[lo:lo + size], t)
        _grid_scatter_accum(grid, to_device(xr, dev), to_device(yr, dev),
                            to_device(z[lo:lo + size], dev, torch.float32),
                            inv, ny, nx, bin_type)
    return _sentinel_to_nan(grid, bin_type), t


def _upload(a, dev):
    """A host chunk on ``dev``: to a CUDA device from pinned memory with
    ``non_blocking=True``, so the host goes on to decode the next chunk
    while the card scatters this one."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def create_dem_from_las(filename, cellsize=1, bin_type="max",
                        chunk_points=4_000_000, stride=1, bbox=None,
                        classes=None, edges=None, inpaint=False,
                        device=None):
    """Grid a LAS file straight to a DEM in fixed host memory.

    Streams the file through the native decoder (``io/las_native.py``)
    in ``chunk_points`` batches, shifts each batch to the grid origin
    (``origin_shift_native``) and scatters it into the device grid (the
    order-independent min/max accumulation of
    ``create_dem(..., device_bin=True, chunks=N)``, so the grid equals
    the one-shot grid bit for bit), so a LAS file of any size grids in
    the memory of one chunk.  The grid frame comes from the LAS header's
    min/max block, which matches ``create_dem``'s point-derived frame
    whenever the header is truthful; ``bbox`` = (xmin, xmax, ymin, ymax)
    is intersected with that extent; pass ``edges`` to pin the frame.

    ``classes``: optional iterable of ASPRS classification codes to
    keep (e.g. ``(2,)`` for ground-only).  ``bbox`` and ``stride``
    filter/decimate inside the native decoder.  Without the decoder
    (its library could not be built) the file is read whole through
    ``io/las.read_las`` and gridded with ``create_dem(...,
    device_bin=True)`` on the filtered points' own frame, as in the JAX
    package.  Returns (I, t).
    """
    from ..io.las_native import (native_available, read_header,
                                 read_las_chunks)
    if not native_available():
        from ..io.las import read_las
        _, df = read_las(filename)
        if bbox is not None:
            keep = ((df.x >= bbox[0]) & (df.x <= bbox[1])
                    & (df.y >= bbox[2]) & (df.y <= bbox[3]))
            df = df[keep]
        if stride > 1:
            df = df.iloc[::stride]
        if classes is not None:
            df = df[np.isin(np.asarray(df["class"]),
                            np.asarray(list(classes)))]
        return create_dem(df.x, df.y, df.z, cellsize=cellsize,
                          bin_type=bin_type, edges=edges, inpaint=inpaint,
                          device_bin=True, device=device)
    ident = _identity(bin_type)
    hdr = read_header(filename)
    # the LAS header's block is (MaxX, MinX, MaxY, MinY, MaxZ, MinZ)
    xmax, xmin, ymax, ymin = hdr["minmax"][:4]
    if bbox is not None:
        xmin, xmax = max(xmin, bbox[0]), min(xmax, bbox[1])
        ymin, ymax = max(ymin, bbox[2]), min(ymax, bbox[3])
        if xmin > xmax or ymin > ymax:
            raise ValueError(f"bbox {tuple(bbox)} does not overlap the "
                             "file's extent")
    ny, nx, t, _, _ = _grid_frame(np.array([xmin, xmax]),
                                  np.array([ymin, ymax]), cellsize, edges)
    dev = resolve_device(device)
    grid = torch.full((ny, nx), ident, dtype=torch.float32, device=dev)
    inv = _inv_cellsize(t, dev)
    class_arr = (None if classes is None
                 else np.asarray(list(classes), dtype=np.uint8))
    for chunk in read_las_chunks(filename, chunk_points=chunk_points,
                                 stride=stride, bbox=bbox):
        x, y, z = chunk["x"], chunk["y"], chunk["z"]
        if class_arr is not None:
            keep = np.isin(chunk["class"], class_arr)
            x, y, z = x[keep], y[keep], z[keep]
        if x.size == 0:
            continue
        xr, yr = _origin_shift(x, y, t)
        _grid_scatter_accum(grid, _upload(xr, dev), _upload(yr, dev),
                            _upload(z.astype(np.float32), dev), inv, ny,
                            nx, bin_type)
    I = _sentinel_to_nan(grid, bin_type)
    if inpaint:
        from .inpaint import inpaint_nans_by_springs
        I = inpaint_nans_by_springs(I)
    return I, t


def create_dem(x, y, z, cellsize=1, bin_type="max", inpaint=False,
               edges=None, use_binned_statistic=False,
               device_bin=False, method="scatter", chunks=1, device=None):
    """Scatter-to-grid DEM creation (parity: neilpy.py:1110-1166).

    Returns (I, t): the (ny, nx) float32 grid on ``device`` with NaN
    empty cells and the affine transform.  ``inpaint=True``
    spring-inpaints the gaps.  ``device_bin=True`` floors on the device
    (see ``grid_points_device``); the default is the exact host-f64
    binning the reference's pandas groupby uses.  ``chunks>1`` (with
    ``device_bin=True``) streams the cloud in batches — same bits out.
    """
    del use_binned_statistic  # scipy fallback not needed on this path
    if device_bin:
        I, t = grid_points_device(x, y, z, cellsize=cellsize,
                                  bin_type=bin_type, edges=edges,
                                  method=method, chunks=chunks,
                                  device=device)
    else:
        flat, valid, (ny, nx), t = bin_points(x, y, cellsize=cellsize,
                                              edges=edges)
        z = np.asarray(z, dtype=np.float64).astype(np.float32)
        if ny * nx > _INT32_MAX:
            # the flat index does not fit the int32 kernel: split into
            # (row, col) components, each of which does
            if method != "scatter":
                raise ValueError("grids beyond 2**31 cells require "
                                 "method='scatter' (the sort path keys "
                                 "on a flat int32 index)")
            I = _scatter_reduce_rc(flat // nx, flat % nx, z, valid, ny, nx,
                                   bin_type, device=device)
        else:
            I = scatter_reduce(flat, z, valid, ny * nx, bin_type=bin_type,
                               method=method, device=device).reshape(ny, nx)
    if inpaint:
        from .inpaint import inpaint_nans_by_springs
        I = inpaint_nans_by_springs(I)
    return I, t
