"""SMRF — the Simple Morphological Filter (Pingel, Clarke & McBride
2013) for lidar ground/object classification.

PyTorch counterpart of ``neilpy_tpu/pipelines/smrf.py``, with the same
names, arguments and results plus ``device=`` (CUDA unless
``device='cpu'``).  Reference call stack (neilpy/neilpy.py:1659-1808):
``create_dem(min)`` -> spring inpaint -> low-outlier pass ->
progressive morphological opening ladder -> inpaint provisional DTM ->
bicubic spline lift back to points -> slope-adaptive threshold.

The host does the float64 bin-index and inverse-affine math; the
minimum-surface scatter, the spring inpaints, the opening ladder, the
slope and the spline lift run on the device.  The JAX package's fused
jitted stages are plain functions here: ``_progressive_ladder``,
``_smrf_raster`` and ``_smrf_points``.  ``precision='exact'`` runs the
same stages in float64 on the chosen device (the JAX package detours to
its CPU backend, the TPU having no float64), fed by the float64 host
scatter, with the CG solves at tol=1e-12.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from ..core.device import resolve_device, to_device
from ..core.shift import gradient2d
from ..ops.inpaint import _springs_core
from ..ops.morphology import _disk_morph
from ..ops.pointgrid import bin_points, create_dem, create_dem_from_las
from ..ops.spline import spline_coefficients_2d, spline_ev_2d

__all__ = ["progressive_filter", "smrf", "smrf_las"]


def _no_mark(stage, **info):
    """The default stage hook: records nothing (``chip_smoke.py`` passes
    one that records a CUDA event and the stage's CG counts)."""


def _opening(Z, window):
    return _disk_morph(_disk_morph(Z, window, torch.minimum), window,
                       torch.maximum)


def _progressive_ladder(Z, windows, thresholds, return_when_dropped):
    """The opening ladder: each radius opens the previous radius's
    surface and flags cells dropping by more than its threshold."""
    last_surface = Z
    is_object = torch.zeros(Z.shape, dtype=torch.bool, device=Z.device)
    when_dropped = torch.zeros(Z.shape, dtype=torch.uint8, device=Z.device)
    for i, window in enumerate(windows):
        opened = _opening(last_surface, window)
        new_obj = (last_surface - opened) > thresholds[i]
        is_object |= new_obj
        if return_when_dropped:
            when_dropped.masked_fill_(new_obj, i)
        last_surface = opened
    return is_object, when_dropped


def _thresholds(windows, slope_threshold, cellsize, dtype, device):
    """``slope_threshold * w * cellsize`` per window, computed in float64
    on the host and rounded to the pipeline's dtype, as the JAX package
    does."""
    return torch.as_tensor(slope_threshold * (windows * cellsize),
                           dtype=dtype, device=device)


def progressive_filter(Z, windows, cellsize=1, slope_threshold=.15,
                       return_when_dropped=False, device=None):
    """Progressive morphological opening ladder (parity:
    neilpy.py:1659-1681), float32.

    For each window radius w: grey-open the cascaded surface with
    ``disk(w)`` and flag cells dropping more than
    ``slope_threshold * w * cellsize`` as objects.  The reference
    computes (and ignores) a 3x3 override for w==1 — actual behaviour
    is ``opening(disk(w))`` for every w, which is what is replicated.
    """
    windows = np.atleast_1d(np.asarray(windows))
    Z = to_device(Z, device, torch.float32)
    is_object, when_dropped = _progressive_ladder(
        Z, tuple(int(w) for w in windows),
        _thresholds(windows, slope_threshold, cellsize, torch.float32,
                    Z.device), bool(return_when_dropped))
    if return_when_dropped:
        return is_object, when_dropped
    return is_object


def _smrf_raster(Zmin_raw, windows, thresholds, low_threshold, cellsize,
                 low_outlier_fill, return_extras, inpaint_tol=1e-7,
                 inpaint_maxiter=4000, mark=_no_mark):
    """All grid-shaped SMRF stages: spring inpaint -> low-outlier opening
    -> progressive ladder -> provisional-DTM inpaint -> spline
    coefficients of the DTM and of its slope.  ``mark(stage, **info)`` is
    called after each stage."""
    is_empty_cell = torch.isnan(Zmin_raw)
    Zmin, info = _springs_core(Zmin_raw, inpaint_tol, inpaint_maxiter)
    mark("springs_fill", **info)

    neg = -Zmin
    low_outliers = (neg - _opening(neg, 1)) > low_threshold
    mark("low_outlier_opening")

    if low_outlier_fill:
        Zmin, info = _springs_core(torch.where(low_outliers, torch.nan,
                                               Zmin),
                                   inpaint_tol, inpaint_maxiter)
        mark("springs_refill", **info)

    object_cells, when_dropped = _progressive_ladder(
        Zmin, windows, thresholds, return_extras)
    mark("ladder")

    object_cells = is_empty_cell | low_outliers | object_cells
    Zpro, info = _springs_core(torch.where(object_cells, torch.nan, Zmin),
                               inpaint_tol, inpaint_maxiter)
    mark("springs_fill_dtm", **info)

    coeffs_Z = spline_coefficients_2d(Zpro)
    gy, gx = gradient2d(Zpro, cellsize)
    coeffs_S = spline_coefficients_2d(torch.sqrt(gy ** 2 + gx ** 2))
    mark("spline_coefficients")
    return Zpro, object_cells, when_dropped, coeffs_Z, coeffs_S


def _smrf_points(coeffs_Z, coeffs_S, r, c, z, elevation_threshold,
                 elevation_scaler):
    """Point-shaped SMRF tail: bicubic lift of the DTM and slope surfaces
    onto the points + the adaptive threshold test (reference:
    neilpy.py:1768-1795), in the coefficients' dtype."""
    elevation_values = spline_ev_2d(coeffs_Z, r, c, offset=0.5)
    slope_values = spline_ev_2d(coeffs_S, r, c, offset=0.5)
    required_value = elevation_threshold + elevation_scaler * slope_values
    is_object_point = torch.abs(elevation_values - z) > required_value
    return is_object_point, elevation_values


def _smrf_points_streamed(coeffs_Z, coeffs_S, r, c, z,
                          elevation_threshold, elevation_scaler,
                          chunk_points, need_elev=True):
    """Chunk-streamed point phase: the classification is element-wise
    per point, so the host arrays go to the device and through the point
    stage ``chunk_points`` at a time, and the results concatenate on the
    device; labels are bit-identical to the one-shot call.  The
    elevation plane is only assembled when the caller wants extras."""
    dev, dt = coeffs_Z[0].device, coeffs_Z[0].dtype
    is_obj, elev = [], []
    for i in range(0, r.size, chunk_points):
        o, e = _smrf_points(coeffs_Z, coeffs_S,
                            to_device(r[i:i + chunk_points], dev, dt),
                            to_device(c[i:i + chunk_points], dev, dt),
                            to_device(z[i:i + chunk_points], dev, dt),
                            elevation_threshold, elevation_scaler)
        is_obj.append(o)
        if need_elev:
            elev.append(e)
    return torch.cat(is_obj), (torch.cat(elev) if need_elev else None)


def _min_surface_exact(x64, y64, z64, cellsize):
    """The exact path's float64 host scatter: bin indices, then
    ``np.minimum.at``, NaN where empty."""
    flat, valid, (ny, nx), t = bin_points(x64, y64, cellsize=cellsize)
    Zmin = np.full(ny * nx, np.inf)
    np.minimum.at(Zmin, flat[valid], z64[valid])
    Zmin[np.isinf(Zmin)] = np.nan
    return Zmin.reshape(ny, nx), t


def smrf(x, y, z, cellsize=1, windows=5, slope_threshold=.15,
         elevation_threshold=.5, elevation_scaler=1.25,
         low_filter_slope=5, low_outlier_fill=False, return_extras=False,
         precision="fast", chunk_points=2_000_000, device=None):
    """Simple Morphological Filter (parity: neilpy.py:1685-1808).

    Returns (Zpro, t, object_cells, is_object_point[, extras]):
    provisional DTM, affine transform, boolean object grid, and the
    per-point object classification, as tensors on ``device``.

    ``precision='fast'`` (default) runs float32 on the device: the
    gridding scatter, the raster stage and the point stage.  Clouds
    larger than ``chunk_points`` stream the point stage in chunks,
    bit-identical to the one-shot call.

    ``precision='exact'`` runs the same stages in float64 on the same
    device, fed by the float64 host scatter, with the CG solves at
    tol=1e-12: bit-for-bit the reference's f64 numpy/scipy numerics on
    the object masks and point labels (reference decision points
    neilpy.py:1676, 1794-1795).  The float32 fast path agrees with it on
    >=99.9% of points.
    """
    return _smrf_run(x, y, z, cellsize, windows, slope_threshold,
                     elevation_threshold, elevation_scaler,
                     low_filter_slope, low_outlier_fill, return_extras,
                     precision, chunk_points, device)


def _windows(windows):
    if np.isscalar(windows):
        windows = np.arange(windows) + 1
    return np.atleast_1d(np.asarray(windows))


def _smrf_run(x, y, z, cellsize, windows, slope_threshold,
              elevation_threshold, elevation_scaler, low_filter_slope,
              low_outlier_fill, return_extras, precision, chunk_points,
              device, mark=_no_mark):
    """``smrf``'s body, with ``mark(stage, **info)`` called after each
    stage (the host legs too: ``chip_smoke.py`` times them)."""
    if precision not in ("fast", "exact"):
        raise ValueError("precision must be 'fast' or 'exact'")
    windows = _windows(windows)
    dev = resolve_device(device)
    x64 = np.asarray(x, dtype=np.float64)
    y64 = np.asarray(y, dtype=np.float64)
    z64 = np.asarray(z, dtype=np.float64)

    if precision == "exact":
        dt = torch.float64
        Zmin, t = _min_surface_exact(x64, y64, z64, cellsize)
        mark("host_scatter")
        Zmin_raw = to_device(Zmin, dev)
        mark("h2d_grid")
        raster_kw = dict(inpaint_tol=1e-12, inpaint_maxiter=100_000)
        cellsize_t = np.float64(cellsize)
    else:
        dt = torch.float32
        Zmin_raw, t = create_dem(x64, y64, z64, cellsize=cellsize,
                                 bin_type="min", device=dev)
        mark("gridding")
        raster_kw = {}
        cellsize_t = cellsize
    Zpro, object_cells, drop_raster, coeffs_Z, coeffs_S = _smrf_raster(
        Zmin_raw, tuple(int(w) for w in windows),
        _thresholds(windows, slope_threshold, cellsize_t, dt, dev),
        torch.tensor(low_filter_slope * cellsize, dtype=dt, device=dev),
        float(cellsize), bool(low_outlier_fill), bool(return_extras),
        mark=mark, **raster_kw)

    # host f64 inverse affine for the point coordinates (precision)
    c, r = (~t) * (x64, y64)
    mark("host_inverse_affine")
    eth = torch.tensor(elevation_threshold, dtype=dt, device=dev)
    esc = torch.tensor(elevation_scaler, dtype=dt, device=dev)
    if r.size > int(chunk_points):
        is_object_point, elevation_values = _smrf_points_streamed(
            coeffs_Z, coeffs_S, r, c, z64, eth, esc, int(chunk_points),
            need_elev=bool(return_extras))
    else:
        is_object_point, elevation_values = _smrf_points(
            coeffs_Z, coeffs_S, to_device(r, dev, dt), to_device(c, dev, dt),
            to_device(z64, dev, dt), eth, esc)
    mark("points")

    if return_extras:
        rr = np.clip(np.round(r).astype(int), 0, Zpro.shape[0] - 1)
        cc = np.clip(np.round(c).astype(int), 0, Zpro.shape[1] - 1)
        extras = {
            "above_ground_height": to_device(z64, dev, dt) - elevation_values,
            "drop_raster": drop_raster,
            "when_dropped": drop_raster.cpu().numpy()[rr, cc],
        }
        return Zpro, t, object_cells, is_object_point, extras
    return Zpro, t, object_cells, is_object_point


def smrf_las(filename, out_filename, cellsize=1, windows=5,
             slope_threshold=.15, elevation_threshold=.5,
             elevation_scaler=1.25, low_filter_slope=5,
             low_outlier_fill=False, chunk_points=4_000_000,
             ground_class=2, object_class=1, device=None):
    """Streamed end-to-end SMRF over a whole LAS file: grid, filter,
    classify every point, and write the ASPRS classification codes
    back — in the fixed memory of one chunk, whatever the file size.

    Pass 1 streams the file through the native decoder into the device
    scatter (``create_dem_from_las``), the raster stage runs once on the
    device, and pass 2 re-streams the points through the spline-lift
    classifier ``chunk_points`` at a time.  The output file is a
    byte-exact copy of the input — every attribute, VLR and waveform
    block preserved — with ONLY the per-record classification field
    rewritten (``ground_class`` / ``object_class``; PDRF 0-5 keep their
    synthetic/keypoint/withheld flag bits, PDRF 6-10 their separate flag
    byte).  Without the native decoder both passes read the file through
    ``io/las.read_las``, as in the JAX package.

    Returns ``(Zpro, t, object_cells, stats)`` — the provisional DTM,
    its affine transform, the object-cell grid, and a dict with
    ``n_points`` / ``n_ground`` / ``n_object``.  The grid frame comes
    from the LAS header's min/max block (see ``create_dem_from_las``);
    classification decisions match ``smrf(x, y, z, ...)`` run in-memory
    on the same frame (reference pipeline: neilpy.py:1685-1808).
    """
    from ..io.las_native import native_available

    if os.path.abspath(str(filename)) == os.path.abspath(str(out_filename)):
        raise ValueError("out_filename must differ from the input file")
    for name, v in (("ground_class", ground_class),
                    ("object_class", object_class)):
        if not 0 <= int(v) <= 255:
            raise ValueError(f"{name} must be a uint8 ASPRS code")
    windows = _windows(windows)
    dev = resolve_device(device)
    chunk_points = max(int(chunk_points), 1)

    # ---- pass 1: streamed min-surface gridding + raster stage ----
    Zmin_raw, t = create_dem_from_las(filename, cellsize=cellsize,
                                      bin_type="min",
                                      chunk_points=chunk_points, device=dev)
    Zpro, object_cells, _, coeffs_Z, coeffs_S = _smrf_raster(
        Zmin_raw, tuple(int(w) for w in windows),
        _thresholds(windows, slope_threshold, cellsize, torch.float32, dev),
        torch.tensor(low_filter_slope * cellsize, dtype=torch.float32,
                     device=dev),
        float(cellsize), bool(low_outlier_fill), False)

    # ---- header facts for the classification byte-patch ----
    if native_available():
        from ..io.las_native import read_header, read_las_chunks
        hdr = read_header(filename)
        chunks = read_las_chunks(filename, chunk_points=chunk_points)
    else:
        from ..io.las import read_las
        hdr, df = read_las(filename)
        chunks = iter([{"x": np.asarray(df.x, dtype=np.float64),
                        "y": np.asarray(df.y, dtype=np.float64),
                        "z": np.asarray(df.z, dtype=np.float64)}])
    pdrf = int(hdr["point_data_format_id"])
    if pdrf <= 5:
        # PDRF 0-5 keep only 5 bits of classification (LAS 1.1-1.3
        # table 8): a code > 31 would be silently rewritten as a
        # different class by the & 0x1F below — reject it instead
        for name, v in (("ground_class", ground_class),
                        ("object_class", object_class)):
            if int(v) > 31:
                raise ValueError(
                    f"{name}={int(v)} does not fit PDRF {pdrf}'s 5-bit "
                    "classification field (codes 0-31)")
    reclen = int(hdr["point_data_record_length"])
    off0 = int(hdr["point_data_offset"])
    n = int(hdr["num_point_records"])
    # classification byte: PDRF 0-5 share it with the 3 flag bits
    # (LAS 1.1-1.3 spec table 8); PDRF 6-10 give it a full byte
    cls_off = 15 if pdrf <= 5 else 16

    # ---- pass 2: copy, then re-stream points -> classify -> patch ----
    shutil.copyfile(filename, out_filename)
    mm = np.memmap(out_filename, dtype=np.uint8, mode="r+")
    # strided writable view over each record's classification byte
    cls_view = mm[off0 + cls_off: off0 + (n - 1) * reclen + cls_off + 1:
                  reclen]
    eth = torch.tensor(elevation_threshold, dtype=torch.float32, device=dev)
    esc = torch.tensor(elevation_scaler, dtype=torch.float32, device=dev)
    n_object = 0
    pos = 0
    for chunk in chunks:
        x64 = np.asarray(chunk["x"], dtype=np.float64)
        y64 = np.asarray(chunk["y"], dtype=np.float64)
        z64 = np.asarray(chunk["z"], dtype=np.float64)
        m = x64.size
        c, r = (~t) * (x64, y64)
        is_obj, _ = _smrf_points_streamed(coeffs_Z, coeffs_S, r, c, z64,
                                          eth, esc, chunk_points,
                                          need_elev=False)
        is_obj = is_obj.cpu().numpy()
        cls = np.where(is_obj, np.uint8(object_class),
                       np.uint8(ground_class)).astype(np.uint8)
        if pdrf <= 5:
            cls_view[pos:pos + m] = ((cls_view[pos:pos + m] & 0xE0)
                                     | (cls & 0x1F))
        else:
            cls_view[pos:pos + m] = cls
        n_object += int(is_obj.sum())
        pos += m
    mm.flush()
    if pos != n:
        raise RuntimeError(
            f"classified {pos} of {n} header-declared points — "
            "truncated or inconsistent LAS file")
    stats = {"n_points": n, "n_object": n_object,
             "n_ground": n - n_object}
    return Zpro, t, object_cells, stats
