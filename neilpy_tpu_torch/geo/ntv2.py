"""NTv2 datum-shift grid reader and interpolator.

Parity surface: the grid-interpolated datum transforms pyproj applies
implicitly inside ``coord_transform`` (reference neilpy/neilpy.py:
108-110) for classic European / NZ datums — DHDN (BETA2007), CH1903
(CHENyx06), NTF (ntf_r93), NZGD49 (nzgd2kgrid0005) — using the .gsb
files shipped with the system PROJ installation.

NTv2 container layout (Natural Resources Canada spec): an 11-record
overview header, then per-subgrid an 11-record header followed by
``GS_COUNT`` nodes of four float32 values (latitude shift, longitude
shift, accuracies) in arc-seconds.  All positions are arc-seconds
with **longitude positive west**; node order runs east to west
fastest, then south to north.  Shifts map source datum -> target
datum; the inverse direction iterates.
"""

from __future__ import annotations

import os
import struct
from functools import lru_cache

import numpy as np

_PROJ_DATA_DIR = "/usr/share/proj"


def _find_grid_file(name):
    """Resolve a PROJ grid filename case-insensitively (the database
    records 'CHENyx06_ETRS.gsb' while the file on disk is
    'CHENYX06_etrs.gsb')."""
    path = os.path.join(_PROJ_DATA_DIR, name)
    if os.path.exists(path):
        return path
    low = name.lower()
    try:
        for fn in os.listdir(_PROJ_DATA_DIR):
            if fn.lower() == low:
                return os.path.join(_PROJ_DATA_DIR, fn)
    except OSError as e:
        import logging
        logging.getLogger(__name__).debug(
            "PROJ data dir %s unreadable (%s); datum grids unavailable",
            _PROJ_DATA_DIR, e)
    return None


class _SubGrid:
    __slots__ = ("s_lat", "n_lat", "e_lon", "w_lon", "lat_inc",
                 "lon_inc", "nrows", "ncols", "dlat", "dlon")

    def __init__(self, s_lat, n_lat, e_lon, w_lon, lat_inc, lon_inc,
                 dlat, dlon):
        self.s_lat, self.n_lat = s_lat, n_lat
        self.e_lon, self.w_lon = e_lon, w_lon      # positive west!
        self.lat_inc, self.lon_inc = lat_inc, lon_inc
        self.nrows, self.ncols = dlat.shape
        self.dlat, self.dlon = dlat, dlon

    def contains(self, lon_deg, lat_deg):
        lat = lat_deg * 3600.0
        lonw = -lon_deg * 3600.0
        return ((self.s_lat <= lat) & (lat <= self.n_lat)
                & (self.e_lon <= lonw) & (lonw <= self.w_lon))

    def interpolate(self, lon_deg, lat_deg):
        """Bilinear shift (dlat_sec, dlon_west_sec) at geographic
        degrees; positions outside the grid are clamped to the edge
        (callers gate on ``contains``)."""
        lat = np.asarray(lat_deg, dtype=np.float64) * 3600.0
        lonw = -np.asarray(lon_deg, dtype=np.float64) * 3600.0
        fr = np.clip((lat - self.s_lat) / self.lat_inc, 0,
                     self.nrows - 1 - 1e-9)
        fc = np.clip((lonw - self.e_lon) / self.lon_inc, 0,
                     self.ncols - 1 - 1e-9)
        r0 = np.floor(fr).astype(np.int64)
        c0 = np.floor(fc).astype(np.int64)
        wr = fr - r0
        wc = fc - c0
        out = []
        for g in (self.dlat, self.dlon):
            v = ((1 - wr) * (1 - wc) * g[r0, c0]
                 + (1 - wr) * wc * g[r0, c0 + 1]
                 + wr * (1 - wc) * g[r0 + 1, c0]
                 + wr * wc * g[r0 + 1, c0 + 1])
            out.append(v)
        return out[0], out[1]


def _read_records(buf, off, n, order):
    recs = {}
    for i in range(n):
        rec = buf[off + i * 16: off + (i + 1) * 16]
        key = rec[:8].decode("latin1").strip()
        recs[key] = rec[8:16]
    return recs


def _int(v, order):
    return struct.unpack(order + "i", v[:4])[0]


def _dbl(v, order):
    return struct.unpack(order + "d", v)[0]


@lru_cache(maxsize=8)
def load_ntv2(path):
    """Parse an NTv2 .gsb file into a tuple of ``_SubGrid``."""
    with open(path, "rb") as f:
        buf = f.read()
    order = "<"
    if struct.unpack("<i", buf[8:12])[0] != 11:
        order = ">"
        if struct.unpack(">i", buf[8:12])[0] != 11:
            raise ValueError(f"{path}: not an NTv2 file")
    over = _read_records(buf, 0, 11, order)
    n_sub = _int(over["NUM_FILE"], order)
    off = 11 * 16
    subs = []
    for _ in range(n_sub):
        h = _read_records(buf, off, 11, order)
        off += 11 * 16
        count = _int(h["GS_COUNT"], order)
        s_lat = _dbl(h["S_LAT"], order)
        n_lat = _dbl(h["N_LAT"], order)
        e_lon = _dbl(h["E_LONG"], order)
        w_lon = _dbl(h["W_LONG"], order)
        lat_inc = _dbl(h["LAT_INC"], order)
        lon_inc = _dbl(h["LONG_INC"], order)
        nrows = int(round((n_lat - s_lat) / lat_inc)) + 1
        ncols = int(round((w_lon - e_lon) / lon_inc)) + 1
        if nrows * ncols != count:
            raise ValueError(
                f"{path}: subgrid node count {count} != "
                f"{nrows}x{ncols}")
        nodes = np.frombuffer(buf, dtype=order + "f4",
                              count=count * 4, offset=off)
        off += count * 16
        nodes = nodes.reshape(count, 4)
        dlat = nodes[:, 0].reshape(nrows, ncols).astype(np.float64)
        dlon = nodes[:, 1].reshape(nrows, ncols).astype(np.float64)
        subs.append(_SubGrid(s_lat, n_lat, e_lon, w_lon, lat_inc,
                             lon_inc, dlat, dlon))
    # densest (child) grids take priority at lookup time
    subs.sort(key=lambda s: s.lat_inc)
    return tuple(subs)


def grid_covers(path, lon, lat):
    """True when every point falls inside some subgrid."""
    subs = load_ntv2(path)
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    inside = np.zeros(np.broadcast(lon, lat).shape, dtype=bool)
    for s in subs:
        inside |= s.contains(lon, lat)
    return bool(np.all(inside))


def _shift_once(subs, lon, lat):
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    dlat = np.zeros(np.broadcast(lon, lat).shape, dtype=np.float64)
    dlon = np.zeros_like(dlat)
    done = np.zeros_like(dlat, dtype=bool)
    for s in subs:                       # densest first
        sel = s.contains(lon, lat) & ~done
        if not np.any(sel):
            continue
        a, o = s.interpolate(lon, lat)
        dlat = np.where(sel, a, dlat)
        dlon = np.where(sel, o, dlon)
        done |= sel
    return dlat, dlon


def apply_grid(path, lon, lat, inverse=False):
    """Apply an NTv2 shift: source datum -> target datum (degrees).

    ``inverse=True`` recovers source coordinates from target ones by
    fixed-point iteration (the NTv2-specified reverse method; 4
    rounds reach sub-0.1 mm for these grids).  Points outside every
    subgrid pass through unchanged — callers that need a hard
    guarantee check ``grid_covers`` first.
    """
    subs = load_ntv2(path)
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    if not inverse:
        dlat, dlon = _shift_once(subs, lon, lat)
        return lon - dlon / 3600.0, lat + dlat / 3600.0
    glon, glat = lon, lat
    for _ in range(4):
        dlat, dlon = _shift_once(subs, glon, glat)
        glon = lon + dlon / 3600.0
        glat = lat - dlat / 3600.0
    return glon, glat
