"""EGM96 geoid undulation from the system PROJ GTX grid.

Beyond-parity helper for the photogrammetry/GNSS stack (reference
neilpy/neilpy.py:2321-2391 works in whatever height system the inputs
carry): GNSS heights are ellipsoidal while DEMs and LAS clouds are
orthometric, and the difference (the geoid undulation N, -107..+85 m
globally) matters at lidar accuracy class.  This reads the
``egm96_15.gtx`` grid shipped with PROJ (15-arc-minute EGM96) and
interpolates it bilinearly, the same thing PROJ's
``EPSG:4979 -> EPSG:9707`` pipeline does.

GTX layout: four big-endian float64 (south lat, west lon, dlat, dlon)
and two big-endian int32 (nrows, ncols), then nrows*ncols big-endian
float32 undulations, row-major from the south-west corner.
"""

from __future__ import annotations

import os
import struct
from functools import lru_cache

import numpy as np

__all__ = ["geoid_height", "ellipsoidal_to_orthometric",
           "orthometric_to_ellipsoidal"]

_DEFAULT_GTX = "/usr/share/proj/egm96_15.gtx"


@lru_cache(maxsize=4)
def _load_gtx(path):
    with open(path, "rb") as f:
        head = f.read(40)
        s_lat, w_lon, dlat, dlon, nrows, ncols = struct.unpack(
            ">4d2i", head)
        grid = np.frombuffer(f.read(nrows * ncols * 4),
                             dtype=">f4").reshape(nrows, ncols)
    return s_lat, w_lon, dlat, dlon, grid.astype(np.float64)


def geoid_height(lon, lat, path=_DEFAULT_GTX):
    """Geoid undulation N (metres above the WGS84 ellipsoid) from the
    EGM96 grid, bilinear, with longitude wrap-around."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"geoid grid {path} not found (PROJ data not installed?)")
    s_lat, w_lon, dlat, dlon, grid = _load_gtx(path)
    nrows, ncols = grid.shape
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    fr = np.clip((lat - s_lat) / dlat, 0, nrows - 1 - 1e-9)
    fc = ((lon - w_lon) % 360.0) / dlon
    r0 = np.floor(fr).astype(np.int64)
    c0 = np.floor(fc).astype(np.int64) % ncols
    c1 = (c0 + 1) % ncols                # wrap across the antimeridian
    wr = fr - r0
    wc = fc - np.floor(fc)
    r1 = np.minimum(r0 + 1, nrows - 1)
    return ((1 - wr) * (1 - wc) * grid[r0, c0]
            + (1 - wr) * wc * grid[r0, c1]
            + wr * (1 - wc) * grid[r1, c0]
            + wr * wc * grid[r1, c1])


def ellipsoidal_to_orthometric(h, lon, lat, path=_DEFAULT_GTX):
    """GNSS (ellipsoidal) height -> orthometric (EGM96) height."""
    return np.asarray(h, dtype=np.float64) - geoid_height(lon, lat,
                                                          path)


def orthometric_to_ellipsoidal(h, lon, lat, path=_DEFAULT_GTX):
    """Orthometric (EGM96) height -> GNSS (ellipsoidal) height."""
    return np.asarray(h, dtype=np.float64) + geoid_height(lon, lat,
                                                          path)
