"""Pedagogical per-pixel filter callbacks (parity:
neilpy/filters.py:1-276).

Host numpy counterpart of ``neilpy_tpu/filters.py``, the same nine
functions line for line.  They are the slow, didactic per-window
definitions of the fast whole-array functions in ``ops/`` — intended for
use with ``scipy.ndimage.generic_filter`` exactly as the reference
documents (e.g. filters.py:81-90), and as executable specifications in
tests.  They never touch the card.
"""

from __future__ import annotations

import numpy as np

__all__ = ["topographic_position_index_filter", "terrain_ruggedness",
           "esri_planar_slope", "grid_distance", "skyview_filter",
           "openness_filter", "fetch_values", "life_filter",
           "esri_curvature"]


def topographic_position_index_filter(X):
    """(center - mean(rest)) / std(rest) (parity: filters.py:9-24)."""
    X = np.ravel(X)
    center = int(np.floor(X.size / 2))
    center_value = X[center]
    rest = np.delete(X, center)
    value = (center_value - np.nanmean(rest)) / np.nanstd(rest)
    if np.isnan(value) and np.isfinite(center_value):
        value = 0
    return value


def terrain_ruggedness(X):
    """TRI, Riley et al. 1999 (parity: filters.py:31-56)."""
    X = np.ravel(X)
    n = X.size
    center = int(n / 2)
    return np.sqrt(np.sum((X - X[center]) ** 2) / (n - 1))


def esri_planar_slope(X, cellsize=1, degrees=True):
    """Horn 3x3 slope (parity: filters.py:59-101): central columns/
    rows weighted double, edge difference over 8 cell widths."""
    X = np.asarray(X, dtype=float).reshape(3, 3)
    horn = np.array([1.0, 2.0, 1.0]) / 8.0
    dz_dx = (X[:, 2] - X[:, 0]) @ horn
    dz_dy = (X[2, :] - X[0, :]) @ horn
    S = np.hypot(dz_dx, dz_dy) / cellsize
    if degrees:
        S = np.rad2deg(np.arctan(S))
    return S


def grid_distance(shp):
    """Distance-from-center grid (parity: filters.py:107-113)."""
    gx, gy = np.mgrid[0:shp[0], 0:shp[1]]
    center = int(shp[0] / 2)
    return np.hypot(gx - center, gy - center)


def skyview_filter(X, cellsize=1):
    """Windowed skyview factor (parity: filters.py:118-137)."""
    w = int(np.sqrt(np.size(X)))
    c = int(w / 2)
    X = X.reshape(w, w)
    height = np.clip(X - X[c, c], 0, np.inf)
    height[c, c] = np.nan
    with np.errstate(invalid="ignore", divide="ignore"):
        horizon = np.arctan(height / (cellsize * grid_distance(X.shape)))
    max_angles = [np.nanmax(fetch_values(horizon, i)) for i in range(8)]
    return 1 - np.mean(np.sin(max_angles))


def openness_filter(X, cellsize=1, skyview=False):
    """Windowed openness (parity: filters.py:142-170): per-direction
    minimum zenith angle to any window cell, averaged over the 8
    compass rays."""
    w = int(np.sqrt(np.size(X)))
    c = w // 2
    rel = np.reshape(X, (w, w)) - np.ravel(X)[np.size(X) // 2]
    rr, cc = np.ogrid[-c: w - c, -c: w - c]
    dist = cellsize * np.hypot(rr, cc)
    dist[c, c] = np.inf
    O = 90 - np.rad2deg(np.arctan(rel / dist))
    angles = np.array([np.min(fetch_values(O, d)) for d in range(8)])
    if skyview:
        angles = np.sin(np.minimum(angles, 90))
    return np.mean(angles)


def fetch_values(X, direction):
    """Ray of window values from the center outward in compass
    direction 0-7 (parity: filters.py:174-192)."""
    n_rows = X.shape[0]
    c = int(np.floor(n_rows / 2))
    down = np.arange(c + 1, 2 * c + 1)
    up = np.arange(c - 1, -1, -1)
    rays = {
        0: (up, up), 1: (up, np.full_like(up, c)),
        2: (up, np.arange(c + 1, n_rows)), 3: (np.full_like(down, c), down),
        4: (down, down), 5: (down, np.full_like(down, c)),
        6: (down, np.arange(c - 1, -1, -1)), 7: (np.full_like(up, c), up),
    }
    r, cc = rays[direction]
    return X[r, cc]


def life_filter(neighborhood):
    """Conway's Game of Life step (parity: filters.py:198-212)."""
    nb = neighborhood.reshape((3, 3))
    this_cell = nb[1, 1]
    live = np.sum(nb) - this_cell
    if this_cell == 1:
        return 1 if live in (2, 3) else 0
    return 1 if live == 3 else 0


def esri_curvature(X, cellsize=1, kind="curvature"):
    """3x3 ESRI curvature/plan/profile (parity: filters.py:216-276)."""
    X = X.reshape((3, 3))
    L = cellsize
    Z1, Z2, Z3 = X[0]
    Z4, Z5, Z6 = X[1]
    Z7, Z8, Z9 = X[2]
    D = ((Z4 + Z6) / 2 - Z5) / L ** 2
    E = ((Z2 + Z8) / 2 - Z5) / L ** 2
    F = (-Z1 + Z3 + Z7 - Z9) / (4 * L ** 2)
    G = (-Z4 + Z6) / (2 * L)
    H = (Z2 - Z8) / (2 * L)
    if kind == "curvature":
        val = -200 * (D + E)
        return 0.0 if np.isnan(val) else val
    P4 = G ** 2 + H ** 2
    with np.errstate(invalid="ignore", divide="ignore"):
        if kind == "plan":
            val = -200 * ((D * H ** 2 + E * G ** 2 - F * G * H) / P4)
        elif kind == "profile":
            val = 200 * ((D * G ** 2 + E * H ** 2 + F * G * H) / P4)
        else:
            raise ValueError(kind)
    return 0.0 if np.isnan(val) else val
