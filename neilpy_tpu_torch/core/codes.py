"""Terrain-code arithmetic, structuring elements and scan ladders.

Host-side (numpy) helpers that produce *static* lookup tables and
kernel footprints consumed by the device code.  A copy of
``neilpy_tpu/core/codes.py`` (numpy only), so the PyTorch package needs
no JAX; ``tests/test_torch_core_io.py`` holds every table equal to the
JAX package's.

Parity targets: neilpy/neilpy.py:1314-1321 (progressive_window),
1438-1448 (int2base), 1466-1474 (get_lowest_equivalent), 1490-1527
(terrain_code_to_geomorphon), 2450-2466 (distance_kernel), plus
skimage.morphology.disk used throughout SMRF.
"""

from __future__ import annotations

import functools

import numpy as np


def int2base(x, b, alphabet="0123456789abcdefghijklmnopqrstuvwxyz",
             min_digits=8):
    """Integer -> fixed-width base-``b`` string (neilpy.py:1438-1448)."""
    digits = ""
    x = int(x)
    while x > 0:
        x, idx = divmod(x, b)
        digits = alphabet[idx] + digits
    return digits.rjust(min_digits, "0")


def get_lowest_equivalent(terrain_code):
    """Canonical (lowest) rotational/reflectional equivalent of an
    8-digit base-3 terrain code (neilpy.py:1466-1474).

    The 8 directional digits live on a ring; the canonical form is the
    minimum base-10 value over the dihedral orbit (8 rotations x
    reflection).
    """
    s = int2base(terrain_code, 3)
    candidates = []
    for variant in (s, s[::-1]):
        for k in range(8):
            candidates.append(int(variant[k:] + variant[:k], 3))
    return min(candidates)


@functools.lru_cache(maxsize=None)
def lowest_equivalent_table():
    """uint16 LUT of length 3**8 mapping code -> canonical code."""
    return np.array([get_lowest_equivalent(i) for i in range(3 ** 8)],
                    dtype=np.uint16)


# Jasiewicz & Stepinski (2013) Fig. 4 lookup: rows = number of cells
# higher, cols = number of cells lower -> geomorphon class 1-10.
# (neilpy.py:1623-1635; identical table at 1510-1521.)
def jasiewicz_stepinski_table():
    t = np.zeros((9, 9), dtype=np.uint8)
    t[0, :] = [1, 1, 1, 8, 8, 9, 9, 9, 10]
    t[1, :8] = [1, 1, 8, 8, 8, 9, 9, 9]
    t[2, :7] = [1, 4, 6, 6, 7, 7, 9]
    t[3, :6] = [4, 4, 6, 6, 6, 7]
    t[4, :5] = [4, 4, 5, 6, 6]
    t[5, :4] = [3, 3, 5, 5]
    t[6, :3] = [3, 3, 3]
    t[7, :2] = [3, 3]
    t[8, :1] = [2]
    return t


@functools.lru_cache(maxsize=None)
def terrain_code_class_table(method="loose"):
    """LUT of length 3**8: terrain code -> geomorphon class
    (neilpy.py:1490-1527).  'strict' matches exact canonical codes;
    'loose' applies the J&S count table to each code's digit counts."""
    lut = np.zeros(3 ** 8, dtype=np.uint8)
    if method == "strict":
        for code, cls in ((3280, 1), (0, 2), (82, 3), (121, 4), (26, 5),
                          (160, 6), (242, 7), (3293, 8), (4346, 9),
                          (6560, 10)):
            lut[code] = cls
    elif method == "loose":
        js = jasiewicz_stepinski_table()
        for i in range(3 ** 8):
            s = int2base(i, 3)
            lut[i] = js[s.count("2"), s.count("0")]
    else:
        raise ValueError("method should be one of ['strict', 'loose']")
    return lut


def terrain_code_to_geomorphon(terrain_code, method="loose"):
    """Map terrain code array -> geomorphon classes via LUT."""
    if method not in ("strict", "loose"):
        print("method should be one of", ["strict", "loose"])
        return None
    lut = terrain_code_class_table(method)
    return lut[np.asarray(terrain_code)]


def progressive_window(min_value, max_value, percent):
    """Geometric ladder of lookup distances for 'fast' openness
    (neilpy.py:1314-1321)."""
    out = [int(min_value)]
    last = int(min_value)
    while last < max_value:
        last = int(np.ceil(last * (100 + percent) / 100))
        if last <= max_value:
            out.append(last)
    return np.array(out, dtype=np.int32)


def disk(radius, dtype=np.uint8):
    """Disk structuring element: ``x**2 + y**2 <= radius**2``
    (skimage.morphology.disk semantics, used by SMRF at
    neilpy.py:1667-1670 and TPI at neilpy.py:2105)."""
    radius = int(radius)
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x ** 2 + y ** 2 <= radius ** 2).astype(dtype)


def disk_run_halfwidths(radius):
    """Per-row half-widths of the disk footprint: for each dy in
    [-r, r], the horizontal run is [-kx, kx] with
    kx = floor(sqrt(r^2 - dy^2)).  This exact row-run decomposition is
    what the TPU morphology kernels use (ops/morphology.py)."""
    radius = int(radius)
    dys = np.arange(-radius, radius + 1)
    kxs = np.floor(np.sqrt(radius ** 2 - dys.astype(np.float64) ** 2) + 1e-9)
    return dys, kxs.astype(np.int64)


def distance_kernel(radius, cellsize=1, method="binary", idw_power=2):
    """Binary / IDW / distance circular kernels (neilpy.py:2450-2466)."""
    radius_in_pixels = radius / cellsize
    window = int(np.round(2 * radius_in_pixels))
    if window % 2 == 0:
        window += 1
    half = np.floor(window / 2)
    xi, yi = np.meshgrid(np.arange(window) - half, np.arange(window) - half)
    D = np.sqrt(xi ** 2 + yi ** 2)
    if method == "idw":
        with np.errstate(divide="ignore"):
            return 1.0 / D ** idw_power
    if method == "binary":
        return D < radius / cellsize
    return D


def geomorphon_cmap():
    """Standard 10-class geomorphon palette (neilpy.py:1544-1555)."""
    return {1: (220, 220, 220), 2: (56, 0, 0), 3: (200, 0, 0),
            4: (255, 80, 20), 5: (250, 210, 60), 6: (255, 255, 60),
            7: (180, 230, 20), 8: (60, 250, 150), 9: (0, 0, 255),
            10: (0, 0, 56)}


def geomorphon_cmap_old():
    """Flat-list palette variant (neilpy.py:1530-1542)."""
    return [255, 255, 255, 220, 220, 220, 56, 0, 0, 200, 0, 0,
            255, 80, 20, 250, 210, 60, 255, 255, 60, 180, 230, 20,
            60, 250, 150, 0, 0, 255, 0, 0, 56]
