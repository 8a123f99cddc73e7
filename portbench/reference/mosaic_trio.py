"""Plain reference of ``mosaic_trio``: the config-5 trio (geomorphon
classes, SMRF object cells, local Moran's I) over a mosaic, tile by tile
as ``mosaic_terrain_products`` defines it, in plain PyTorch.

Worked out again from the raster alone: the exactness halo (the
program's ``required_overlap``), each tile's window edge-replicated
beyond the raster (``np.pad`` mode ``edge``), the global moments in
float64 over the finite cells (mean and E[x^2] - mean^2), and per tile
window:

- classes: the plain counts ladder and the J&S table (``plain.py``) on
  the window, whose own edge ends the ladder;
- objects: the progressive opening ladder, ``opened_i`` = the disk
  dilation of the disk erosion of ``opened_{i-1}`` (radius w_i, reflect
  boundary, ``opened_0`` the window), a cell an object where some
  ``opened_{i-1} - opened_i > f32(slope * (w_i * cellsize))``;
- Moran: ``(z / s2) * sum of z over the (2g+1)^2 box less its centre``,
  z = x - mean, 0 at non-finite cells, the sum edge-replicated beyond the
  window, NaN at non-finite cells (float64).

Each tile's core (the window less the halo) is its part of the result.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import plain


def overlap(cfg):
    """The exactness halo of the trio: max(lookup, 2 * sum(windows),
    gi_radius + 1)."""
    return max(int(cfg["lookup_pixels"]), int(2 * sum(cfg["windows"])),
               int(cfg["gi_radius"]) + 1)


def tiles(side, ts):
    """(ty, tx, r0, r1, c0, c1) of every tile, row-major."""
    n = -(-side // ts)
    for ty in range(n):
        for tx in range(n):
            yield (ty, tx, ty * ts, min(ty * ts + ts, side), tx * ts,
                   min(tx * ts + ts, side))


def moments(Z, device, rows=4096):
    """(mean, s2) of the finite cells of host raster ``Z``, float64."""
    s = sq = 0.0
    n = 0
    for r0 in range(0, Z.shape[0], rows):
        X = torch.from_numpy(np.array(Z[r0:r0 + rows])).to(device)
        X = X.to(torch.float64)
        m = torch.isfinite(X)
        X = torch.where(m, X, 0.0)
        s += float(X.sum())
        sq += float((X * X).sum())
        n += int(m.sum())
    mean = s / max(n, 1)
    return mean, sq / max(n, 1) - mean * mean


def thresholds(cfg):
    """The opening ladder's float32 thresholds."""
    return [float(np.float32(cfg["slope_threshold"]
                             * (int(w) * float(cfg["cellsize"]))))
            for w in cfg["windows"]]


def window_products(block, cfg, mean, s2, dtype=torch.float32):
    """(classes, objects, moran) of one edge-padded tile window: classes
    and objects in ``dtype``, Moran in float64."""
    X = block.to(dtype)
    classes = plain.classes(*plain.counts(
        X, cfg["cellsize"], cfg["lookup_pixels"], cfg["threshold_angle"]))
    last = X
    objects = torch.zeros(X.shape, dtype=torch.bool, device=X.device)
    for w, thr in zip(cfg["windows"], thresholds(cfg)):
        opened = plain.disk_reduce(plain.disk_reduce(last, w, torch.minimum),
                                   w, torch.maximum)
        objects |= (last - opened) > thr
        last = opened
    X64 = block.to(torch.float64)
    finite = torch.isfinite(X64)
    z = torch.where(finite, X64 - mean, 0.0)
    moran = (z / s2) * plain.box_sum(z, int(cfg["gi_radius"]))
    moran = torch.where(finite, moran, math.nan)
    return classes, objects, moran


def products(Z, cfg, device, dtype=torch.float32):
    """Yield ``((r0, r1, c0, c1), classes, objects, moran)`` per tile of
    host raster ``Z``: each tile's core, on ``device``."""
    side = Z.shape[0]
    ts = int(cfg["tile_size"])
    ov = overlap(cfg)
    mean, s2 = moments(Z, device)
    for _, _, r0, r1, c0, c1 in tiles(side, ts):
        rr0, rr1 = max(r0 - ov, 0), min(r0 + ts + ov, side)
        cc0, cc1 = max(c0 - ov, 0), min(c0 + ts + ov, side)
        win = torch.from_numpy(np.array(Z[rr0:rr1, cc0:cc1]))
        win = win.to(device)
        # edge-replicate to the (ts + 2 ov)^2 window, as np.pad 'edge'
        ri = (torch.arange(r0 - ov, r0 + ts + ov, device=device)
              .clamp(0, side - 1) - rr0)
        ci = (torch.arange(c0 - ov, c0 + ts + ov, device=device)
              .clamp(0, side - 1) - cc0)
        block = win.index_select(0, ri).index_select(1, ci)
        core = np.s_[ov:ov + r1 - r0, ov:ov + c1 - c0]
        yield ((r0, r1, c0, c1),
               *(a[core] for a in window_products(block, cfg, mean, s2,
                                                  dtype)))
