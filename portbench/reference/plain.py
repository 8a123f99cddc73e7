"""Frozen plain copies of what the references need, in plain PyTorch.

Copied, not imported, so that the yardstick cannot move with the
program, and written for any dtype so that the control can run them in
bfloat16:

- ``OFFSETS``, ``STEP_LENGTH``: ``neilpy_tpu_torch/core/shift.py``;
- ``progressive_window``, ``js_table``: ``neilpy_tpu_torch/core/codes.py``
  (``progressive_window``, ``jasiewicz_stepinski_table``; the reference's
  neilpy.py:1314-1321 and 1623-1635);
- ``scan_ladder``, ``ladder_scales``, ``threshold_tangent``, ``extrema``,
  ``classify``, ``counts``: ``neilpy_tpu_torch/ops/cuda_scan.py``
  (``_ladder``, ``_ladder_scales``, ``_threshold_tangent``,
  ``_ladder_extrema`` without its routing, ``_classify``, ``_votes``), the
  plain counts ladder the kernels are held to;
- ``pad_edge``, ``pad_symmetric``: ``np.pad`` modes ``edge`` and
  ``symmetric`` (scipy's ``nearest`` and ``reflect``);
- ``disk_reduce``: a grey erosion or dilation by ``disk(r)``
  (``x**2 + y**2 <= r**2``, skimage's ``disk``) as a plain reduction over
  the footprint's offsets, reflect boundary;
- ``box_sum``: the sum over the (2m+1)^2 box without its centre (local
  Moran's binary weights), edge-replicated boundary.
"""

from __future__ import annotations

import math

import numpy as np
import torch

OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, 1),
           (1, 1), (1, 0), (1, -1), (0, -1))
STEP_LENGTH = tuple(2.0 ** 0.5 if d % 2 == 0 else 1.0 for d in range(8))


def progressive_window(min_value, max_value, percent):
    """Geometric ladder of lookup distances (neilpy.py:1314-1321)."""
    out = [int(min_value)]
    last = int(min_value)
    while last < max_value:
        last = int(np.ceil(last * (100 + percent) / 100))
        if last <= max_value:
            out.append(last)
    return out


def scan_ladder(R, fast=False, how_fast=20):
    """The scan distances: dense 1..R, or the progressive window."""
    R = int(R)
    if fast:
        return tuple(progressive_window(1, R, int(how_fast)))
    return tuple(range(1, R + 1))


def js_table():
    """Jasiewicz & Stepinski's 9x9 table: rows the directions higher,
    columns the directions lower -> geomorphon class 1-10."""
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


def ladder_scales(cellsize, ladder):
    """(8, K) float32 ``f32(1/(cellsize*w_d)) / f32(L_k)``."""
    inv_w = np.array([1.0 / (float(cellsize) * STEP_LENGTH[d])
                      for d in range(8)], dtype=np.float32)
    return inv_w[:, None] / np.asarray(ladder, dtype=np.float32)[None, :]


def threshold_tangent(threshold_angle):
    return float(np.float32(math.tan(math.radians(float(threshold_angle)))))


def extrema(Z, cellsize, ladder):
    """Yield ``(mx, mn)`` per direction d = 0..7: the running max and min
    of ``(Z[p + d*L] - Z[p]) * scale[d, L]`` over the ladder, NaN and
    off-raster reads skipped (compare-select), and at an off-raster last
    step ``mx >= 0``, ``mn <= 0``.  In ``Z``'s dtype."""
    H, W = Z.shape
    R = max(ladder)
    Rmax = ladder[-1]
    # python floats holding values of Z's dtype: a tensor-scalar op
    # computes in that dtype
    scales = torch.from_numpy(ladder_scales(cellsize, ladder)).to(
        Z.dtype).double().tolist()
    Zp = torch.nn.functional.pad(Z, (R, R, R, R), value=float("nan"))
    rows = torch.arange(H, device=Z.device)[:, None]
    cols = torch.arange(W, device=Z.device)[None, :]
    zero = torch.zeros((), dtype=Z.dtype, device=Z.device)
    for d, (dr, dc) in enumerate(OFFSETS):
        mx = torch.full((H, W), -math.inf, dtype=Z.dtype, device=Z.device)
        mn = torch.full((H, W), math.inf, dtype=Z.dtype, device=Z.device)
        for k, L in enumerate(ladder):
            src = Zp[R + dr * L:R + dr * L + H, R + dc * L:R + dc * L + W]
            ratio = (src - Z) * scales[d][k]
            mx = torch.where(ratio > mx, ratio, mx)
            mn = torch.where(ratio < mn, ratio, mn)
        sr = rows + dr * Rmax
        sc = cols + dc * Rmax
        oob = (sr < 0) | (sr >= H) | (sc < 0) | (sc >= W)
        mx = torch.where(oob, torch.maximum(mx, zero), mx)
        mn = torch.where(oob, torch.minimum(mn, zero), mn)
        yield mx, mn


def classify(mx, mn, T):
    """(gt, lt): the openness difference ``atan(-mn) - atan(mx)`` above
    +t / below -t, compared in tangent space (``T = tan t``); an unseen
    direction votes neither way."""
    a = -mn
    b = mx
    denom = 1.0 + a * b
    s = a - b
    td = T * denom
    wide = denom <= 0.0
    narrow = denom > 0.0
    seen = mx > -math.inf
    gt = ((wide & (a > b)) | (narrow & (s > td))) & seen
    lt = ((wide & (a < b)) | (narrow & (s < -td))) & seen
    return gt, lt


def counts(Z, cellsize, lookup_pixels, threshold_angle, fast=False,
           how_fast=20):
    """(num_pos, num_neg) uint8: the directions voting higher / lower."""
    T = threshold_tangent(threshold_angle)
    num_pos = torch.zeros(Z.shape, dtype=torch.uint8, device=Z.device)
    num_neg = torch.zeros(Z.shape, dtype=torch.uint8, device=Z.device)
    for mx, mn in extrema(Z, cellsize,
                          scan_ladder(lookup_pixels, fast, how_fast)):
        gt, lt = classify(mx, mn, T)
        num_pos += gt
        num_neg += lt
    return num_pos, num_neg


def classes(num_pos, num_neg):
    """Geomorphon classes: the J&S table at (num_pos, num_neg)."""
    tbl = torch.from_numpy(js_table().ravel()).to(num_pos.device)
    return tbl[num_pos.long() * 9 + num_neg.long()]


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    k = i.remainder(2 * n)                    # symmetric: period 2n
    return torch.where(k < n, k, 2 * n - 1 - k)


def _pad(Z, width, mode):
    for axis in (0, 1):
        Z = Z.index_select(axis, _pad_index(Z.shape[axis], width, width,
                                            mode, Z.device))
    return Z


def pad_edge(Z, width):
    """``np.pad(Z, width, mode='edge')``."""
    return _pad(Z, int(width), "edge")


def pad_symmetric(Z, width):
    """``np.pad(Z, width, mode='symmetric')`` (edge-inclusive reflect)."""
    return _pad(Z, int(width), "symmetric")


def disk_reduce(Z, radius, reduce_fn):
    """``reduce_fn`` (``torch.minimum`` / ``torch.maximum``) over
    ``disk(radius)`` with a reflect boundary: grey erosion / dilation."""
    r = int(radius)
    H, W = Z.shape
    P = pad_symmetric(Z, r)
    out = None
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx * dx + dy * dy <= r * r:
                band = P[r + dy:r + dy + H, r + dx:r + dx + W]
                out = band if out is None else reduce_fn(out, band)
    return out


def box_sum(X, m):
    """Sum of ``X`` over the (2m+1)^2 box less its centre, edge-replicated
    beyond the raster."""
    H, W = X.shape
    P = pad_edge(X, m)
    out = torch.zeros_like(X)
    for dy in range(-m, m + 1):
        for dx in range(-m, m + 1):
            if dy or dx:
                out = out + P[m + dy:m + dy + H, m + dx:m + dx + W]
    return out
