"""Plain reference of ``smrf_isprs``: SMRF, the Simple Morphological
Filter (Pingel, Clarke & McBride 2013, ISPRS J. Photogramm. Remote Sens.
77:21-30), as neilpy/neilpy.py:1659-1808 runs it, written again from
that description in plain PyTorch and NumPy, in float64 on any device:

1. the grid frame and bins on the host in float64: x edges from
   ``floor(min x / cs) cs - cs/2`` to ``ceil(max x / cs) cs + 3 cs/2``, y
   edges descending from ``ceil(max y / cs) cs + cs/2``; a point's column
   ``floor((x - x0) / cs)``, row ``floor((y0 - y) / cs)``; then the
   minimum surface by a scatter-min, NaN where no point fell;
2. the springs fill (D'Errico's inpaint_nans, method 4): every empty
   cell tied by a spring to each of its 4-neighbours on the raster, the
   least-squares rest state, so each filled cell is the mean of its
   neighbours;
3. low outliers: cells where the opening of the negated surface by
   ``disk(1)`` drops by more than ``low_filter_slope * cs``;
4. the opening ladder: for w = 1..windows the surface opened by
   ``disk(w)`` (grey erosion then dilation, reflect boundary), each
   opening applied to the previous one, a cell an object where it drops
   by more than ``slope * w * cs``;
5. the provisional DTM: the minimum surface with the empty, low-outlier
   and object cells filled again by springs;
6. the interpolating bicubic spline (FITPACK's ``RectBivariateSpline``,
   ``kx = ky = 3``, ``s = 0``: not-a-knot ends) of the DTM and of its
   slope ``|np.gradient(DTM, cs)|``, the data at pixel centres, queries
   clamped to the outermost centres;
7. each point an object where ``|DTM(point) - z| > elevation_threshold +
   elevation_scaler * slope(point)``.

Departures from the description, each with its reason:

- the springs' least-squares problem is solved by plain conjugate
  gradients on its normal equations (the spring graph's Laplacian over
  the empty cells, which is what neilpy's ``lsqr`` minimises) to a
  relative residual of 1e-11, in place of a sparse direct solve: one of
  those does not fit a 2003^2 grid on the card;
- each axis's spline system (moments M: ``M[i-1] + 4 M[i] + M[i+1] =
  6 (y[i-1] - 2 y[i] + y[i+1])`` inside, ``M[0] - 2 M[1] + M[2] = 0`` and
  its mirror at the far end: the third derivative continuous at the
  second and penultimate knots) is solved by a dense LU solve, in place of
  FITPACK's B-spline fit; the interpolant is the same;
- the point phase runs in blocks of ``BLOCK`` points, so that it fits;
- neilpy computes (and ignores) a 3 x 3 square for w = 1; ``disk(1)`` is
  what it applies, and what this does;
- ``dtype`` (a control, float64 otherwise): the raster stage's values are
  held in that dtype (the minimum surface, each fill's result, the
  opening ladder computed in it, the DTM); the fills' and the spline's
  solves still run in float64 on those values.

Nothing here imports JAX, the JAX package or the port; ``plain.py``
gives ``disk_reduce`` and ``pad_symmetric``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import plain

BLOCK = 1_000_000     # points per block of the point phase
CG_TOL = 1e-11        # the fills' relative residual
CG_CHECK = 25         # CG iterations between reads of the residual
CG_MAXITER = 100_000


def _exact_matmul():
    """No TF32 anywhere the reference runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def grid_frame(x, y, cs):
    """(ny, nx, x0, y0): the grid's shape and its north-west corner."""
    xedges = np.arange(np.floor(x.min() / cs) * cs - .5 * cs,
                       np.ceil(x.max() / cs) * cs + 1.5 * cs, cs)
    yedges = np.arange(np.ceil(y.max() / cs) * cs + .5 * cs,
                       np.floor(y.min() / cs) * cs - 1.5 * cs, -cs)
    return len(yedges) - 1, len(xedges) - 1, float(xedges[0]), \
        float(yedges[0])


def min_surface(x, y, z, cs, device):
    """(Z, frame): the float64 minimum surface on ``device``, NaN where
    empty, and ``grid_frame``'s tuple."""
    ny, nx, x0, y0 = grid_frame(x, y, cs)
    col = np.floor((x - x0) / cs).astype(np.int64)
    row = np.floor((y0 - y) / cs).astype(np.int64)
    inside = (col >= 0) & (col < nx) & (row >= 0) & (row < ny)
    flat = torch.from_numpy(row[inside] * nx + col[inside]).to(device)
    vals = torch.from_numpy(np.ascontiguousarray(z[inside])).to(device)
    Z = torch.full((ny * nx,), np.inf, dtype=torch.float64, device=device)
    Z.scatter_reduce_(0, flat, vals, "amin", include_self=True)
    Z = torch.where(torch.isinf(Z), np.nan, Z)
    return Z.reshape(ny, nx), (ny, nx, x0, y0)


def _neighbour_sum(X):
    """Sum of each cell's in-raster 4-neighbours."""
    P = torch.nn.functional.pad(X[None, None], (1, 1, 1, 1))[0, 0]
    return P[:-2, 1:-1] + P[2:, 1:-1] + P[1:-1, :-2] + P[1:-1, 2:]


def springs_fill(A):
    """(filled, CG iterations): the NaN cells of ``A`` (float64) at the
    rest state of the 4-neighbour springs, by conjugate gradients on the
    graph Laplacian of the empty cells (SPD where every cluster of empty
    cells touches a known one)."""
    unknown = torch.isnan(A)
    if not bool(unknown.any()):
        return A, 0
    u = unknown.to(A.dtype)
    known = torch.where(unknown, 0.0, A)
    degree = _neighbour_sum(torch.ones_like(A))

    def laplacian(v):
        return (degree * v - _neighbour_sum(v * u)) * u

    b = _neighbour_sum(known) * u
    x = torch.zeros_like(A)
    r = b.clone()
    p = r.clone()
    rr = torch.sum(r * r)
    stop = CG_TOL * CG_TOL * rr
    it = 0
    while it < CG_MAXITER:
        for _ in range(CG_CHECK):
            Ap = laplacian(p)
            pAp = torch.sum(p * Ap)
            alpha = torch.where(pAp > 0, rr / pAp, 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            rr_new = torch.sum(r * r)
            beta = torch.where(rr > 0, rr_new / rr, 0.0)
            p = r + beta * p
            rr = rr_new
        it += CG_CHECK
        if bool(rr <= stop):
            break
    return torch.where(unknown, x, A), it


def _opening(Z, radius):
    return plain.disk_reduce(plain.disk_reduce(Z, radius, torch.minimum),
                             radius, torch.maximum)


def _gradient(Z, cs):
    """(gy, gx): ``np.gradient(Z, cs)``: central differences inside,
    one-sided at the edges."""
    def along(A):
        return torch.cat([A[1:2] - A[:1], (A[2:] - A[:-2]) / 2.0,
                          A[-1:] - A[-2:-1]]) / cs
    return along(Z), along(Z.T).T


def _moments(Y):
    """Not-a-knot moments of the cubic spline through each column of
    ``Y`` (knots 0, 1, ..., n - 1), by a dense solve."""
    n = Y.shape[0]
    if n < 4:
        raise ValueError("a cubic spline needs 4 samples an axis")
    A = torch.zeros((n, n), dtype=Y.dtype, device=Y.device)
    i = torch.arange(1, n - 1, device=Y.device)
    A[i, i - 1] = 1.0
    A[i, i] = 4.0
    A[i, i + 1] = 1.0
    A[0, :3] = torch.tensor([1.0, -2.0, 1.0], dtype=Y.dtype)
    A[n - 1, n - 3:] = torch.tensor([1.0, -2.0, 1.0], dtype=Y.dtype)
    rhs = torch.zeros_like(Y)
    rhs[1:-1] = 6.0 * (Y[:-2] - 2.0 * Y[1:-1] + Y[2:])
    return torch.linalg.solve(A, rhs)


def spline_of(Z):
    """(Z, Mx, My, Mxy): the values and the moments along x (columns),
    along y (rows), and along y of the x moments."""
    Mx = _moments(Z.T).T
    return Z, Mx, _moments(Z), _moments(Mx)


def _cubic(y0, y1, m0, m1, t):
    """The cubic spline between two knots a unit apart at ``t`` in [0, 1],
    from its values and moments."""
    s = 1.0 - t
    return (s * y0 + t * y1 + (s ** 3 - s) * m0 / 6.0
            + (t ** 3 - t) * m1 / 6.0)


def spline_at(spline, r, c):
    """The bicubic spline at grid coordinates (r, c) (the data at pixel
    centres ``i + 0.5``), clamped to the outermost centres."""
    Z, Mx, My, Mxy = spline
    H, W = Z.shape
    u = torch.clamp(r - 0.5, 0.0, H - 1)
    v = torch.clamp(c - 0.5, 0.0, W - 1)
    i = torch.clamp(torch.floor(u).long(), 0, H - 2)
    j = torch.clamp(torch.floor(v).long(), 0, W - 2)
    u = u - i
    v = v - j

    def along_x(A, B, k):
        return _cubic(A[k, j], A[k, j + 1], B[k, j], B[k, j + 1], v)

    return _cubic(along_x(Z, Mx, i), along_x(Z, Mx, i + 1),
                  along_x(My, Mxy, i), along_x(My, Mxy, i + 1), u)


def smrf(x, y, z, cfg, device, dtype=torch.float64):
    """SMRF of one cloud (float64 host arrays) at ``cfg``'s parameters
    (``cellsize``, ``windows``, ``slope_threshold``,
    ``elevation_threshold``, ``elevation_scaler``, ``low_filter_slope``)
    on ``device``: a dict of ``labels`` (bool, one a point, True an
    object), ``dtm`` (float64), ``objects`` (the object cells), ``frame``
    (ny, nx, x0, y0) and ``iterations`` (each fill's CG iterations).
    ``dtype`` holds the raster stage's values in a lower precision (the
    control)."""
    _exact_matmul()
    cs = float(cfg["cellsize"])
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    Zmin, frame = min_surface(x, y, z, cs, device)
    Zmin = Zmin.to(dtype)
    empty = torch.isnan(Zmin)

    def fill(A):
        out, it = springs_fill(A.to(torch.float64))
        iterations.append(it)
        return out.to(dtype)

    iterations = []
    Zmin = fill(Zmin)
    low = (-Zmin - _opening(-Zmin, 1)) > float(cfg["low_filter_slope"]) * cs
    last = Zmin
    objects = empty | low
    for w in range(1, int(cfg["windows"]) + 1):
        opened = _opening(last, w)
        objects |= (last - opened) > float(cfg["slope_threshold"]) * w * cs
        last = opened
    dtm = fill(torch.where(objects, np.nan, Zmin)).to(torch.float64)
    gy, gx = _gradient(dtm, cs)
    surface = spline_of(dtm)
    slope = spline_of(torch.sqrt(gy * gy + gx * gx))

    ny, nx, x0, y0 = frame
    eth = float(cfg["elevation_threshold"])
    esc = float(cfg["elevation_scaler"])
    rows, cols = (y0 - y) / cs, (x - x0) / cs
    labels = []
    for a in range(0, x.size, BLOCK):
        r, c, zz = (torch.from_numpy(v[a:a + BLOCK]).to(device)
                    for v in (rows, cols, z))
        labels.append(torch.abs(spline_at(surface, r, c) - zz)
                      > eth + esc * spline_at(slope, r, c))
    return {"labels": torch.cat(labels), "dtm": dtm, "objects": objects,
            "frame": frame, "iterations": iterations}
