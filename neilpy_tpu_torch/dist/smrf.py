"""Multi-device SMRF: the whole ground-filter raster phase sharded over a
2-D mesh of torch devices, plus a data-parallel point phase.

PyTorch counterpart of ``neilpy_tpu/dist/smrf.py``, with the same names
and arguments plus ``device=``.  There every stage runs per block under
one ``shard_map`` program; here one process holds the whole mesh
(``dist/api.py``: a grid of ``torch.device`` that may name one device
several times) and runs each operation once per block, in mesh order,
each block on its device.  The stages and their halos are the JAX
package's:

* morphology: reflect boundaries equal truncated footprints for min/max
  (every mirrored position repeats a value already inside the disk), so
  cells outside the raster go to the reduction's identity (+/-inf) and
  each erosion and dilation exchanges a radius-w halo; the ladder is bit
  for bit the single-device ``progressive_filter``;
* spring inpaint: flexible CG whose operator exchanges a 1-px halo per
  apply, whose inner products are block partial sums added in mesh order
  on ``mesh.devices[0, 0]`` (``dist/api._psum``, JAX's ``lax.psum``), and
  whose preconditioner is the Galerkin K-cycle with sharded fine levels
  (halo-exchanged smoothing, block-local 2x2 aggregation) handed to one
  coarse hierarchy on ``mesh.devices[0, 0]`` once a block reaches
  ``mg_min_block`` (JAX replicates it on every device; one copy computes
  the same numbers).  Node degrees come from global coordinates, so mesh
  seams and the raster's own edge are exact;
* the padding that makes the raster divide the mesh is masked out of the
  domain by global coordinates, never reflected or inpainted, so the
  sharded fill equals the single-device one up to CG convergence (the
  block sums round the inner products differently).

The CG loop is the single-device solve's ``ops.inpaint._cg`` on lists of
blocks (``_Layout`` gives its vector operations), so it reads its device
stop flag every ``ops.inpaint.CHECK_EVERY_MULTIGRID`` iterations and
freezes the iterate once the flag holds.

The point phase lifts the gathered provisional DTM with the single-device
spline stage, the points split into one contiguous chunk per mesh device:
only the order of the work differs from ``pipelines/smrf.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .api import _psum, make_mesh, pad_to_mesh
from .halo import (_assemble, _device_grid, _shard, block_origin,
                   halo_exchange_2d)
from ..core.device import resolve_device, to_device
from ..core.shift import gradient2d
from ..ops.inpaint import (CHECK_EVERY_MULTIGRID, _blocksum2, _cg,
                           _coarsen_level, _kcycle, _prolong2, _safe_div,
                           _warn_exhausted)
from ..ops.morphology import _disk_morph_padded
from ..ops.pointgrid import create_dem
from ..ops.spline import spline_coefficients_2d
from ..pipelines.smrf import _no_mark, _smrf_points, _thresholds, _windows

__all__ = ["sharded_smrf", "sharded_springs_fill",
           "sharded_progressive_filter"]

_INF = float("inf")


class _Layout:
    """A raster cut over a mesh: the blocks in mesh order (flat lists,
    row-major), their devices and global origins, the raster's own
    (unpadded) shape ``gshape``, which decides the domain, and the
    collectives the JAX package gets from ``shard_map``."""

    def __init__(self, mesh, axis_names, bshape, gshape):
        self.grid = _device_grid(mesh, axis_names)
        self.ny, self.nx = self.grid.shape
        self.devices = [self.grid[y, x] for y in range(self.ny)
                        for x in range(self.nx)]
        self.origins = [block_origin(bshape, (y, x)) for y in range(self.ny)
                        for x in range(self.nx)]
        self.dev0 = self.grid[0, 0]
        self.bshape = tuple(bshape)
        self.gshape = tuple(gshape)

    def nested(self, flat):
        return [flat[i:i + self.nx] for i in range(0, len(flat), self.nx)]

    def halo(self, blocks, radius):
        """Every block padded by ``radius`` of its neighbours' data, zeros
        beyond the mesh (the JAX package's mode='zero')."""
        return [p for row in halo_exchange_2d(self.nested(blocks), radius,
                                              mode="zero") for p in row]

    def gather(self, blocks):
        """The global array on ``dev0`` (``lax.all_gather``)."""
        return _assemble(self.nested(blocks), self.grid)

    def scatter(self, g):
        """Each device's block of a global array (``dynamic_slice`` by
        ``axis_index``)."""
        return [b for row in _shard(g, self.grid) for b in row]

    def psum(self, parts):
        return _psum(parts, self.dev0)

    # ops.inpaint._cg's vector operations (``_Tensor``) on lists of blocks

    def dot(self, a, b):
        return self.psum([torch.sum(x * y) for x, y in zip(a, b)])

    def scalar(self, s):
        """A scalar on ``dev0`` as one copy per block's device."""
        return [s.to(d, non_blocking=True) for d in self.devices]

    @staticmethod
    def sub(a, b):
        return [x - y for x, y in zip(a, b)]

    @staticmethod
    def axpy(a, s, b, sign=1):
        """a + s b (a - s b for ``sign`` < 0), ``s`` from ``scalar``."""
        if sign > 0:
            return [x + si * y for x, si, y in zip(a, s, b)]
        return [x - si * y for x, si, y in zip(a, s, b)]

    @staticmethod
    def where(c, a, b):
        return [torch.where(ci, x, y) for ci, x, y in zip(c, a, b)]

    def domain(self, shape, origin, device):
        """True for the cells of a (possibly haloed) block whose global
        position lies inside the raster: mesh padding and halo beyond the
        raster edge are False (``_domain_mask``)."""
        gy = torch.arange(shape[0], device=device)[:, None] + origin[0]
        gx = torch.arange(shape[1], device=device)[None, :] + origin[1]
        H, W = self.gshape
        return (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)

    def degree(self, shape, origin, device):
        """In-raster 4-neighbours per cell, from global coordinates."""
        gy = torch.arange(shape[0], device=device)[:, None] + origin[0]
        gx = torch.arange(shape[1], device=device)[None, :] + origin[1]
        H, W = self.gshape
        f = torch.float32
        return (((gy > 0).to(f) + (gy < H - 1).to(f))
                + (gx > 0).to(f) + (gx < W - 1).to(f))


def _layout(Z, mesh, axis_names):
    """``Z`` as float32 on ``mesh.devices[0, 0]`` (numpy input goes
    there), NaN-padded to the mesh and cut into blocks.  Returns (layout,
    flat blocks, original shape)."""
    grid = _device_grid(mesh, axis_names)
    Z = to_device(Z, None if isinstance(Z, torch.Tensor) else grid[0, 0],
                  torch.float32)
    Zp, orig = pad_to_mesh(Z, mesh, axis_names)
    ny, nx = grid.shape
    L = _Layout(mesh, axis_names, (Zp.shape[0] // ny, Zp.shape[1] // nx),
                orig)
    return L, L.scatter(Zp), orig


def _mesh_for(mesh, device):
    """The mesh to run on: ``mesh``, or without one a 1 x 1 mesh of
    ``device``, or every visible CUDA device (``make_mesh()``)."""
    if mesh is not None:
        return mesh
    if device is not None:
        return make_mesh([resolve_device(device)])
    return make_mesh()


# ----------------------------------------------------------------------
# morphology
# ----------------------------------------------------------------------
def _halo_opening(L, blocks, radius):
    """One grey opening (erosion then dilation) with a radius-w halo per
    stage; cells outside the raster take the reduction's identity."""
    r = int(radius)

    def stage(blocks, reduce_fn, ident):
        out = []
        for p, (oy, ox) in zip(L.halo(blocks, r), L.origins):
            dom = L.domain(p.shape, (oy - r, ox - r), p.device)
            out.append(_disk_morph_padded(torch.where(dom, p, ident), r,
                                          reduce_fn))
        return out

    return stage(stage(blocks, torch.minimum, _INF), torch.maximum, -_INF)


def _ladder(L, blocks, windows, thresholds):
    """The progressive opening ladder over the blocks: each radius opens
    the previous radius's surface and flags cells dropping by more than
    its threshold (``thresholds``: one float32 tensor per block)."""
    last = blocks
    objects = [torch.zeros(b.shape, dtype=torch.bool, device=b.device)
               for b in blocks]
    for i, w in enumerate(windows):
        opened = _halo_opening(L, last, w)
        objects = [o | ((a - op) > t[i])
                   for o, a, op, t in zip(objects, last, opened, thresholds)]
        last = opened
    return objects


# ----------------------------------------------------------------------
# the springs fill
# ----------------------------------------------------------------------
def _apply_sh(L, x, diag, Ep, Sp):
    """The 5-point coefficient-array operator of one sharded level
    (``ops.inpaint._apply_level``): one 1-px halo of ``x``; the coupling
    arrays come haloed already."""
    out = []
    for xi, xp, d, E, S in zip(x, L.halo(x, 1), diag, Ep, Sp):
        out.append(d * xi
                   - E[1:-1, 1:-1] * xp[1:-1, 2:]
                   - E[1:-1, :-2] * xp[1:-1, :-2]
                   - S[1:-1, 1:-1] * xp[2:, 1:-1]
                   - S[:-2, 1:-1] * xp[:-2, 1:-1])
    return out


def _sharded_mg_levels(L, unknown, deg, min_block=256):
    """Galerkin hierarchy of the sharded spring solve.

    The finest levels stay sharded: each block coarsens itself (exact,
    since its extents are kept even, so no 2x2 aggregate straddles two
    blocks) and carries its coupling arrays haloed by 1 for ``_apply_sh``.
    Once a block reaches ``min_block`` (or an odd extent) that level is
    gathered onto ``dev0`` and the hierarchy continues there.  Returns
    ``(sharded_levels, coarse_levels)``; ``sharded_levels[-1]`` is the
    hand-off level, whose gathered form is ``coarse_levels[0]``.  Each
    sharded level is ``(diag, E, S, u, E haloed, S haloed)``, each a list
    of blocks."""
    up = L.halo(unknown, 1)
    u = unknown
    diag = [d * ui for d, ui in zip(deg, u)]
    E = [p[1:-1, 1:-1] * p[1:-1, 2:] for p in up]
    S = [p[1:-1, 1:-1] * p[2:, 1:-1] for p in up]

    slevels = [(diag, E, S, u, L.halo(E, 1), L.halo(S, 1))]
    shape = L.bshape
    while (max(L.ny, L.nx) > 1 and min(shape) > min_block
           and shape[0] % 2 == 0 and shape[1] % 2 == 0):
        diag, E, S, u = map(list, zip(*(_coarsen_level(*lv) for lv in
                                        zip(diag, E, S, u))))
        shape = tuple(u[0].shape)
        slevels.append((diag, E, S, u, L.halo(E, 1), L.halo(S, 1)))

    clevels = [tuple(L.gather(a) for a in slevels[-1][:4])]
    while min(clevels[-1][3].shape) > 4:
        clevels.append(_coarsen_level(*clevels[-1]))
    return slevels, clevels


def _kcycle_sh(L, r, slevels, clevels, l, omega=0.9, nsmooth=2, kdepth=2):
    """Sharded multigrid K-cycle, the counterpart of
    ``ops.inpaint._kcycle``: sharded levels smooth with halo-exchanged
    applies and block-summed inner products; at the hand-off level the
    residual is gathered and the single-device cycle finishes on
    ``dev0``, its result cut back into blocks."""
    m = len(slevels) - 1
    if l == m:
        xg = _kcycle(L.gather(r), clevels, 0, omega, nsmooth, kdepth)
        return L.scatter(xg)

    diag, E, S, u, Ep, Sp = slevels[l]
    bh, bw = u[0].shape
    invD = [torch.where(d > 0, omega / d, 0.0) * ui for d, ui in zip(diag, u)]

    def A(x):
        y = _apply_sh(L, [xi * ui for xi, ui in zip(x, u)], diag, Ep, Sp)
        return [yi * ui for yi, ui in zip(y, u)]

    def smooth(x):
        for _ in range(nsmooth):
            x = [xi + w * (ri - ai)
                 for xi, w, ri, ai in zip(x, invD, r, A(x))]
        return x

    x = smooth([torch.zeros_like(ri) for ri in r])
    uc = slevels[l + 1][3]
    rc = [_blocksum2(ri - ai) * c for ri, ai, c in zip(r, A(x), uc)]

    if kdepth > 0 and l + 1 < m:
        dc, _, _, uc, Epc, Spc = slevels[l + 1]

        def Ac(xx):
            y = _apply_sh(L, [a * c for a, c in zip(xx, uc)], dc, Epc, Spc)
            return [yi * c for yi, c in zip(y, uc)]

        xc = [torch.zeros_like(a) for a in rc]
        rr = rc
        z = _kcycle_sh(L, rr, slevels, clevels, l + 1, omega, nsmooth,
                       kdepth - 1)
        p = z
        rz = L.dot(rr, z)
        for _ in range(2):
            Ap = Ac(p)
            alpha = L.scalar(_safe_div(rz, L.dot(p, Ap)))
            xc = L.axpy(xc, alpha, p)
            r_new = L.axpy(rr, alpha, Ap, -1)
            z_new = _kcycle_sh(L, r_new, slevels, clevels, l + 1, omega,
                               nsmooth, kdepth - 1)
            rz_new = L.dot(r_new, z_new)
            beta = L.scalar(_safe_div(rz_new - L.dot(rr, z_new), rz))
            p = L.axpy(z_new, beta, p)
            rr, z, rz = r_new, z_new, rz_new
    else:
        xc = _kcycle_sh(L, rc, slevels, clevels, l + 1, omega, nsmooth,
                        kdepth if l + 1 == m else 0)
    x = [xi + _prolong2(c, bh, bw) * ui for xi, c, ui in zip(x, xc, u)]
    return smooth(x)


def _springs_fill_blocks(L, blocks, tol, maxiter, mg_min_block=256):
    """Spring-graph inpaint of the blocks: flexible CG on the masked graph
    Laplacian with a 1-px halo inside the operator, block-summed inner
    products and the sharded K-cycle as preconditioner.  Returns (filled
    blocks, {"iterations", "host_syncs"})."""
    dom = [L.domain(b.shape, o, b.device) for b, o in zip(blocks, L.origins)]
    nanmask = [torch.isnan(b) & d for b, d in zip(blocks, dom)]
    unknown = [m.to(torch.float32) for m in nanmask]
    known_mask = [(torch.isfinite(b) & d).to(torch.float32)
                  for b, d in zip(blocks, dom)]
    known_vals = [torch.where(k > 0, torch.nan_to_num(b), 0.0)
                  for k, b in zip(known_mask, blocks)]
    deg = [L.degree(b.shape, o, b.device) * d
           for b, o, d in zip(blocks, L.origins, dom)]

    def nbr_sum(X, mask):
        P = L.halo([a * m for a, m in zip(X, mask)], 1)
        return [p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
                for p in P]

    def apply_fn(x):
        x = [a * u for a, u in zip(x, unknown)]
        return [(d * a - s) * u
                for d, a, s, u in zip(deg, x, nbr_sum(x, unknown), unknown)]

    b = [s * u for s, u in zip(nbr_sum(known_vals, known_mask), unknown)]
    slevels, clevels = _sharded_mg_levels(L, unknown, deg, mg_min_block)

    def precond(r):
        return _kcycle_sh(L, r, slevels, clevels, 0)

    total_known = L.psum([torch.sum(k) for k in known_mask])
    mean = L.psum([torch.sum(v) for v in known_vals]) / torch.clamp_min(
        total_known, 1.0)
    x = [u * m for u, m in zip(unknown, L.scalar(mean))]

    x, iterations, syncs = _cg(apply_fn, b, x, precond, tol, maxiter, True,
                               CHECK_EVERY_MULTIGRID, space=L)
    out = [torch.where(m, a, blk) for m, a, blk in zip(nanmask, x, blocks)]
    return out, {"iterations": iterations, "host_syncs": syncs}


# ----------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------
def sharded_springs_fill(A, mesh=None, axis_names=("ty", "tx"), tol=1e-7,
                         maxiter=4000, mg_min_block=256, device=None):
    """Spring inpaint over a device mesh (the multi-device
    ``inpaint_nans_by_springs``): halo-exchanged flexible CG with the
    sharded Galerkin K-cycle preconditioner, exact global boundary
    handling.  ``mg_min_block`` sets the block size below which the
    multigrid hierarchy leaves the sharded levels for one coarse
    hierarchy.  ``mesh=None`` takes a 1 x 1 mesh of ``device`` or, with
    no ``device``, every visible CUDA device.  Returns the filled float32
    raster on ``mesh.devices[0, 0]``."""
    out, _ = _sharded_fill(A, _mesh_for(mesh, device), axis_names, tol,
                           maxiter, mg_min_block)
    return out


def _sharded_fill(A, mesh, axis_names, tol, maxiter, mg_min_block):
    """``sharded_springs_fill`` with the solve's CG counts."""
    L, blocks, orig = _layout(A, mesh, axis_names)
    filled, info = _springs_fill_blocks(L, blocks, tol, maxiter,
                                        mg_min_block)
    _warn_exhausted(info["iterations"], maxiter, tol)
    return L.gather(filled)[:orig[0], :orig[1]], info


def sharded_progressive_filter(Z, windows, mesh=None, cellsize=1,
                               slope_threshold=.15,
                               axis_names=("ty", "tx"), device=None):
    """Progressive morphological opening ladder over a device mesh (the
    multi-device ``progressive_filter``); bit for bit the single-device
    ladder.  Returns the boolean object raster on
    ``mesh.devices[0, 0]``."""
    windows = np.atleast_1d(np.asarray(windows))
    L, blocks, orig = _layout(Z, _mesh_for(mesh, device), axis_names)
    thr = [_thresholds(windows, slope_threshold, cellsize, torch.float32, d)
           for d in L.devices]
    objects = _ladder(L, blocks, tuple(int(w) for w in windows), thr)
    return L.gather(objects)[:orig[0], :orig[1]]


def _sharded_raster(L, blocks, windows, thresholds, low_threshold,
                    low_outlier_fill, tol, maxiter, mg_min_block, mark):
    """Every grid-shaped SMRF stage over the blocks (the JAX package's
    ``_sharded_raster``); ``mark(stage, **info)`` after each stage."""
    dom = [L.domain(b.shape, o, b.device) for b, o in zip(blocks, L.origins)]
    is_empty = [torch.isnan(b) & d for b, d in zip(blocks, dom)]

    def fill(bs, stage):
        out, info = _springs_fill_blocks(L, bs, tol, maxiter, mg_min_block)
        _warn_exhausted(info["iterations"], maxiter, tol)
        mark(stage, **info)
        return out

    Zmin = fill(blocks, "springs_fill")
    neg = [-a for a in Zmin]
    opened = _halo_opening(L, neg, 1)
    low = [((a - o) > t) & d
           for a, o, t, d in zip(neg, opened, low_threshold, dom)]
    mark("low_outlier_opening")
    if low_outlier_fill:
        Zmin = fill([torch.where(lo, torch.nan, a)
                     for lo, a in zip(low, Zmin)], "springs_refill")

    objects = _ladder(L, Zmin, windows, thresholds)
    mark("ladder")
    objects = [(o | e | lo) & d
               for o, e, lo, d in zip(objects, is_empty, low, dom)]
    Zpro = fill([torch.where(o, torch.nan, a)
                 for o, a in zip(objects, Zmin)], "springs_fill_dtm")
    return Zpro, objects


def sharded_smrf(x, y, z, cellsize=1, windows=5, slope_threshold=.15,
                 elevation_threshold=.5, elevation_scaler=1.25,
                 low_filter_slope=5, low_outlier_fill=False, mesh=None,
                 axis_names=("ty", "tx"), tol=1e-7, maxiter=4000,
                 mg_min_block=256, device=None):
    """Multi-device SMRF (``pipelines.smrf.smrf``'s arguments and
    results): the raster phase sharded over the mesh, the point phase
    split over its devices.  Returns (Zpro, t, object_cells,
    is_object_point), the tensors on ``mesh.devices[0, 0]``; ``mesh=None``
    as :func:`sharded_springs_fill`."""
    return _sharded_smrf_run(
        x, y, z, cellsize, windows, slope_threshold, elevation_threshold,
        elevation_scaler, low_filter_slope, low_outlier_fill,
        _mesh_for(mesh, device), axis_names, tol, maxiter, mg_min_block)


def _sharded_smrf_run(x, y, z, cellsize, windows, slope_threshold,
                      elevation_threshold, elevation_scaler,
                      low_filter_slope, low_outlier_fill, mesh, axis_names,
                      tol, maxiter, mg_min_block, mark=_no_mark):
    """``sharded_smrf``'s body, with ``mark(stage, **info)`` called after
    each stage (``chip_smoke.py`` reads the CG counts of each fill)."""
    windows = _windows(windows)
    dev0 = _device_grid(mesh, axis_names)[0, 0]
    x64 = np.asarray(x, dtype=np.float64)
    y64 = np.asarray(y, dtype=np.float64)
    z64 = np.asarray(z, dtype=np.float64)

    # gridding: the single-device path (exact host f64 binning, device
    # scatter-min) onto the mesh's first device
    Zmin_raw, t = create_dem(x64, y64, z64, cellsize=cellsize,
                             bin_type="min", device=dev0)
    mark("gridding")
    L, blocks, orig = _layout(Zmin_raw, mesh, axis_names)
    thr = [_thresholds(windows, slope_threshold, cellsize, torch.float32, d)
           for d in L.devices]
    low = [torch.tensor(low_filter_slope * cellsize, dtype=torch.float32,
                        device=d) for d in L.devices]
    Zpro_b, objects_b = _sharded_raster(
        L, blocks, tuple(int(w) for w in windows), thr, low,
        bool(low_outlier_fill), tol, maxiter, mg_min_block, mark)
    Zpro = L.gather(Zpro_b)[:orig[0], :orig[1]]
    object_cells = L.gather(objects_b)[:orig[0], :orig[1]]

    # point phase: the coefficients once on dev0, the points in one
    # contiguous chunk per mesh device
    coeffs_Z = spline_coefficients_2d(Zpro)
    gy, gx = gradient2d(Zpro, cellsize)
    coeffs_S = spline_coefficients_2d(torch.sqrt(gy ** 2 + gx ** 2))
    mark("spline_coefficients")
    c, r = (~t) * (x64, y64)
    n = c.size
    step = -(-n // len(L.devices)) if n else 1
    labels = []
    for i, d in enumerate(L.devices):
        if i and i * step >= n:
            break
        sl = slice(i * step, (i + 1) * step)
        cz = tuple(a.to(d) for a in coeffs_Z)
        cs = tuple(a.to(d) for a in coeffs_S)
        obj, _ = _smrf_points(
            cz, cs, to_device(r[sl], d, torch.float32),
            to_device(c[sl], d, torch.float32),
            to_device(z64[sl], d, torch.float32),
            torch.tensor(elevation_threshold, dtype=torch.float32, device=d),
            torch.tensor(elevation_scaler, dtype=torch.float32, device=d))
        labels.append(obj.to(dev0))
    is_object_point = torch.cat(labels)
    mark("points")
    return Zpro, t, object_cells, is_object_point
