"""Sharded raster pipelines over a 2-D mesh of torch devices.

PyTorch counterpart of ``neilpy_tpu/dist/api.py``: the openness part
and the DEM products (hillshade, Getis-Ord Gi/Gi*, global and local
Moran's I).
The JAX package shards a raster over a ``jax.sharding.Mesh`` and runs
each block under ``shard_map``; one call takes the whole raster and
returns the whole result.  The port keeps that single-controller
contract on a single-process mesh: :class:`Mesh` is an (ny, nx) grid of
``torch.device``, which may name one device several times (four
``cuda:0`` entries on one card, eight ``cpu`` entries on the host), and
the blocks run one after another, each on its device.

Every sharded function pads the raster with NaN to a multiple of the
mesh, cuts it into blocks, pads each with a ``lookup_pixels``-wide halo
of its neighbours' data (``halo_exchange_2d``, mode 'nan'), runs the
block entry of the ladder with the block's global origin and the padded
shape as ``global_shape``, crops the core, and assembles the result on
``mesh.devices[0, 0]``.  The result equals the single-device function:
classes exactly, openness and skyview within their tolerances.

The statistics pad to the mesh twice, as the JAX package does: with NaN
for the global moments, which each block sums locally and ``_psum`` adds
in mesh order on ``mesh.devices[0, 0]`` (where JAX takes ``lax.psum``),
and by edge replication for the footprint sums, which run on blocks
haloed in mode 'edge' so the remainder continues scipy's 'nearest'
boundary.  ``sharded_hillshade`` takes np.gradient's one-sided difference
on the raster's own first and last rows and columns, wherever the mesh
put them, so it equals ``hillshade`` at every pixel also on a raster the
mesh does not divide.
"""

from __future__ import annotations

import numpy as np
import torch

from .halo import (halo_exchange_2d, block_origin, sharded_apply,
                   _assemble, _device_grid, _shard)
from ..core.shift import pad_edge
from ..ops.cuda_scan import openness_counts_block
from ..ops.stats import _lag_footprint, _norm_sf, significance_bins
from ..ops.surface import binary_footprint_sum, hillshade_from_gradients
from ..ops.visibility import (as_raster, classes_from_counts,
                              directional_ratio_extrema,
                              _angles_from_extrema, svf_from_extrema)

__all__ = ["Mesh", "make_mesh", "pad_to_mesh", "sharded_apply",
           "sharded_geomorphons", "sharded_openness", "sharded_skyview",
           "sharded_rastergi", "sharded_morans_i", "sharded_local_morans_i",
           "sharded_hillshade"]


class Mesh:
    """A 2-D grid of torch devices with named axes: ``devices`` is the
    (ny, nx) object array, ``axis_names`` the two names and
    ``shape[name]`` the size along one, as ``jax.sharding.Mesh`` is read
    by the JAX package's ``dist/``."""

    def __init__(self, devices, axis_names=("ty", "tx")):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != 2 or len(self.axis_names) != 2:
            raise ValueError("a Mesh is a 2-D grid of devices with two axis "
                             "names")
        self.shape = dict(zip(self.axis_names, self.devices.shape))


def make_mesh(devices=None, shape=None, axis_names=("ty", "tx")):
    """Build a 2-D mesh, factored as close to square as possible unless
    ``shape`` is given.  ``devices=None`` takes every visible CUDA device
    and raises when there is none; a device may repeat
    (``[torch.device('cpu')] * 8`` is an 8-block mesh of the host)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= "
                "explicitly, e.g. [torch.device('cpu')] * 8")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        ny = int(np.floor(np.sqrt(n)))
        while n % ny:
            ny -= 1
        shape = (ny, n // ny)
    if shape[0] * shape[1] > n:
        raise ValueError(f"mesh shape {tuple(shape)} needs "
                         f"{shape[0] * shape[1]} devices, got {n}")
    grid = np.empty(shape, dtype=object)
    for k, dev in enumerate(devices[:shape[0] * shape[1]]):
        grid[k // shape[1], k % shape[1]] = dev
    return Mesh(grid, axis_names)


def pad_to_mesh(Z, mesh, axis_names=("ty", "tx"), fill=float("nan")):
    """Pad a raster on the bottom/right so both dims divide the mesh.
    Returns (padded, original_shape)."""
    ny = mesh.shape[axis_names[0]]
    nx = mesh.shape[axis_names[1]]
    Z = torch.as_tensor(Z)
    H, W = Z.shape
    Hp = -(-H // ny) * ny
    Wp = -(-W // nx) * nx
    if (Hp, Wp) != (H, W):
        Z = torch.nn.functional.pad(Z, (0, Wp - W, 0, Hp - H), value=fill)
    return Z, (H, W)


def _blocks(Z, mesh, axis_names, radius):
    """The shared scaffold: ``Z`` as float32 (numpy input onto
    ``mesh.devices[0, 0]``), NaN-padded to the mesh, cut into blocks and
    halo-exchanged with NaN beyond the mesh.  Returns (device grid,
    haloed blocks, block shape, padded global shape, original shape)."""
    grid = _device_grid(mesh, axis_names)
    Z = as_raster(Z, None if isinstance(Z, torch.Tensor) else grid[0, 0])
    Zp, orig = pad_to_mesh(Z, mesh, axis_names)
    ny, nx = grid.shape
    bshape = (Zp.shape[0] // ny, Zp.shape[1] // nx)
    padded = halo_exchange_2d(_shard(Zp, grid), radius, mode="nan")
    return grid, padded, bshape, tuple(Zp.shape), orig


def sharded_geomorphons(Z, mesh=None, cellsize=1, lookup_pixels=1,
                        threshold_angle=1, axis_names=("ty", "tx"),
                        engine="auto", fast=False, how_fast=20):
    """Geomorphon classification sharded over a device mesh — the
    multi-device analog of ``geomorphons`` (without ``enhance``), equal
    to the single-device classes.  Each block's counts come from K4
    (``openness_counts_block``) on a CUDA device, its plain version on
    the CPU; ``engine`` is ``'auto'`` / ``'cuda'`` / ``'torch'``."""
    if mesh is None:
        mesh = make_mesh()
    r = int(lookup_pixels)
    grid, padded, bshape, gshape, orig = _blocks(Z, mesh, axis_names, r)
    classes = [[classes_from_counts(*openness_counts_block(
        p, block_origin(bshape, (y, x)), gshape, r, cellsize=float(cellsize),
        threshold_angle=float(threshold_angle), fast=bool(fast),
        how_fast=int(how_fast), engine=engine))
        for x, p in enumerate(row)] for y, row in enumerate(padded)]
    return _assemble(classes, grid)[:orig[0], :orig[1]]


def _sharded_extrema_map(Z, mesh, cellsize, lookup_pixels, axis_names,
                         epilogue):
    """Shared scaffold for mesh-sharded extrema consumers: pad to the
    mesh, halo-exchange each block, run the ratio-extrema scan (K3's
    origin entry on a CUDA device) with the block's global origin, and
    crop ``epilogue(mx, seen) -> (H, W)`` back to the original shape."""
    if mesh is None:
        mesh = make_mesh()
    r = int(lookup_pixels)
    grid, padded, (bh, bw), gshape, orig = _blocks(Z, mesh, axis_names, r)
    out = []
    for y, row in enumerate(padded):
        out.append([])
        for x, p in enumerate(row):
            oy, ox = block_origin((bh, bw), (y, x))
            mx, _, seen = directional_ratio_extrema(
                p, cellsize=cellsize, lookup_pixels=r,
                origin=(oy - r, ox - r), global_shape=gshape)
            out[-1].append(epilogue(mx, seen)[r:r + bh, r:r + bw])
    return _assemble(out, grid)[:orig[0], :orig[1]]


def sharded_openness(Z, mesh=None, cellsize=1, lookup_pixels=1,
                     axis_names=("ty", "tx")):
    """Positive openness (degrees) sharded over a device mesh."""
    return _sharded_extrema_map(
        Z, mesh, cellsize, lookup_pixels, axis_names,
        lambda mx, seen: torch.rad2deg(
            _angles_from_extrema(mx, seen).mean(dim=0)))


def sharded_skyview(Z, mesh=None, cellsize=1, lookup_pixels=1,
                    axis_names=("ty", "tx")):
    """Skyview factor sharded over a device mesh, from the same extrema as
    ``svf_from_extrema``; the clip at 0 absorbs both boundary-zero and
    never-seen contributions, so it equals the single-device result
    within 1e-6."""
    return _sharded_extrema_map(Z, mesh, cellsize, lookup_pixels,
                                axis_names,
                                lambda mx, seen: svf_from_extrema(mx))


# ----------------------------------------------------------------------
# DEM products: hillshade and the footprint statistics
# ----------------------------------------------------------------------
def _footprint_array(footprint, star):
    if np.isscalar(footprint):
        m = int(footprint)
        fp = np.ones((2 * m + 1, 2 * m + 1), dtype=bool)
        if not star:
            fp[m, m] = False
    else:
        fp = np.asarray(footprint) != 0
        star = bool(fp[fp.shape[0] // 2, fp.shape[1] // 2])
    return fp, star


def _psum(parts, device):
    """The sum of per-block partial sums, taken in mesh order on
    ``device`` (``lax.psum`` of the JAX package)."""
    total = None
    for p in parts:
        p = p.to(device)
        total = p if total is None else total + p
    return total


def _stat_blocks(Z, mesh, axis_names, radius):
    """The statistics' scaffold: ``Z`` as float32, NaN-padded to the mesh
    and cut into blocks (for the moments), and edge-padded, cut and
    haloed by ``radius`` in mode 'edge' (for the footprint sums).
    Returns (device grid, flat blocks, flat haloed blocks, block shape,
    original shape), the blocks in mesh order."""
    grid = _device_grid(mesh, axis_names)
    Z = as_raster(Z, None if isinstance(Z, torch.Tensor) else grid[0, 0])
    Zp, orig = pad_to_mesh(Z, mesh, axis_names)
    Ze = pad_edge(Z, ((0, Zp.shape[0] - orig[0]), (0, Zp.shape[1] - orig[1])))
    ny, nx = grid.shape
    bshape = (Zp.shape[0] // ny, Zp.shape[1] // nx)
    blocks = [b for row in _shard(Zp, grid) for b in row]
    haloed = [b for row in halo_exchange_2d(_shard(Ze, grid), radius,
                                            mode="edge") for b in row]
    return grid, blocks, haloed, bshape, orig


def _regrid(flat, grid):
    nx = grid.shape[1]
    return [flat[i:i + nx] for i in range(0, len(flat), nx)]


def _core_sum(padded, fp, r, bshape):
    """The footprint sum of a haloed block, cropped to its core."""
    bh, bw = bshape
    return binary_footprint_sum(padded, fp, mode="nearest")[r:r + bh,
                                                            r:r + bw]


def sharded_rastergi(Z, footprint=1, mesh=None, star=False,
                     apply_correction=False, axis_names=("ty", "tx")):
    """Getis-Ord Gi/Gi* hotspot raster over a 2-D device mesh: the math
    of ``ops.stats.rasterGi`` (mode='nearest') with the global moments
    summed over the blocks (``tot2 / n - mean^2`` for the Gi* variance,
    as the JAX package's sharded form), neighbourhood counts and sums on
    haloed blocks, and the optional ArcGIS correction against the
    summed statistics of the z map.  Returns (Z, P, sig) on
    ``mesh.devices[0, 0]``."""
    if mesh is None:
        mesh = make_mesh()
    fp, star = _footprint_array(footprint, star)
    r = max(fp.shape) // 2
    grid, blocks, haloed, bshape, orig = _stat_blocks(Z, mesh, axis_names,
                                                      r)
    dev = grid[0, 0]
    finite = [torch.isfinite(b) for b in blocks]
    x0 = [torch.where(f, b, 0.0) for f, b in zip(finite, blocks)]
    nf = _psum([f.sum().to(torch.float32) for f in finite], dev)
    tot = _psum([x.sum() for x in x0], dev)
    tot2 = _psum([(x * x).sum() for x in x0], dev)

    zs = []
    for block, fin, padded in zip(blocks, finite, haloed):
        n, t, t2 = (v.to(block.device) for v in (nf, tot, tot2))
        if star:
            gm = t / n
            gv = t2 / n - gm ** 2
        else:
            gm = (t - block) / (n - 1)
            gv = ((t2 - block ** 2) / (n - 1)) - gm ** 2
            gm = torch.where(fin, gm, torch.nan)
            gv = torch.where(fin, gv, torch.nan)
        pfin = torch.isfinite(padded)
        w = torch.round(_core_sum(pfin.to(torch.float32), fp, r, bshape))
        s = _core_sum(torch.where(pfin, padded, 0.0), fp, r, bshape)
        w = torch.where(fin, w, torch.nan)
        a = s - w * gm
        if star:
            b = torch.sqrt((w / (n - 1)) * (n - w) * gv)
        else:
            b = torch.sqrt((w / (n - 2)) * (n - 1 - w) * gv)
        zs.append(torch.where(fin, a / b, torch.nan))

    if apply_correction:
        zf = [torch.isfinite(z) for z in zs]
        z0 = [torch.where(f, z, 0.0) for f, z in zip(zf, zs)]
        zn = _psum([f.sum().to(torch.float32) for f in zf], dev)
        zsum = _psum([z.sum() for z in z0], dev)
        zsum2 = _psum([(z * z).sum() for z in z0], dev)
        zm = zsum / zn
        zstd = torch.sqrt(zsum2 / zn - zm ** 2)
        zs = [(z - zm.to(z.device)) / zstd.to(z.device) for z in zs]

    out = []
    for z, fin in zip(zs, finite):
        P = 2.0 * _norm_sf(torch.abs(z))
        out.append(torch.stack([z, P, significance_bins(z, P, fin)]))
    out = _assemble(_regrid(out, grid), grid)[:, :orig[0], :orig[1]]
    return out[0], out[1], out[2]


def sharded_morans_i(Z, footprint=1, mesh=None, axis_names=("ty", "tx")):
    """Global Moran's I over a 2-D device mesh: every reduction (finite
    count, mean, lag cross-product, weight totals, the Cliff & Ord S2
    term) summed over the blocks, the neighbourhood sums on haloed
    blocks.  Returns the ``(I, E_I, z)`` triple of ``ops.stats.morans_i``
    (mode='nearest') as 0-d tensors on ``mesh.devices[0, 0]``."""
    if mesh is None:
        mesh = make_mesh()
    if np.isscalar(footprint):
        m = int(footprint)
        fp = np.ones((2 * m + 1, 2 * m + 1), dtype=bool)
        fp[m, m] = False
    else:
        fp = np.asarray(footprint) != 0
        fp = fp.copy()
        fp[fp.shape[0] // 2, fp.shape[1] // 2] = False
    r = max(fp.shape) // 2
    grid, blocks, haloed, bshape, orig = _stat_blocks(Z, mesh, axis_names,
                                                      r)
    dev = grid[0, 0]
    finite = [torch.isfinite(b) for b in blocks]
    nf = _psum([f.sum().to(torch.float32) for f in finite], dev)
    xbar = _psum([torch.where(f, b, 0.0).sum()
                  for f, b in zip(finite, blocks)], dev) / nf
    num, den, wsum, s2 = [], [], [], []
    for block, fin, padded in zip(blocks, finite, haloed):
        xb = xbar.to(block.device)
        zdev = torch.where(fin, block - xb, 0.0)
        pfin = torch.isfinite(padded)
        lag = _core_sum(torch.where(pfin, padded - xb, 0.0), fp, r, bshape)
        wmap = torch.round(_core_sum(pfin.to(torch.float32), fp, r, bshape))
        num.append(torch.sum(zdev * lag))
        den.append(torch.sum(zdev ** 2))
        wsum.append(torch.sum(torch.where(fin, wmap, 0.0)))
        s2.append(torch.sum(torch.where(fin, (2.0 * wmap) ** 2, 0.0)))
    num, den, W, S2 = (_psum(v, dev) for v in (num, den, wsum, s2))
    I = (nf / W) * (num / den)
    E_I = -1.0 / (nf - 1.0)
    S0, S1 = W, 2.0 * W
    var_I = ((nf ** 2 * S1 - nf * S2 + 3.0 * S0 ** 2)
             / ((nf ** 2 - 1.0) * S0 ** 2)) - E_I ** 2
    return I, E_I, (I - E_I) / torch.sqrt(var_I)


def sharded_local_morans_i(Z, footprint=1, mesh=None,
                           axis_names=("ty", "tx")):
    """Local Moran's I (Anselin LISA) over a 2-D device mesh: the global
    mean and variance summed over the blocks, lag sums on haloed blocks.
    Matches ``ops.stats.local_morans_i`` (mode='nearest')."""
    if mesh is None:
        mesh = make_mesh()
    fp = _lag_footprint(footprint, drop_centre=False)
    r = max(fp.shape) // 2
    grid, blocks, haloed, bshape, orig = _stat_blocks(Z, mesh, axis_names,
                                                      r)
    dev = grid[0, 0]
    finite = [torch.isfinite(b) for b in blocks]
    nf = _psum([f.sum().to(torch.float32) for f in finite], dev)
    xbar = _psum([torch.where(f, b, 0.0).sum()
                  for f, b in zip(finite, blocks)], dev) / nf
    zdev = [torch.where(f, b - xbar.to(b.device), 0.0)
            for f, b in zip(finite, blocks)]
    s2 = _psum([torch.sum(z ** 2) for z in zdev], dev) / nf
    out = []
    for z, fin, padded in zip(zdev, finite, haloed):
        xb = xbar.to(z.device)
        pdev = torch.where(torch.isfinite(padded), padded - xb, 0.0)
        lag = _core_sum(pdev, fp, r, bshape)
        out.append(torch.where(fin, (z / s2.to(z.device)) * lag, torch.nan))
    return _assemble(_regrid(out, grid), grid)[:orig[0], :orig[1]]


def _block_gradient(p, origin, shape, spacing):
    """``gradient2d`` of the raster of ``shape`` at the core of a block
    haloed by 1 whose core starts at global ``origin``: central
    differences, and np.gradient's one-sided ones on the raster's first
    and last row and column, which may lie inside the core where the mesh
    padded the raster.  Equal to the single-device gradient bit for bit
    at every core pixel on the raster; padding is never read there."""
    bh, bw = p.shape[0] - 2, p.shape[1] - 2
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) / (2.0 * spacing)
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) / (2.0 * spacing)
    (oy, ox), (H, W) = origin, shape
    if oy == 0:
        gy[0] = (p[2, 1:-1] - p[1, 1:-1]) / spacing
    if 0 <= H - 1 - oy < bh:
        k = H - 1 - oy
        gy[k] = (p[k + 1, 1:-1] - p[k, 1:-1]) / spacing
    if ox == 0:
        gx[:, 0] = (p[1:-1, 2] - p[1:-1, 1]) / spacing
    if 0 <= W - 1 - ox < bw:
        k = W - 1 - ox
        gx[:, k] = (p[1:-1, k + 1] - p[1:-1, k]) / spacing
    return gy, gx


def sharded_hillshade(Z, mesh=None, cellsize=1, z_factor=1, zenith=45,
                      azimuth=315, axis_names=("ty", "tx")):
    """Hillshade sharded over a device mesh: a radius-1 halo in mode
    'linear', central differences per block, and np.gradient's one-sided
    differences on the raster's own edges (``_block_gradient``), so the
    result equals ``hillshade`` at every pixel, also where the mesh does
    not divide the raster (the JAX package pads that remainder with
    zeros, which its halo then reads)."""
    if mesh is None:
        mesh = make_mesh()
    grid = _device_grid(mesh, axis_names)
    Z = as_raster(Z, None if isinstance(Z, torch.Tensor) else grid[0, 0])
    H, W = Z.shape
    ny, nx = grid.shape
    bshape = (-(-H // ny), -(-W // nx))
    Zp = pad_edge(Z, ((0, bshape[0] * ny - H), (0, bshape[1] * nx - W)))
    padded = halo_exchange_2d(_shard(Zp, grid), 1, mode="linear")
    out = []
    for y, row in enumerate(padded):
        out.append([])
        for x, p in enumerate(row):
            o = block_origin(bshape, (y, x))
            gy, gx = _block_gradient(p, o, (H, W), cellsize / z_factor)
            gy1, gx1 = _block_gradient(p, o, (H, W), 1.0)
            out[-1].append(hillshade_from_gradients(gy, gx, gy1, gx1,
                                                    zenith, azimuth))
    return _assemble(out, grid)[:H, :W]
