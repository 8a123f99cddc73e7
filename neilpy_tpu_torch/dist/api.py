"""Sharded raster pipelines over a 2-D mesh of torch devices.

PyTorch counterpart of ``neilpy_tpu/dist/api.py`` (its openness part).
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
"""

from __future__ import annotations

import numpy as np
import torch

from .halo import (halo_exchange_2d, block_origin, sharded_apply,
                   _assemble, _device_grid, _shard)
from ..ops.cuda_scan import openness_counts_block
from ..ops.visibility import (as_raster, classes_from_counts,
                              directional_ratio_extrema,
                              _angles_from_extrema, svf_from_extrema)

__all__ = ["Mesh", "make_mesh", "pad_to_mesh", "sharded_apply",
           "sharded_geomorphons", "sharded_openness", "sharded_skyview"]


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
