"""Halo exchange over a 2-D mesh of torch devices.

PyTorch counterpart of ``neilpy_tpu/dist/halo.py``.  There a block runs
under ``shard_map`` and trades strips with its mesh neighbours by
``lax.ppermute``; here one process holds the whole mesh (``dist/api.py``:
a grid of ``torch.device`` that may name one device several times), so
the exchange takes the grid of blocks at once.  A neighbour's strip is a
slice copied onto the receiving block's device (``copy_`` with
``non_blocking=True``): a device-local copy when both blocks sit on one
card, a peer copy between two cards, and nothing goes through the host.

Each block is padded by ``radius`` on every side, columns first, then
rows of the column-padded blocks, so the corners hold the diagonal
neighbour's data.  Halos beyond the mesh take the global boundary
semantics of ``mode``:

* ``'symmetric'`` — scipy reflect padding, ``(b a | a b ...)``;
* ``'edge'``      — scipy nearest padding;
* ``'linear'``    — linear extrapolation ``z[e] + d (z[e] - z[e-1])`` at
  distance d, which makes central differences at the global edge equal
  ``gradient2d``'s one-sided ones;
* ``'zero'`` / ``'nan'`` — a constant (kernels that mask by global
  coordinates themselves, e.g. the openness scan);
* ``'none'``      — left as exchanged (zeros).

A radius larger than a block gathers the halo from several blocks
("multi-hop"); only the constant fills can be reconstructed there, and
the reflect family raises.
"""

from __future__ import annotations

import torch

from ..ops.visibility import as_raster

__all__ = ["halo_exchange_2d", "sharded_apply", "block_origin"]

_MODES = ("symmetric", "edge", "linear", "zero", "nan", "none")


def _exchange_axis(out, strips, i, radius, axis):
    """Fill the halos of ``out`` (padded by ``radius`` along ``axis``)
    from ``strips``: the n blocks of one mesh row (axis 1) or column
    (axis 0), each of extent bs along ``axis``, block ``i`` being the one
    ``out`` pads.  Positions beyond the mesh are left as they are."""
    bs = strips[0].shape[axis]
    lo = i * bs - radius                   # global index of out's position 0
    for k, src in enumerate(strips):
        if k == i:
            continue
        # the part of block k (global [k*bs, k*bs + bs)) inside out's span
        start = max(k * bs, lo)
        stop = min(k * bs + bs, lo + out.shape[axis])
        if start < stop:
            out.narrow(axis, start - lo, stop - start).copy_(
                src.narrow(axis, start - k * bs, stop - start),
                non_blocking=True)


def _boundary_fill(p, radius, axis, at_start, at_end, mode):
    """Overwrite the out-of-mesh halo of ``p`` (padded by ``radius`` along
    ``axis``) with ``mode``'s global boundary semantics; both fills are
    computed before either is written."""
    if mode == "none" or not (at_start or at_end):
        return
    n = p.shape[axis]
    r = radius
    head = p.narrow(axis, 0, r)
    tail = p.narrow(axis, n - r, r)
    if mode == "symmetric":
        fill_s = p.narrow(axis, r, r).flip(axis)
        fill_e = p.narrow(axis, n - 2 * r, r).flip(axis)
    elif mode == "edge":
        fill_s = p.narrow(axis, r, 1).expand_as(head)
        fill_e = p.narrow(axis, n - r - 1, 1).expand_as(tail)
    elif mode == "linear":
        shape = [1, 1]
        shape[axis] = r
        d = torch.arange(1, r + 1, dtype=p.dtype, device=p.device).view(shape)
        e0, e1 = p.narrow(axis, r, 1), p.narrow(axis, r + 1, 1)
        f0, f1 = p.narrow(axis, n - r - 1, 1), p.narrow(axis, n - r - 2, 1)
        fill_s = e0 + d.flip(axis) * (e0 - e1)   # distance r .. 1
        fill_e = f0 + d * (f0 - f1)              # distance 1 .. r
    else:
        value = 0.0 if mode == "zero" else float("nan")
        fill_s = torch.full_like(head, value)
        fill_e = torch.full_like(tail, value)
    # read both (views of p) before writing either
    fill_s, fill_e = fill_s.clone(), fill_e.clone()
    if at_start:
        head.copy_(fill_s)
    if at_end:
        tail.copy_(fill_e)


def _beyond_mesh_fill(p, radius, axis, i, bs, n_shards, mode):
    """Multi-hop halos: positions whose global index falls off the mesh
    keep the exchange's zeros for ``'zero'`` and become NaN otherwise, as
    the JAX package's ``_beyond_mesh_fill``."""
    if mode == "zero":
        return
    before = max(0, radius - i * bs)
    after = max(0, radius - (n_shards - 1 - i) * bs)
    p.narrow(axis, 0, before).fill_(float("nan"))
    p.narrow(axis, p.shape[axis] - after, after).fill_(float("nan"))


def halo_exchange_2d(blocks, radius, mode="symmetric"):
    """Pad every block of a mesh with ``radius`` rows/cols of its
    neighbours' data and fill the global-boundary halos per ``mode``.

    ``blocks`` is the (ny, nx) grid of equal-shaped 2-D tensors, as nested
    sequences, each on its own mesh device; it stands for the JAX
    function's ``block`` plus ``mesh_shape``, which ``shard_map`` supplies
    there.  Returns the grid of padded (bh + 2r, bw + 2r) tensors, each on
    its block's device.  ``radius`` may exceed a block: the halo is then
    gathered from several blocks (multi-hop), which only the constant
    fills ('zero', 'nan', 'none') support."""
    grid = [list(row) for row in blocks]
    ny, nx = len(grid), len(grid[0])
    bh, bw = grid[0][0].shape
    if any(len(row) != nx or any(b.shape != (bh, bw) for b in row)
           for row in grid):
        raise ValueError("blocks must form a full grid of equal shapes")
    if mode not in _MODES:
        raise ValueError(f"unknown halo mode {mode}")
    r = int(radius)
    multi_col = nx > 1 and r > bw
    multi_row = ny > 1 and r > bh
    if (multi_col or multi_row) and mode not in ("zero", "nan", "none"):
        raise ValueError(
            f"halo radius {r} exceeds the per-device block ({bh}, {bw}) and "
            f"mode={mode!r} cannot be reconstructed multi-hop; use mode "
            "'zero'/'nan' or fewer shards")

    out = [[torch.zeros((bh + 2 * r, bw + 2 * r), dtype=b.dtype,
                        device=b.device) for b in row] for row in grid]
    # columns first: the core rows of each padded block
    cols = [[o.narrow(0, r, bh) for o in row] for row in out]
    for y in range(ny):
        for x in range(nx):
            cols[y][x].narrow(1, r, bw).copy_(grid[y][x])
            if r == 0:
                continue
            _exchange_axis(cols[y][x], grid[y], x, r, axis=1)
            if multi_col:
                _beyond_mesh_fill(cols[y][x], r, 1, x, bw, nx, mode)
            else:
                _boundary_fill(cols[y][x], r, 1, x == 0, x == nx - 1, mode)
    if r == 0:
        return out
    # then rows, from the column-padded neighbours: corners come with them
    for y in range(ny):
        for x in range(nx):
            _exchange_axis(out[y][x], [cols[k][x] for k in range(ny)], y, r,
                           axis=0)
            if multi_row:
                _beyond_mesh_fill(out[y][x], r, 0, y, bh, ny, mode)
            else:
                _boundary_fill(out[y][x], r, 0, y == 0, y == ny - 1, mode)
    return out


def _device_grid(mesh, axis_names):
    """The mesh's devices with ``axis_names[0]`` along rows."""
    names = tuple(axis_names)
    if names == mesh.axis_names:
        return mesh.devices
    if names == mesh.axis_names[::-1]:
        return mesh.devices.T
    raise ValueError(f"axis_names {names} do not name the mesh's axes "
                     f"{mesh.axis_names}")


def _shard(Z, grid):
    """Cut ``Z`` into the (ny, nx) grid of blocks, each on its device (a
    view where the device is Z's own)."""
    ny, nx = grid.shape
    bh, bw = Z.shape[0] // ny, Z.shape[1] // nx
    return [[Z[y * bh:(y + 1) * bh, x * bw:(x + 1) * bw].to(
        grid[y, x], non_blocking=True) for x in range(nx)] for y in range(ny)]


def _assemble(blocks, grid):
    """One tensor on ``grid[0, 0]`` from the grid of result blocks (their
    last two dimensions tile the raster)."""
    dev = grid[0, 0]
    return torch.cat([torch.cat([b.to(dev, non_blocking=True) for b in row],
                                dim=-1) for row in blocks], dim=-2)


def block_origin(block_shape, index):
    """Global (row, col) origin of the block at mesh ``index`` (iy, ix)."""
    return index[0] * block_shape[0], index[1] * block_shape[1]


def sharded_apply(fn, Z, mesh, radius, mode="symmetric",
                  axis_names=("ty", "tx")):
    """Run ``fn(padded_block) -> padded_or_core_block`` over a 2-D mesh
    with halo exchange, reassembling the global result on
    ``mesh.devices[0, 0]``.

    ``fn`` receives a block padded by ``radius`` on every side and must
    return either the same padded shape (cropped here) or the core
    block; leading dimensions are kept."""
    grid = _device_grid(mesh, axis_names)
    ny, nx = grid.shape
    Z = as_raster(Z, None if isinstance(Z, torch.Tensor) else grid[0, 0])
    H, W = Z.shape
    if H % ny or W % nx:
        raise ValueError(f"grid {tuple(Z.shape)} not divisible by mesh "
                         f"{ny}x{nx}; pad first")
    bh, bw = H // ny, W // nx
    r = int(radius)

    def local(padded):
        out = fn(padded)
        if tuple(out.shape[-2:]) == (bh + 2 * r, bw + 2 * r):
            out = out[..., r:r + bh, r:r + bw]
        return out

    padded = halo_exchange_2d(_shard(Z, grid), r, mode)
    return _assemble([[local(p) for p in row] for row in padded], grid)
