"""The tile path of every kernel, K1, K2, K3, K4 and K5 for the counts and
the reductions (``csrc/ladder_tile.cuh``), on the CPU: its host mirror
``cuda_scan.tile_route`` held against brute force in numpy.

- soundness: every read of every ladder step of every pixel of a tile CTA
  lies in the tile's shared-memory window and on the raster, on the
  routing rasters' shapes (incl. 257x389 and 1000x1537) at lookups 1, 12,
  24, 50 and 100 on both ladders (every halo bucket);
- every tile CTA lies in K5's interior region (K5) and is maskless in all
  8 directions under the dynamic predicate (both), so the tile body (the
  maskless step) computes what the per-thread bodies compute there;
- the per-thread kernels' 1-D grid (``ladder_tile.cuh:unit_at``) covers
  every 32x8 block outside the tiles once and no block inside them;
- shared memory stays within the card's 232,448 bytes, and a lookup
  beyond it gets no tile; at 8192^2, lookup 50, >= 95% of the pixels lie
  in tile CTAs;
- where no tile fits (an exact reach beyond the largest halo bucket, a
  raster or a shard core smaller than one tile) the tile arguments are
  zeros, and the per-thread bodies' routes give the masked ladder's CPU
  outputs (counts and each reduction);
- the reduced wrappers hand their C entries the tile arguments of
  ``_tile_args`` (K2 the dynamic tiles, K5/reduced the plan's interior)
  in the entry's order, zeros where no tile fits;
  ``cuda_scan.tile_loads`` counts each tile-path launch by shape and
  load path;
- shard blocks (K4 on its core's grid at (R, R), K3's origin entry on the
  haloed block), the blocks of 1x1, 2x2 and 2x3 meshes over three rasters
  at lookups 1, 12, 24 and 50 on both ladders: every read in the window,
  on the block and inside the global raster; every tile all-safe under
  ``dynamic_safe`` with the block's origin, and the rectangle the largest
  such; a window on the block but off the raster takes no tile; the unit
  grid covers the rest of the core's (K4) or the block's (K3) grid once;
  >= 90% of a 4096^2 core (K4) and of a 4196^2 block (K3) in tiles at
  lookup 50; the haloed blocks TMA can load.

The kernels themselves run on the card only: the ``cuda`` tests skip here
and, with ``chip_smoke.py``, hold every kernel against the plain version,
on inputs that take tiles and on inputs where no tile fits.
"""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neilpy_tpu_torch.core.shift import OFFSETS
from neilpy_tpu_torch.ops import cuda_scan as cs

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
# K2's mode variants, (mode, keyword arguments), as chip_smoke.py runs them
from chip_smoke import REDUCED_VARIANTS  # noqa: E402

torch.set_num_threads(1)

# chip_smoke.py's route_rasters() shapes, and one with a NaN hole inside
# a tile at W % 4 != 0 (the cp.async load path)
SHAPES = [(100, 140), (1000, 1537), (600, 900), (257, 389), (97, 45),
          (24, 32), (515, 771)]
LOOKUPS = (1, 12, 24, 50, 100)


def _reach(lookup, fast):
    ladder = cs._ladder(lookup, fast)
    return ladder, ladder[-1], len(ladder)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("lookup", LOOKUPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_reads_stay_in_window_and_on_raster(shape, lookup, fast):
    """Brute force over every tile pixel, direction and ladder step.  The
    tiles form a rectangle of whole tiles, so a read's row depends only on
    the pixel's row and its column only on the pixel's column: checking
    every (row, step) and every (column, step) checks every read."""
    H, W = shape
    ladder, Rmax, K = _reach(lookup, fast)
    th, tw = cs.TILE
    for spec in (False, True):
        t = cs.tile_route(H, W, Rmax, spec, K)
        if not t.n_tiles:
            continue
        assert t.halo >= Rmax
        rows = np.arange(t.rows[0] * th, t.rows[1] * th)
        cols = np.arange(t.cols[0] * tw, t.cols[1] * tw)
        r0 = rows // th * th  # each pixel's tile origin
        c0 = cols // tw * tw
        for dr, dc in OFFSETS:
            for L in ladder:
                rr = rows + dr * L
                cc = cols + dc * L
                # the window: rows r0 - Rmax .. r0 + th + Rmax, columns
                # c0 - Rmax .. c0 + tw + Rmax (what both load paths fill)
                assert ((rr >= r0 - Rmax) & (rr < r0 + th + Rmax)).all()
                assert ((cc >= c0 - Rmax) & (cc < c0 + tw + Rmax)).all()
                assert ((rr >= 0) & (rr < H)).all()
                assert ((cc >= 0) & (cc < W)).all()
        # the whole window is on the raster (the TMA box's rows, the
        # cp.async copy's rows and columns)
        assert r0.min() - Rmax >= 0 and r0.max() + th + Rmax <= H
        assert c0.min() - Rmax >= 0 and c0.max() + tw + Rmax <= W


def _tile_blocks(t, grid):
    """(nby, nbx) bool: the 32x8 blocks that lie in a tile CTA."""
    out = np.zeros(grid, dtype=bool)
    uy, ux = cs.TILE[0] // cs.BLOCK[0], cs.TILE[1] // cs.BLOCK[1]
    out[t.rows[0] * uy:t.rows[1] * uy, t.cols[0] * ux:t.cols[1] * ux] = True
    return out


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(8192, 8192), (4196, 4196)])
def test_tiles_are_all_safe_and_in_the_interior(shape, fast):
    H, W = shape
    grid = cs._grid(H, W)
    for lookup in LOOKUPS:
        _, Rmax, K = _reach(lookup, fast)
        dyn = cs.dynamic_safe((H, W), Rmax).all(axis=0)
        stat = cs.plan_safe(H, W, Rmax).all(axis=0)
        rlo, rhi, _, clo, chi, _ = cs.region_plan(H, W, Rmax)
        for spec in (False, True):
            t = cs.tile_route(H, W, Rmax, spec, K)
            blocks = _tile_blocks(t, grid)
            assert not (blocks & ~dyn).any(), (lookup, spec)
            if spec:
                assert not (blocks & ~stat).any(), lookup
                th, tw = cs.TILE
                if t.n_tiles:
                    assert t.rows[0] * th >= rlo and t.rows[1] * th <= rhi
                    assert t.cols[0] * tw >= clo and t.cols[1] * tw <= chi
            # no tile reaches past the raster (the grid's ragged edge)
            assert t.rows[1] * cs.TILE[0] <= H or not t.n_tiles
            assert t.cols[1] * cs.TILE[1] <= W or not t.n_tiles


def _unit_at(i, nbx, hy0, hy1, hx0, hx1):
    """A copy of ``ladder_tile.cuh:unit_at`` (the 32x8 block of the
    per-thread kernels' 1-D grid), in Python integers."""
    above = hy0 * nbx
    hw = hx1 - hx0
    beside = (hy1 - hy0) * (nbx - hw)
    if i < above:
        return divmod(i, nbx)
    if i - above < beside:
        by, bx = divmod(i - above, nbx - hw)
        return by + hy0, bx + (hw if bx >= hx0 else 0)
    by, bx = divmod(i - above - beside, nbx)
    return by + hy1, bx


@pytest.mark.parametrize("shape,lookup,spec", [
    ((1000, 1537), 50, True), ((257, 389), 12, False), ((600, 900), 1, True),
    ((97, 45), 7, False), ((24, 32), 1, True), ((515, 771), 33, False)])
def test_unit_grid_covers_what_tiles_leave(shape, lookup, spec):
    H, W = shape
    nby, nbx = cs._grid(H, W)
    t = cs.tile_route(H, W, lookup, spec)
    uy, ux = cs.TILE[0] // cs.BLOCK[0], cs.TILE[1] // cs.BLOCK[1]
    hole = (t.rows[0] * uy, t.rows[1] * uy, t.cols[0] * ux, t.cols[1] * ux)
    # ladder_tile.cuh:unit_blocks
    n = nby * nbx - (hole[1] - hole[0]) * (hole[3] - hole[2])
    seen = np.zeros((nby, nbx), dtype=int)
    for i in range(n):
        by, bx = _unit_at(i, nbx, *hole)
        seen[by, bx] += 1
    tiles = _tile_blocks(t, (nby, nbx))
    assert (seen[~tiles] == 1).all() and (seen[tiles] == 0).all()
    if lookup <= 12 and min(shape) >= 257:
        assert tiles.any()


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("spec", [False, True])
def test_smem_cap_and_tile_share(spec, fast):
    for lookup in range(1, 121):
        _, Rmax, K = _reach(lookup, fast)
        t = cs.tile_route(8192, 8192, Rmax, spec, K)
        assert t.smem_bytes <= cs.SMEM_CAP
        # the C formula, ladder_tile.cuh:tile_smem_bytes
        if t.n_tiles:
            assert t.smem_bytes == (128 + 4 * (32 + 2 * Rmax)
                                    * (64 + 2 * t.halo) + 64 * K + 8)
            # the TMA box: at most 256 per dimension; it starts 64 B aligned
            # and its rows are a multiple of 128 B (a bucket of 50 stopped
            # the kernel on the card)
            assert 64 + 2 * t.halo <= 256 and 32 + 2 * Rmax <= 256
            assert t.halo % 16 == 0
            # the smallest bucket that holds the reach
            assert t.halo == min(h for h in cs._TILE_HALOS if h >= Rmax)
        if cs._tile_smem_bytes(96, Rmax, K) > cs.SMEM_CAP or Rmax > 96:
            assert not t.n_tiles and t.halo == 0, lookup
    # beyond the cap: exact lookup 95 fits the 96 bucket, not the card
    assert not cs.tile_route(8192, 8192, 95, spec).n_tiles
    assert not cs.tile_route(8192, 8192, 100, spec).n_tiles
    assert cs.tile_route(8192, 8192, 94, spec).n_tiles
    _, Rmax, K = _reach(50, fast)
    t = cs.tile_route(8192, 8192, Rmax, spec, K)
    assert t.pixels(8192, 8192).mean() >= 0.95
    # two tile CTAs per SM at the main path's lookup
    assert 2 * t.smem_bytes <= 228 * 1024


@pytest.mark.parametrize("output", ["counts", *REDUCED_VARIANTS])
def test_tile_switches_change_no_route_or_output(output):
    """Where no tile fits (exact lookup 100, a reach beyond the largest
    halo bucket) the kernels get all-zero tile arguments, while at lookup
    12 on the same raster they get a tile; the per-thread bodies then run
    every block on the route tables' routes: K5's plan (unsafe wherever
    the dynamic predicate is, and some blocks maskless under both) and the
    dynamic predicate give the masked ladder's CPU outputs (the counts,
    each reduction), and the 98.9% maskless share at 8192^2 stays."""
    Z = torch.from_numpy(np.random.default_rng(5).normal(size=(257, 389))
                         .cumsum(0).cumsum(1).astype(np.float32))
    args = cs._tile_args(Z, 12, 12, True)
    assert args[0] == 16 and args[5] == 0
    _, Rmax, K = _reach(100, False)
    assert Rmax > max(cs._TILE_HALOS)
    for plan in (False, True):
        assert cs._tile_args(Z, Rmax, K, plan) == (0,) * 6
    static = cs.route_table(Z, 100, specialize=True)
    dynamic = cs.route_table(Z, 100, specialize=False)
    assert not (static & ~dynamic).any() and static.any()
    kw = dict(cellsize=2.0, lookup_pixels=100)
    if output == "counts":
        def run(route):
            return cs.openness_counts_torch(Z, threshold_angle=1.0,
                                            route=route, **kw)
    else:
        mode, extra = REDUCED_VARIANTS[output]

        def run(route):
            return cs.openness_reduced_torch(Z, mode, route=route, **kw,
                                             **extra)
    masked = run(None)
    for route in ("static", "dynamic"):
        assert all(torch.equal(a, b) for a, b in zip(run(route), masked))
    big = torch.empty((8192, 8192), dtype=torch.float32)
    share = float(cs.route_table(big, 50, specialize=True).float().mean())
    assert abs(share - 0.989) < 5e-4


def test_tile_load_rule():
    """TMA where the row pitch is a multiple of 16 bytes and the base is
    16-byte aligned, cp.async otherwise."""
    assert cs._tile_load(torch.zeros((64, 900))) == 1
    assert cs._tile_load(torch.zeros((64, 1537))) == 0
    assert cs._tile_load(torch.zeros((64, 901))[:, 1:].contiguous()) == 1
    assert cs._tile_load(torch.zeros(64 * 900 + 1)[1:].view(64, 900)) == 0


def _shard_geometries(shape, mesh, lookup):
    """The haloed blocks ``dist/api.py`` makes of an (H, W) raster on a
    ``mesh`` = (ny, nx) mesh at halo R = ``lookup``: per block its array
    shape and the tile geometry of K4 (the core's grid at (R, R)) and of
    K3's origin entry (the whole block), as the wrappers pass them."""
    ny, nx = mesh
    R = lookup
    GH, GW = -(-shape[0] // ny) * ny, -(-shape[1] // nx) * nx
    bh, bw = GH // ny, GW // nx
    out = []
    for y in range(ny):
        for x in range(nx):
            org = (y * bh - R, x * bw - R)
            arr = (bh + 2 * R, bw + 2 * R)
            out.append((arr, "K4", dict(grid0=(R, R), core=(bh, bw),
                                        origin=org, global_shape=(GH, GW))))
            out.append((arr, "K3", dict(origin=org, global_shape=(GH, GW))))
    return out


def _grid_geometry(arr, geom):
    """(grid0, grid extent, origin, global shape) with the defaults
    ``tile_route`` takes."""
    g0 = geom.get("grid0", (0, 0))
    core = geom.get("core") or (arr[0] - g0[0], arr[1] - g0[1])
    return g0, core, geom["origin"], geom["global_shape"]


SHARD_SHAPES = [(257, 389), (1000, 1537), (515, 771)]
SHARD_MESHES = [(1, 1), (2, 2), (2, 3)]
SHARD_LOOKUPS = (1, 12, 24, 50)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("lookup", SHARD_LOOKUPS)
@pytest.mark.parametrize("mesh", SHARD_MESHES)
@pytest.mark.parametrize("shape", SHARD_SHAPES)
def test_shard_tile_reads_stay_in_window_on_block_and_in_raster(
        shape, mesh, lookup, fast):
    """Brute force over every tile pixel, direction and ladder step of K4's
    and K3's origin tiles, as for a whole raster: each read of grid pixel
    (i, j) lies at block pixel grid0 + (i, j) + d*L, in the tile's window,
    on the block and, at global block pixel + origin, inside the raster;
    the whole window (what TMA's box rows and cp.async copy) too."""
    ladder, Rmax, K = _reach(lookup, fast)
    th, tw = cs.TILE
    n_tiles = 0
    for arr, kid, geom in _shard_geometries(shape, mesh, lookup):
        t = cs.tile_route(*arr, Rmax, False, K, **geom)
        if not t.n_tiles:
            continue
        n_tiles += t.n_tiles
        (g0r, g0c), (gh, gw), (org_r, org_c), (GH, GW) = _grid_geometry(
            arr, geom)
        assert t.halo >= Rmax + g0c % 16
        assert t.halo == min(h for h in cs._TILE_HALOS if h >= Rmax + g0c % 16)
        rows = np.arange(t.rows[0] * th, t.rows[1] * th)
        cols = np.arange(t.cols[0] * tw, t.cols[1] * tw)
        # in the grid: every tile pixel is an output pixel of the kernel
        assert rows.min() >= 0 and rows.max() < gh
        assert cols.min() >= 0 and cols.max() < gw
        r0 = g0r + rows // th * th  # each pixel's tile origin in the block
        c0 = g0c + cols // tw * tw
        for dr, dc in OFFSETS:
            for L in ladder:
                rr = g0r + rows + dr * L
                cc = g0c + cols + dc * L
                assert ((rr >= r0 - Rmax) & (rr < r0 + th + Rmax)).all(), kid
                assert ((cc >= c0 - Rmax) & (cc < c0 + tw + Rmax)).all(), kid
                assert ((rr >= 0) & (rr < arr[0])).all(), kid
                assert ((cc >= 0) & (cc < arr[1])).all(), kid
                assert ((rr + org_r >= 0) & (rr + org_r < GH)).all(), kid
                assert ((cc + org_c >= 0) & (cc + org_c < GW)).all(), kid
        for lo, hi, n, org, gn in ((r0.min() - Rmax, r0.max() + th + Rmax,
                                    arr[0], org_r, GH),
                                   (c0.min() - Rmax, c0.max() + tw + Rmax,
                                    arr[1], org_c, GW)):
            assert lo >= 0 and hi <= n, kid
            assert lo + org >= 0 and hi + org <= gn, kid
    if lookup <= 24 and min(shape) >= 500:
        assert n_tiles > 0


@pytest.mark.parametrize("mesh", SHARD_MESHES)
@pytest.mark.parametrize("shape", SHARD_SHAPES)
def test_shard_tiles_are_the_all_safe_rectangle(shape, mesh):
    """Every tile's 32x8 blocks are maskless in all 8 directions under
    ``dynamic_safe`` with the block's origin and the global shape, and the
    rectangle holds every whole tile of the grid that is: the model is
    sound and gives nothing away."""
    th, tw = cs.TILE
    uy, ux = th // cs.BLOCK[0], tw // cs.BLOCK[1]
    for lookup in SHARD_LOOKUPS:
        for fast in (False, True):
            _, Rmax, K = _reach(lookup, fast)
            for arr, kid, geom in _shard_geometries(shape, mesh, lookup):
                g0, (gh, gw), org, gshape = _grid_geometry(arr, geom)
                grid = (-(-gh // cs.BLOCK[0]), -(-gw // cs.BLOCK[1]))
                safe = cs.dynamic_safe(arr, Rmax, grid, g0, org,
                                       gshape).all(axis=0)
                t = cs.tile_route(*arr, Rmax, False, K, **geom)
                # the whole tiles of the grid whose blocks are all safe
                ny, nx = gh // th, gw // tw
                ok = safe[:ny * uy, :nx * ux].reshape(ny, uy, nx, ux)
                ok = ok.all(axis=(1, 3))
                want = np.zeros((ny, nx), dtype=bool)
                want[t.rows[0]:t.rows[1], t.cols[0]:t.cols[1]] = True
                if t.halo:
                    assert np.array_equal(ok, want), (kid, lookup, fast)
                else:
                    assert not t.n_tiles


def test_window_on_block_but_off_raster_takes_no_tile():
    """K3's origin entry on block (0, 0) of a 2x2 mesh over 8192^2 at lookup
    50: the tiles of rows 64-127 and of columns 64-127 have their windows on
    the block, so the block alone would give them the tile body, but their
    windows reach above or left of the raster, where the per-thread body
    clamps the last step; the origin takes them out.  At the far edges the
    block ends before the raster, so there the block decides."""
    R, Rmax = 50, 50
    arr = (4096 + 2 * R,) * 2
    alone = cs.tile_route(*arr, Rmax, False)
    t = cs.tile_route(*arr, Rmax, False, origin=(-R, -R),
                      global_shape=(8192, 8192))
    assert alone.rows == (2, 129) and alone.cols == (1, 64)
    assert t.rows == (4, 129) and t.cols == (2, 64)
    safe = cs.dynamic_safe(arr, Rmax, origin=(-R, -R),
                           global_shape=(8192, 8192))
    # each tile the origin took out holds a block that is not safe in
    # every direction, in every tile column (rows) and tile row (columns)
    for ty in (2, 3):
        assert not safe[:, ty * 4:(ty + 1) * 4].all(axis=(0, 1)).any()
    assert not safe[:, :, 1 * 2:2 * 2].all(axis=(0, 2)).any()
    # K4 on the same block: its grid starts at (R, R), its tiles' windows
    # start at core row 32 * ty - Rmax, on the raster from ty = 2
    k4 = cs.tile_route(*arr, Rmax, False, grid0=(R, R), core=(4096, 4096),
                       origin=(-R, -R), global_shape=(8192, 8192))
    assert k4.rows == (2, 128) and k4.cols == (1, 64)


@pytest.mark.parametrize("shape,mesh,lookup,kid", [
    ((1000, 1537), (2, 2), 12, "K4"), ((1000, 1537), (2, 3), 50, "K3"),
    ((515, 771), (2, 2), 24, "K4"), ((257, 389), (1, 1), 1, "K3"),
    ((515, 771), (2, 3), 12, "K3"), ((257, 389), (2, 2), 50, "K4")])
def test_unit_grid_covers_what_shard_tiles_leave(shape, mesh, lookup, kid):
    """The per-thread kernels' 1-D grid runs over K4's core grid and K3's
    block grid: every 32x8 block outside the tiles once, none inside."""
    uy, ux = cs.TILE[0] // cs.BLOCK[0], cs.TILE[1] // cs.BLOCK[1]
    for arr, k, geom in _shard_geometries(shape, mesh, lookup):
        if k != kid:
            continue
        _, (gh, gw), _, _ = _grid_geometry(arr, geom)
        nby, nbx = -(-gh // cs.BLOCK[0]), -(-gw // cs.BLOCK[1])
        t = cs.tile_route(*arr, lookup, False, **geom)
        hole = (t.rows[0] * uy, t.rows[1] * uy, t.cols[0] * ux,
                t.cols[1] * ux)
        n = nby * nbx - (hole[1] - hole[0]) * (hole[3] - hole[2])
        seen = np.zeros((nby, nbx), dtype=int)
        for i in range(n):
            by, bx = _unit_at(i, nbx, *hole)
            seen[by, bx] += 1
        tiles = _tile_blocks(t, (nby, nbx))
        assert (seen[~tiles] == 1).all() and (seen[tiles] == 0).all()


@pytest.mark.parametrize("fast", [False, True])
def test_shard_tile_share_at_lookup_50(fast):
    """At 8192^2, lookup 50, on the 2x2 mesh: >= 90% of every 4096^2 core
    (K4) and of every 4196^2 haloed block (K3's origin entry: 0.90-0.92,
    its halo rows and columns near the raster's edge stay per-thread) lie
    in tiles; on make_mesh()'s 1x1 block, K4 covers what K1 covers."""
    _, Rmax, K = _reach(50, fast)
    shares = {"K4": [], "K3": []}
    for arr, kid, geom in _shard_geometries((8192, 8192), (2, 2), 50):
        t = cs.tile_route(*arr, Rmax, False, K, **geom)
        _, (gh, gw), _, _ = _grid_geometry(arr, geom)
        shares[kid].append(t.n_tiles * cs.TILE[0] * cs.TILE[1] / (gh * gw))
        assert 2 * t.smem_bytes <= 228 * 1024
    assert min(shares["K4"]) >= 0.9 and min(shares["K3"]) >= 0.9, shares
    (arr, _, geom), = [g for g in _shard_geometries((8192, 8192), (1, 1), 50)
                       if g[1] == "K4"]
    one = cs.tile_route(*arr, Rmax, False, K, **geom)
    whole = cs.tile_route(8192, 8192, Rmax, False, K)
    assert (one.rows, one.cols) == (whole.rows, whole.cols)


def test_haloed_blocks_take_tma():
    """The haloed blocks of the sharded path are contiguous, 16-byte
    aligned and 4196 / 8292 floats wide at 8192^2, lookup 50 (here on a
    128-row raster of the same width), so the tile kernel loads them with
    TMA; a width that is not a multiple of 4 goes to cp.async."""
    from neilpy_tpu_torch.dist.halo import _shard, halo_exchange_2d
    Z = torch.zeros((128, 8192))
    for mesh, width in (((1, 2), 4196), ((1, 1), 8292)):
        grid = np.empty(mesh, dtype=object)
        grid[:] = torch.device("cpu")
        for row in halo_exchange_2d(_shard(Z, grid), 50, "nan"):
            for block in row:
                assert block.shape == (228, width) and block.is_contiguous()
                assert block.data_ptr() % 16 == 0
                assert cs._tile_load(block) == 1
    odd = halo_exchange_2d(_shard(torch.zeros((64, 771)), grid), 1, "nan")
    assert cs._tile_load(odd[0][0]) == 0


def test_shard_tile_args_follow_the_switches():
    """The K3 and K4 tile arguments of a haloed 4196^2 block at lookup 50,
    and all zeros, as K1's, where no tile fits: at exact lookup 100 on the
    same geometry and on a block whose core is smaller than one tile."""
    block = torch.zeros((4196, 4196))
    geom = dict(grid0=(50, 50), core=(4096, 4096), origin=(-50, -50),
                global_shape=(8192, 8192))
    assert cs._tile_args(block, 50, 50, False, **geom) == (64, 2, 128, 1, 64,
                                                           1)
    _, Rmax, K = _reach(100, False)
    geom = dict(grid0=(100, 100), core=(3996, 3996), origin=(-100, -100),
                global_shape=(8192, 8192))
    assert cs._tile_args(block, Rmax, K, False, **geom) == (0,) * 6
    small = torch.zeros((124, 148))
    geom = dict(grid0=(50, 50), core=(24, 48), origin=(-50, -50),
                global_shape=(8192, 8192))
    assert cs._tile_args(small, 50, 50, False, **geom) == (0,) * 6


# the reduced wrappers' inputs: (shape, lookup, fast, the tile load path
# or None where no tile fits): tiles (TMA on a 900-wide raster, cp.async
# on a 771-wide one); an exact reach beyond the largest halo bucket on
# the same rasters; rasters smaller than one tile's window
WRAPPER_INPUTS = {
    "tiled": (((600, 900), 50, False, 1), ((600, 900), 50, True, 1),
              ((515, 771), 12, False, 0)),
    "beyond_halo": (((600, 900), 100, False, None),
                    ((600, 900), 95, False, None),
                    ((515, 771), 100, False, None)),
    "small": (((40, 60), 12, False, None), ((30, 200), 2, True, None),
              ((97, 45), 1, False, None)),
}


@pytest.mark.parametrize("inputs", list(WRAPPER_INPUTS))
@pytest.mark.parametrize("variant", list(REDUCED_VARIANTS))
@pytest.mark.parametrize("plan", [False, True])
def test_reduced_wrappers_pass_the_tile_arguments(monkeypatch, plan, variant,
                                                  inputs):
    """What K2 (``plan`` False) and K5/reduced hand their C entries, caught
    at ``cuda_scan._run_entry``: the head (raster, ladder), then
    ``_tile_args(..., plan)``, then K5's region plan, then the mode,
    ``neg_mode``, the threshold's tangent and the mode's output pointers,
    as many as the entry's ctypes declaration takes; the tile arguments
    are ``tile_route``'s with the load path where a tile fits, zeros where
    none does (``WRAPPER_INPUTS``)."""
    from neilpy_tpu_torch import _build
    mode, extra = REDUCED_VARIANTS[variant]
    fn = cs.openness_reduced_plan_cuda if plan else cs.openness_reduced_cuda
    entry = ("openness_reduced_plan_launch" if plan
             else "openness_reduced_launch")
    calls = []
    monkeypatch.setattr(cs, "_check_cuda", lambda Z, name: None)
    monkeypatch.setattr(cs, "_run_entry",
                        lambda Z, name, args: calls.append((name, args)))
    monkeypatch.setattr(fn, "launches", 0)
    for shape, lookup, fast, tma in WRAPPER_INPUTS[inputs]:
        Z = torch.zeros(shape)
        outs = fn(Z, mode, cellsize=2.0, lookup_pixels=lookup, fast=fast,
                  **extra)
        name, args = calls.pop()
        assert name == entry
        assert len(args) + 1 == len(_build.entry_argtypes()[entry])
        ladder = cs._ladder(lookup, fast)
        Rmax, K = ladder[-1], len(ladder)
        dense = ladder == tuple(range(1, K + 1))
        assert args[:8] == (Z.data_ptr(), *shape, args[3], args[4], K, Rmax,
                            int(dense))
        tile = args[8:14]
        assert tile == cs._tile_args(Z, Rmax, K, plan)
        want = cs.tile_route(*shape, Rmax, plan, K)
        if tma is None:
            assert tile == (0,) * 6 and want.n_tiles == 0
        else:
            assert tile == (want.halo, *want.rows, *want.cols, tma)
            assert want.n_tiles > 0
        rest = args[14:]
        if plan:
            assert rest[:6] == cs.region_plan(*shape, Rmax)
            rest = rest[6:]
        neg = extra.get("neg_mode", True)
        assert rest[:3] == (cs._MODES[mode], int(neg),
                            cs._threshold_tangent(
                                extra.get("threshold_angle", 0.0)))
        # (out0, out1, code): the pointers the mode writes, None for the rest
        p = [t.data_ptr() for t in outs]
        assert rest[3:] == {"openness": (*p, None), "svf": (*p, None, None),
                            "ternary": (None, None, *p)}[mode]
    assert fn.launches == 3


def test_tile_path_launches_are_counted_by_shape_and_load(monkeypatch):
    """``cuda_scan.tile_loads`` counts each launch that took the tile path
    by (rows, columns, load path), after the launch: K1 on a 900-wide
    raster (TMA) twice and a 771-wide one (cp.async) once; nothing for a
    launch where no tile fits (exact lookup 100), and nothing for a launch
    that raised."""
    monkeypatch.setattr(cs, "_check_cuda", lambda Z, name: None)
    monkeypatch.setattr(cs, "_run_entry", lambda Z, name, args: None)
    monkeypatch.setattr(cs, "tile_loads", collections.Counter())
    monkeypatch.setattr(cs.openness_counts_cuda, "launches", 0)
    for shape in ((600, 900), (600, 900), (515, 771)):
        cs.openness_counts_cuda(torch.zeros(shape), lookup_pixels=50)
    assert cs.tile_loads == {(600, 900, 1): 2, (515, 771, 0): 1}
    cs.openness_counts_cuda(torch.zeros((600, 900)), lookup_pixels=100)

    def fail(Z, name, args):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(cs, "_run_entry", fail)
    with pytest.raises(RuntimeError):
        cs.openness_counts_cuda(torch.zeros((600, 900)), lookup_pixels=50)
    assert cs.tile_loads == {(600, 900, 1): 2, (515, 771, 0): 1}
    assert cs.openness_counts_cuda.launches == 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (shape, lookup, fast) of the card tests: tiles on both load paths, and
# an exact reach where no tile fits, so the per-thread bodies run every
# block
CARD_CASES = [((600, 900), 12, False), ((515, 771), 50, True),
              ((1000, 1537), 50, False), ((600, 900), 100, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lookup,fast", CARD_CASES)
def test_tile_path_matches_plain_on_card(card, shape, lookup, fast):
    Z = np.random.default_rng(9).normal(size=shape).cumsum(0).cumsum(1)
    Z = Z.astype(np.float32)
    Z[shape[0] // 2, shape[1] // 2] = np.nan
    Zd = torch.from_numpy(Z).to(card)
    kw = dict(cellsize=2.0, lookup_pixels=lookup, threshold_angle=1.0,
              fast=fast)
    plain = cs.openness_counts_torch(Zd, **kw)
    for fn in (cs.openness_counts_cuda, cs.openness_counts_plan_cuda):
        # pre-filled: a pixel no launch writes would show
        out = tuple(torch.full(shape, 255, dtype=torch.uint8, device=card)
                    for _ in range(2))
        got = fn(Zd, out=out, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


def _nan_raster(shape, seed):
    Z = np.random.default_rng(seed).normal(size=shape).cumsum(0).cumsum(1)
    Z = Z.astype(np.float32)
    Z[shape[0] // 2, shape[1] // 2] = np.nan
    return Z


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lookup,fast", CARD_CASES)
def test_k3_tile_path_matches_plain_on_card(card, shape, lookup, fast):
    """K3, both entries (the origin entry on the raster's centre block of a
    3x3 cut), into outputs pre-filled with NaN, which no kernel writes:
    equal to the plain version by value."""
    Z = _nan_raster(shape, 10)
    Zd = torch.from_numpy(Z).to(card)
    H, W = shape
    block = torch.from_numpy(np.ascontiguousarray(
        np.pad(Z, lookup, constant_values=np.nan)[
            H // 3:2 * H // 3 + 2 * lookup,
            W // 3:2 * W // 3 + 2 * lookup])).to(card)
    cases = [(Zd, {}), (block, dict(origin=(H // 3 - lookup,
                                            W // 3 - lookup),
                                    global_shape=shape))]
    for Z_, extra in cases:
        kw = dict(cellsize=2.0, lookup_pixels=lookup, fast=fast, **extra)
        plain = cs.directional_extrema_torch(Z_, **kw)
        out = tuple(torch.full((8, *Z_.shape), float("nan"), device=card)
                    for _ in range(2))
        got = cs.directional_extrema_cuda(Z_, out=out, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lookup,fast", CARD_CASES)
def test_k4_tile_path_matches_plain_on_card(card, shape, lookup, fast):
    """K4 on every block of a 2x2 cut of the raster, into outputs
    pre-filled with 255: equal to the plain version."""
    from neilpy_tpu_torch.dist.halo import _shard, halo_exchange_2d
    Z = _nan_raster(shape, 11)
    H, W = (shape[0] // 2) * 2, (shape[1] // 2) * 2
    Zd = torch.from_numpy(np.ascontiguousarray(Z[:H, :W])).to(card)
    grid = np.empty((2, 2), dtype=object)
    grid[:] = card
    blocks = halo_exchange_2d(_shard(Zd, grid), lookup, "nan")
    kw = dict(cellsize=2.0, threshold_angle=1.0, fast=fast)
    for y, row in enumerate(blocks):
        for x, block in enumerate(row):
            args = (block, (y * H // 2, x * W // 2), (H, W), lookup)
            plain = cs.openness_counts_block_torch(*args, **kw)
            out = tuple(torch.full(plain[0].shape, 255, dtype=torch.uint8,
                                   device=card) for _ in range(2))
            got = cs.openness_counts_block_cuda(*args, out=out, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("shape,lookup,fast", CARD_CASES)
def test_reduced_tile_path_matches_plain_on_card(card, shape, lookup, fast,
                                                 plan):
    """K2 (``plan`` False) or K5/reduced, every mode variant, into outputs
    pre-filled with a value no launch writes (NaN for the sums, 0xFFFF for
    the codes): equal to the other kernel, whose tiles and routes differ,
    bit for bit; the codes equal the plain version, openness within 5e-5
    degrees (+inf at the same pixels) and skyview within 1e-6 of it."""
    Z = _nan_raster(shape, 12)
    Zd = torch.from_numpy(Z).to(card)
    fns = (cs.openness_reduced_cuda, cs.openness_reduced_plan_cuda)
    if plan:
        fns = fns[::-1]
    for mode, extra in REDUCED_VARIANTS.values():
        kw = dict(cellsize=2.0, lookup_pixels=lookup, fast=fast, **extra)
        plain = cs.openness_reduced_torch(Zd, mode, **kw)
        got = []
        for fn in fns:
            if mode == "ternary":
                out = (torch.full(shape, 0xFFFF, dtype=torch.int32,
                                  device=card).to(torch.uint16),)
            else:
                out = tuple(torch.full(shape, float("nan"), device=card)
                            for _ in range(len(plain)))
            got.append(fn(Zd, mode, out=out, **kw))
            torch.cuda.synchronize()
        for a, b in zip(*got):
            if mode == "ternary":
                assert torch.equal(a.int(), b.int())
            else:
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(got[0], plain):
            if mode == "ternary":
                assert torch.equal(a.int(), b.int())
                continue
            if mode == "openness":
                a, b = a * cs._DEG_PER_SUM, b * cs._DEG_PER_SUM
            assert not a.isnan().any()
            inf = a.isinf()
            assert torch.equal(inf, b.isinf())
            tol = 5e-5 if mode == "openness" else 1e-6
            assert float((a[~inf] - b[~inf]).abs().max()) <= tol
