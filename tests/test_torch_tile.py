"""The tile path of K1 and K5/counts (``csrc/ladder_tile.cuh``) on the
CPU: its host mirror ``cuda_scan.tile_route`` held against brute force in
numpy.

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
- the tile switches change neither the route table nor a CPU output.

The kernels themselves run on the card only: the ``cuda`` test skips here
and ``chip_smoke.py`` holds both kernels, tile path on and off, against
the plain version.
"""

import numpy as np
import pytest
import torch

from neilpy_tpu_torch.core.shift import OFFSETS
from neilpy_tpu_torch.ops import cuda_scan as cs

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


def test_tile_switches_change_no_route_or_output():
    """The tile switch and the route mask reach only the kernels' tile
    arguments: the route table (the per-thread blocks' routing), the CPU
    outputs and the 98.9% maskless share at 8192^2 stay as they were."""
    Z = torch.from_numpy(np.random.default_rng(5).normal(size=(257, 389))
                         .cumsum(0).cumsum(1).astype(np.float32))
    kw = dict(cellsize=2.0, lookup_pixels=12, threshold_angle=1.0)
    saved = cs._ALLOW_TILE
    try:
        outs = []
        for on in (True, False):
            cs._ALLOW_TILE = on
            outs.append((cs.route_table(Z, 12, specialize=True),
                         cs.route_table(Z, 12, specialize=False),
                         *cs.openness_counts(Z, **kw)))
            args = cs._tile_args(Z, 12, 12, True)
            assert (args[0] == 16 and args[5] == 0) if on else not any(args)
    finally:
        cs._ALLOW_TILE = saved
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    big = torch.empty((8192, 8192), dtype=torch.float32)
    share = float(cs.route_table(big, 50, specialize=True).float().mean())
    assert abs(share - 0.989) < 5e-4
    saved = cs._ALLOW_MASKLESS
    try:
        cs._ALLOW_MASKLESS = 0
        assert not any(cs._tile_args(Z, 12, 12, True))
    finally:
        cs._ALLOW_MASKLESS = saved


def test_tile_load_rule():
    """TMA where the row pitch is a multiple of 16 bytes and the base is
    16-byte aligned, cp.async otherwise."""
    assert cs._tile_load(torch.zeros((64, 900))) == 1
    assert cs._tile_load(torch.zeros((64, 1537))) == 0
    assert cs._tile_load(torch.zeros((64, 901))[:, 1:].contiguous()) == 1
    assert cs._tile_load(torch.zeros(64 * 900 + 1)[1:].view(64, 900)) == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lookup,fast", [
    ((600, 900), 12, False), ((515, 771), 50, True), ((1000, 1537), 50,
                                                      False)])
def test_tile_path_matches_plain_on_card(card, shape, lookup, fast):
    Z = np.random.default_rng(9).normal(size=shape).cumsum(0).cumsum(1)
    Z = Z.astype(np.float32)
    Z[shape[0] // 2, shape[1] // 2] = np.nan
    Zd = torch.from_numpy(Z).to(card)
    kw = dict(cellsize=2.0, lookup_pixels=lookup, threshold_angle=1.0,
              fast=fast)
    plain = cs.openness_counts_torch(Zd, **kw)
    saved = cs._ALLOW_TILE
    try:
        for on in (True, False):
            cs._ALLOW_TILE = on
            for fn in (cs.openness_counts_cuda, cs.openness_counts_plan_cuda):
                # pre-filled: a pixel no launch writes would show
                out = tuple(torch.full(shape, 255, dtype=torch.uint8,
                                       device=card) for _ in range(2))
                got = fn(Zd, out=out, **kw)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, plain))
    finally:
        cs._ALLOW_TILE = saved
