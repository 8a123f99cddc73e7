"""The openness ladder's hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of ``neilpy_tpu/ops/pallas_scan.py``.  Every kernel runs the
same scan ladder (``csrc/ladder.cuh``; plain version
``_ladder_extrema``): for every pixel and each of the 8 directions, the
running max ``mx`` and min ``mn`` over the ladder of the slope ratio
``(Z[p + d*L] - Z[p]) * scale[d, L]`` (NaN reads and reads off the raster
are skipped); an out-of-range last step clamps ``mx >= 0`` and
``mn <= 0``.  What each kernel makes of the extrema:

- ``openness_counts`` (K1, ``csrc/openness_counts.cu``, replaces
  ``_counts_kernel``): per direction a vote ``num_pos`` / ``num_neg``,
  comparing the openness difference ``atan(-mn) - atan(mx)`` with the
  threshold exactly in tangent space;
- ``directional_extrema`` (K3, ``csrc/directional_extrema.cu``, replaces
  ``_extrema_kernel``): the (8, H, W) ``mx`` and ``mn`` planes;
- ``openness_reduced`` (K2, ``csrc/openness_reduced.cu``, replaces
  ``_reduced_kernel``): the directions folded in order d = 0..7 into the
  openness sums, the skyview sum, or the base-3 ternary code;
- ``openness_counts_block`` (K4, ``csrc/openness_counts_block.cu``,
  replaces ``_counts_kernel`` as ``openness_counts_pallas_block`` launches
  it): K1's counts for the core of one shard block that carries an R-wide
  halo, with the epilogue decided in global coordinates;
- ``openness_counts_plan_cuda`` / ``openness_reduced_plan_cuda`` (K5,
  ``csrc/openness_counts_plan.cu`` and ``csrc/openness_reduced_plan.cu``,
  replace the static 9-patch plan ``_region_calls``): K1's and K2's
  outputs with each boundary region's unsafe directions fixed at compile
  time.

Two ladder bodies (``ladder.cuh``): the masked one, valid everywhere, and
a maskless one for a (thread block, direction) pair whose every read is
real terrain on the raster.  Which pair takes which is decided per 32x8
thread block (``BLOCK``): dynamically from the block's position
(``dynamic_safe``, the counterpart of ``_dir_is_safe``; K1-K4), or by the
static region plan (``region_plan``, ``_axis_segments``; K5).  Both
bodies skip a NaN read (the maskless one keeps its extrema with
``fmaxf`` / ``fminf``, which return the non-NaN operand), so nodata holes
need no routing of their own: the JAX package's per-tile NaN grid exists
because its maskless maximum propagates NaN.  ``specialize`` picks the
route as in the JAX package (``_resolve_specialize``): ``None`` is the
static plan for the exact ladder and the dynamic route for ``fast``.  The
plain versions run the same choice on any device when given ``route``,
with ``torch.fmax`` / ``torch.fmin`` on the maskless pairs and +inf read
off the array there, so a pair wrongly marked safe shows on the CPU.

Every kernel runs its all-safe interior on a third body, the tile kernel
of ``csrc/ladder_tile.cuh``: a thread block owns ``TILE`` output pixels,
copies them with their Rmax halo into shared memory once (TMA, or
cp.async where TMA cannot address the array) and runs the maskless step
from there, 8 pixels per thread, writing counts (K1, K4, K5/counts),
planes (K3) or K2's fold (K2, K5/reduced: the directions folded into
register accumulators).  :func:`tile_route` is the host's model of which
tiles take it (a rectangle of whole tiles, maskless in every direction
over its whole window, for a shard block also inside the global raster,
and a window that fits in shared memory); every other 32x8 block runs the
per-thread bodies as before.  The outputs do not change.

A shard block (K4, and K3 given ``origin``) separates two limits: the
ladder ends at the edge of the block in memory, and the epilogue tests
the last step against the edge of the GLOBAL raster, from the block's
``origin`` and ``global_shape`` (``dist/api.py``).

All versions round exactly like the Pallas kernels: the ratio is a
subtract and a multiply by ``scale[d, k] = f32(1/(cellsize*w_d)) /
f32(L_k)``, a host table they share (``_ladder_scales``), and no
multiply-add is fused.  So extrema, counts and ternary codes are equal
between kernel and plain version on the card (extrema by value: the
maskless body may give +0 for -0), and equal to the Pallas kernels
(interpret mode) on the CPU.  Openness calls ``atanf`` / ``torch.atan``
where the TPU kernel has its own polynomial, so it agrees within a
tolerance (PERF.md).

Each dispatcher (``openness_counts``, ``directional_extrema``,
``openness_reduced``, ``openness_counts_block``) picks by the tensor's
device: a kernel for a CUDA tensor, the plain version for a CPU tensor.
Nothing falls back: a kernel that does not build or launch raises.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..core.codes import progressive_window
from ..core.shift import OFFSETS, STEP_LENGTH

__all__ = ["openness_counts", "openness_counts_torch",
           "openness_counts_cuda", "openness_counts_plan_cuda",
           "geomorphons_cuda",
           "openness_counts_block", "openness_counts_block_torch",
           "openness_counts_block_cuda",
           "directional_extrema", "directional_extrema_torch",
           "directional_extrema_cuda",
           "openness_reduced", "openness_reduced_torch",
           "openness_reduced_cuda", "openness_reduced_plan_cuda",
           "openness_cuda", "skyview_cuda",
           "ternary_cuda", "openness_degrees", "skyview_from_sum",
           "BLOCK", "region_plan", "dynamic_safe", "plan_safe",
           "route_table", "TILE", "TileRoute", "tile_route"]

# K2's modes, as the C entry numbers them
_MODES = {"openness": 0, "svf": 1, "ternary": 2}
_HALF_PI = float(np.float32(np.pi / 2))
# the Pallas wrappers' final scale (pallas_scan.py:1087)
_DEG_PER_SUM = float(np.float32(180.0 / np.pi / 8.0))


def _ladder(R, fast=False, how_fast=20):
    """The scan distances: dense ``1..R``, or the reference's progressive
    window (neilpy.py:1314-1321) for ``fast``.  Its last entry ``Rmax``
    can be less than ``R`` (R=7 at 20% gives 1..6)."""
    if R < 1:
        raise ValueError(f"lookup_pixels must be >= 1, got {R}")
    if fast:
        return tuple(int(v) for v in progressive_window(1, R, how_fast))
    return tuple(range(1, R + 1))


def _ladder_scales(cellsize, ladder):
    """(8, K) float32 table ``f32(1/(cellsize*w_d)) / f32(L_k)``: the
    Pallas kernel's ratio weight (pallas_scan.py:166,173), divided once
    on the host in f32 so neither the kernels nor the plain versions
    divide on the device."""
    inv_w = np.array([1.0 / (float(cellsize) * STEP_LENGTH[d])
                      for d in range(8)], dtype=np.float32)
    return inv_w[:, None] / np.asarray(ladder, dtype=np.float32)[None, :]


@functools.lru_cache(maxsize=64)
def _device_tables(cellsize, ladder, device):
    """The kernels' ladder (int32) and scale table on ``device``, kept so
    that repeated calls make no blocking host-to-device copy.  Read-only:
    the kernels never write them."""
    return (torch.tensor(ladder, dtype=torch.int32, device=device),
            torch.from_numpy(_ladder_scales(cellsize, ladder)).to(device))


def _threshold_tangent(threshold_angle):
    return float(np.float32(math.tan(math.radians(float(threshold_angle)))))


def _check_raster(Z):
    if not isinstance(Z, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(Z).__name__}")
    if Z.dim() != 2:
        raise ValueError(f"expected a 2-D raster, got shape {tuple(Z.shape)}")
    if Z.dtype != torch.float32:
        raise TypeError(f"expected float32, got {Z.dtype}")


def _check_mode(mode):
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")


# ----------------------------------------------------------------------
# routing: which (thread block, direction) pairs take the maskless ladder
# ----------------------------------------------------------------------
# (rows, cols) of one thread block: ladder.cuh's kBlockY x kBlockX
BLOCK = (8, 32)
# the kernels' route mask ``allow``: bit d lets direction d take the
# maskless ladder where it is safe.  0 runs the masked ladder everywhere,
# as the kernels did before the maskless ladder (chip_smoke.py's timing
# baseline); the outputs do not change.
_ALLOW_MASKLESS = 0xFF
# the tile path of every kernel, K1-K5 (csrc/ladder_tile.cuh): off sends
# every block to the per-thread bodies, the kernels as they were before it
# (chip_smoke.py's same-call baseline); the outputs do not change
_ALLOW_TILE = True
# (rows, cols) of the tile kernel's core: 4 x 2 thread blocks
TILE = (32, 64)
# the tile kernel's halo buckets (its window pitch is TILE[1] + 2 * halo),
# multiples of 16 floats for TMA's sake (csrc/ladder_tile.cuh), and the
# most dynamic shared memory one thread block may use on an H100
_TILE_HALOS = (16, 32, 48, 64, 96)
SMEM_CAP = 232448


def _resolve_specialize(specialize, interpret, fast):
    """Resolve ``specialize=None`` as the JAX package does
    (pallas_scan.py:_resolve_specialize): the static region plan for a
    compiled exact ladder, the dynamic route in interpret mode and for the
    ``fast`` ladder; an explicit value passes through.  The kernels are
    always compiled (``interpret=False``); a CPU tensor runs the plain
    version, which no route changes."""
    if specialize is None:
        return (not interpret) and not fast
    return bool(specialize)


def _axis_segments(P, T, Rmax, N, align):
    """Partition one padded axis [0, P) into a low strip, interior tiles
    and a high strip: ``[(px_off, n_tiles, tile_px, (lo, mid, hi)), ...]``
    with every offset and extent a multiple of ``align`` (a copy of
    pallas_scan.py:_axis_segments).  Flags: ``lo`` reads toward negative
    leave the data; ``mid`` the core overhangs the real extent ``N``,
    which unsafes every direction; ``hi`` reads toward positive leave the
    data.  An axis too short for a safe interior is one all-masked
    segment."""
    strip = -(-Rmax // align) * align
    BB = (N - Rmax) // align * align  # last aligned hi-safe region end
    if BB < strip or strip >= P:
        return [(0, 1, P, (True, P > N, True))]
    segs = [(0, 1, strip, (True, False, False))]
    M = BB - strip
    k = M // T
    rem = M - k * T
    if k > 0:
        segs.append((strip, k, T, (False, False, False)))
    if rem > 0:
        segs.append((strip + k * T, 1, rem, (False, False, False)))
    segs.append((BB, 1, P - BB, (False, P > N, True)))
    return segs


def _axis_bad(dd, flags):
    """Is a direction with per-axis step ``dd`` unsafe for a segment with
    ``_axis_segments`` flags?  (A copy of pallas_scan.py:_axis_bad.)"""
    lo, mid, hi = flags
    if dd < 0:
        return lo or mid
    if dd > 0:
        return hi
    return mid


def _grid(H, W):
    """(rows, cols) of thread blocks over an (H, W) raster."""
    return -(-int(H) // BLOCK[0]), -(-int(W) // BLOCK[1])


def _plan_axis(N, Rmax, axis):
    """(lo_end, hi_start, masks) of one axis: blocks starting before
    ``lo_end`` are the low strip, from ``hi_start`` on the high strip;
    ``masks`` packs the unsafe directions of the low strip, the interior
    and the high strip, one byte each.  An axis too short for a safe
    interior is all masked in every direction (the JAX plan may leave the
    two directions along it maskless there; the port instantiates only
    the 9 regions and the all-masked body)."""
    align = BLOCK[axis]
    P = -(-N // align) * align
    segs = _axis_segments(P, align, Rmax, N, align)
    if len(segs) == 1:
        return 0, 0, 0xFF << 16
    # the interior's flags are all False: its mask is 0
    lo, hi = (sum(1 << d for d in range(8)
                  if _axis_bad(OFFSETS[d][axis], seg[3]))
              for seg in (segs[0], segs[-1]))
    return segs[0][1] * segs[0][2], segs[-1][0], lo | hi << 16


@functools.lru_cache(maxsize=64)
def region_plan(H, W, Rmax):
    """K5's static plan for an (H, W) raster at ladder reach ``Rmax``:
    ``(rlo, rhi, rmasks, clo, chi, cmasks)`` as ``_plan_axis`` gives them
    per axis (the counterpart of ``_region_calls``' ``_axis_segments`` at
    the thread block's alignment).  A block's unsafe set is the union of
    its row and column segments' sets: one of 9 regions, or all eight."""
    return (*_plan_axis(int(H), int(Rmax), 0),
            *_plan_axis(int(W), int(Rmax), 1))


def plan_safe(H, W, Rmax):
    """(8, nby, nbx) numpy bool: direction d is maskless for thread block
    (by, bx) under ``region_plan``."""
    rlo, rhi, rm, clo, chi, cm = region_plan(H, W, Rmax)
    nby, nbx = _grid(H, W)

    def seg_masks(n, step, lo, hi, masks):
        start = np.arange(n) * step
        seg = np.where(start < lo, 0, np.where(start < hi, 1, 2))
        return (masks >> (8 * seg)) & 0xFF

    unsafe = (seg_masks(nby, BLOCK[0], rlo, rhi, rm)[:, None]
              | seg_masks(nbx, BLOCK[1], clo, chi, cm)[None, :])
    return np.stack([(unsafe >> d) & 1 == 0 for d in range(8)])


def dynamic_safe(shape, Rmax, grid=None, grid0=(0, 0), origin=None,
                 global_shape=None):
    """(8, nby, nbx) numpy bool: direction d is maskless for thread block
    (by, bx) on the dynamic route, as
    ``ladder.cuh:safe_directions``: the block's whole read window, shifted
    by d*1 .. d*Rmax, lies on the ``shape`` array and, given the array's
    ``origin`` (global row, col of its pixel (0, 0)), inside the
    ``global_shape`` raster (pallas_scan.py:_dir_is_safe).  The grid of
    ``grid`` blocks starts at array pixel ``grid0`` (K4: the core, at
    (R, R))."""
    H, W = map(int, shape)
    nby, nbx = _grid(H, W) if grid is None else grid
    r0 = int(grid0[0]) + BLOCK[0] * np.arange(nby)[:, None]
    c0 = int(grid0[1]) + BLOCK[1] * np.arange(nbx)[None, :]

    def on(r, c, dr, dc, h, w):
        return ((r + min(dr, 0) >= 0) & (r + BLOCK[0] + max(dr, 0) <= h)
                & (c + min(dc, 0) >= 0) & (c + BLOCK[1] + max(dc, 0) <= w))

    out = np.empty((8, nby, nbx), dtype=bool)
    for d, (dr, dc) in enumerate(OFFSETS):
        ok = on(r0, c0, dr * Rmax, dc * Rmax, H, W)
        if origin is not None:
            gh, gw = (H, W) if global_shape is None else global_shape
            ok = ok & on(r0 + int(origin[0]), c0 + int(origin[1]),
                         dr * Rmax, dc * Rmax, int(gh), int(gw))
        out[d] = ok
    return out


def route_table(Z, lookup_pixels, fast=False, how_fast=20, specialize=False,
                origin=None, global_shape=None, core=0):
    """(8, nby, nbx) bool tensor on Z's device: the (thread block,
    direction) pairs that take the maskless ladder, as the kernels route
    them.  ``specialize`` True: K5's region plan (whole raster only);
    False: the dynamic predicate.  ``core``: the halo width of a shard
    block whose grid covers its core only (K4: R, with ``origin`` the
    core's global origin); ``origin`` otherwise the global position of
    ``Z[0, 0]`` (K3's origin entry).  NaN cells change nothing: both
    bodies skip a NaN read."""
    Rmax = _ladder(int(lookup_pixels), fast, how_fast)[-1]
    H, W = Z.shape
    grid = _grid(H - 2 * core, W - 2 * core)
    if specialize:
        if origin is not None or core:
            raise ValueError("the static region plan serves whole rasters "
                             "only, as the JAX package's")
        safe = plan_safe(H, W, Rmax)
    else:
        org = None
        if origin is not None or global_shape is not None:
            o = (0, 0) if origin is None else origin
            org = (int(o[0]) - core, int(o[1]) - core)
        safe = dynamic_safe((H, W), Rmax, grid, (core, core), org,
                            global_shape)
    return torch.from_numpy(safe).to(Z.device)


class TileRoute(NamedTuple):
    """Where a kernel runs the tile body (:func:`tile_route`): ``halo`` the
    bucket (0: no tile), ``rows`` = (ty0, ty1) and ``cols`` = (tx0, tx1)
    the rectangle of tiles of ``TILE`` pixels on the kernel's grid,
    ``smem_bytes`` the dynamic shared memory of one tile CTA."""

    halo: int
    rows: tuple
    cols: tuple
    smem_bytes: int

    @property
    def n_tiles(self):
        return ((self.rows[1] - self.rows[0])
                * (self.cols[1] - self.cols[0]))

    def pixels(self, H, W):
        """(H, W) numpy bool over the grid (K4: the core): the pixels the
        tile kernel computes."""
        out = np.zeros((int(H), int(W)), dtype=bool)
        th, tw = TILE
        out[self.rows[0] * th:self.rows[1] * th,
            self.cols[0] * tw:self.cols[1] * tw] = True
        return out


_NO_TILE = TileRoute(0, (0, 0), (0, 0), 0)


def _tile_smem_bytes(halo, Rmax, K):
    """``ladder_tile.cuh:tile_smem_bytes``: 128 bytes to align the window,
    the window of (TILE[0] + 2 Rmax) rows of TILE[1] + 2 halo floats, the
    (8, K) step table of 8-byte entries and the mbarrier."""
    return 128 + 4 * (TILE[0] + 2 * Rmax) * (TILE[1] + 2 * halo) + 64 * K + 8


def _tile_span(n, Rmax, g0, org, gn, extent, size):
    """[lo, hi) of the tiles of ``size`` pixels along one axis whose whole
    window, the tile's pixels +- Rmax, lies on the array of ``n`` and, for
    a grid pixel at array ``g0 + i`` and global ``org + g0 + i``, inside
    the raster of ``gn``, and which lie in the grid's ``extent``."""
    lo = max(Rmax - g0, Rmax - g0 - org, 0)
    hi = min(n - g0 - Rmax, gn - org - g0 - Rmax, extent)
    return -(-lo // size), hi // size


@functools.lru_cache(maxsize=64)
def tile_route(H, W, Rmax, specialize, K=None, grid0=(0, 0), core=None,
               origin=None, global_shape=None):
    """The tiles of TILE pixels that take the tile body on an (H, W) array
    at ladder reach ``Rmax`` with ``K`` ladder entries (default ``Rmax``,
    the dense ladder): a :class:`TileRoute`, the numpy model of the
    rectangle the kernels are launched with.

    A tile takes it only where every direction is maskless over its whole
    window, and the window fits in shared memory.  ``specialize`` True
    (K5, both): the tile lies wholly in the plan's interior region
    (``region_plan``, whole rasters only), whose blocks are safe in every
    direction.  False (K1-K4): the core shifted by d*1 .. d*Rmax lies
    on the array in all 8 directions (``window_on``, what
    ``dynamic_safe`` tests per 32x8 block); for a shard block, with the
    geometry ``dynamic_safe`` takes, also inside the raster.  The grid of
    tiles starts at array pixel ``grid0`` and spans ``core`` pixels
    (default: the rest of the array): K4's is its core, ``grid0`` (R, R)
    and ``core`` (bh, bw); ``origin`` is the global (row, col) of the
    array's pixel (0, 0) and ``global_shape`` the raster's (default: the
    array's), as K3's origin entry takes them.  The halo is the smallest
    bucket >= Rmax plus the window's column shift ``grid0[1] % 16``
    (``ladder_tile.cuh:tile_shift``, 0 on a whole raster); a reach above
    the largest, or a window above ``SMEM_CAP`` bytes (exact lookup 95 and
    up), gets no tile."""
    H, W, Rmax = int(H), int(W), int(Rmax)
    K = Rmax if K is None else int(K)
    g0r, g0c = map(int, grid0)
    halo = next((h for h in _TILE_HALOS if h >= Rmax + g0c % 16), 0)
    if not halo or _tile_smem_bytes(halo, Rmax, K) > SMEM_CAP:
        return _NO_TILE
    th, tw = TILE
    if specialize:
        if (g0r, g0c) != (0, 0) or core is not None or origin is not None:
            raise ValueError("the static region plan serves whole rasters "
                             "only")
        rlo, rhi, _, clo, chi, _ = region_plan(H, W, Rmax)
        rows = (-(-rlo // th), rhi // th)
        cols = (-(-clo // tw), chi // tw)
    else:
        gh, gw = (H - g0r, W - g0c) if core is None else map(int, core)
        org_r, org_c = (0, 0) if origin is None else map(int, origin)
        GH, GW = (H, W) if global_shape is None else map(int, global_shape)
        rows = _tile_span(H, Rmax, g0r, org_r, GH, gh, th)
        cols = _tile_span(W, Rmax, g0c, org_c, GW, gw, tw)
    if rows[1] <= rows[0] or cols[1] <= cols[0]:
        return _NO_TILE
    return TileRoute(halo, rows, cols, _tile_smem_bytes(halo, Rmax, K))


def _tile_load(Z):
    """The tile kernel's load path: TMA (1) where TMA can address the
    array, a row pitch that is a multiple of 16 bytes (W % 4 == 0) and a
    16-byte aligned base; cp.async (0) otherwise."""
    return int(Z.shape[1] % 4 == 0 and Z.data_ptr() % 16 == 0)


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------
def _block_pixels(table, grid0, shape):
    """(H, W) bool: ``table`` (nby, nbx), one value per thread block of a
    grid starting at array pixel ``grid0``, spread over the block's
    pixels; False off the grid."""
    by, bx = BLOCK
    r0, c0 = map(int, grid0)
    H, W = shape
    px = table.repeat_interleave(by, 0).repeat_interleave(bx, 1)
    out = torch.zeros((H, W), dtype=torch.bool, device=table.device)
    out[r0:r0 + px.shape[0], c0:c0 + px.shape[1]] = px[:H - r0, :W - c0]
    return out


def _ladder_extrema(Z, cellsize, lookup_pixels, fast, how_fast, origin=None,
                    global_shape=None, safe=None, grid0=(0, 0)):
    """Yield ``(d, mx, mn)`` for d = 0..7: the ladder of every plain
    version, in plain PyTorch ops on any device.  Follows the Pallas
    formulation step for step: NaN pad, one shifted slice per (d, L),
    compare-select extrema (NaN never enters; ``torch.maximum`` would
    propagate it), the out-of-range epilogue at ``Rmax``.

    ``origin`` (global row, col of ``Z[0, 0]``) and ``global_shape`` put
    the epilogue in global coordinates for a shard block, as the XLA
    function does (neilpy_tpu/ops/visibility.py:140-144); reads still end
    at the block's own edge (the NaN pad).

    ``safe`` (an (8, nby, nbx) bool table from :func:`route_table`, for a
    grid of thread blocks starting at array pixel ``grid0``) routes as the
    kernels do: where it is set, direction d takes the maskless body
    instead, ``torch.fmax`` / ``torch.fmin`` (NaN skipped, as the
    kernels' ``fmaxf`` / ``fminf``) with no epilogue, reading +inf off the
    array, so a pair wrongly marked safe shows as a changed extremum."""
    H, W = Z.shape
    R = int(lookup_pixels)
    ladder = _ladder(R, fast, how_fast)
    Rmax = ladder[-1]
    # python floats holding f32 values: a tensor-scalar op computes in f32
    scales = _ladder_scales(cellsize, ladder).tolist()
    Zp = torch.nn.functional.pad(Z, (R, R, R, R), value=float("nan"))
    if safe is not None:
        Zs = torch.nn.functional.pad(Z, (R, R, R, R), value=math.inf)
    rows = torch.arange(H, device=Z.device)[:, None]
    cols = torch.arange(W, device=Z.device)[None, :]
    if origin is not None:
        rows = rows + int(origin[0])
        cols = cols + int(origin[1])
    GH, GW = (H, W) if global_shape is None else map(int, global_shape)
    for d, (dr, dc) in enumerate(OFFSETS):
        routed = safe is not None and bool(safe[d].any())
        mx = torch.full((H, W), -math.inf, device=Z.device)
        mn = torch.full((H, W), math.inf, device=Z.device)
        smx, smn = mx, mn
        for k, L in enumerate(ladder):
            src = Zp[R + dr * L:R + dr * L + H, R + dc * L:R + dc * L + W]
            ratio = (src - Z) * scales[d][k]
            mx = torch.where(ratio > mx, ratio, mx)
            mn = torch.where(ratio < mn, ratio, mn)
            if routed:
                sratio = (Zs[R + dr * L:R + dr * L + H,
                             R + dc * L:R + dc * L + W] - Z) * scales[d][k]
                smx = torch.fmax(smx, sratio)
                smn = torch.fmin(smn, sratio)
        sr = rows + dr * Rmax
        sc = cols + dc * Rmax
        oob = (sr < 0) | (sr >= GH) | (sc < 0) | (sc >= GW)
        mx = torch.where(oob, mx.clamp(min=0.0), mx)
        mn = torch.where(oob, mn.clamp(max=0.0), mn)
        if routed:
            on = _block_pixels(safe[d], grid0, (H, W))
            mx = torch.where(on, smx, mx)
            mn = torch.where(on, smn, mn)
        yield d, mx, mn


def _route(Z, lookup_pixels, fast, how_fast, route, origin=None,
           global_shape=None, core=0):
    """The ``safe`` table of :func:`_ladder_extrema` for ``route``: None
    (the masked body everywhere), ``'dynamic'`` or ``'static'``."""
    if route is None:
        return None
    if route not in ("dynamic", "static"):
        raise ValueError(f"route must be None, 'dynamic' or 'static', got "
                         f"{route!r}")
    return route_table(Z, lookup_pixels, fast, how_fast,
                       route == "static", origin, global_shape, core)


def _classify(mx, mn, T):
    """(gt, lt): the openness difference ``atan(-mn) - atan(mx)`` above
    +t / below -t, compared exactly in tangent space (``T = tan t``,
    pallas_scan.py:449-475); an unseen direction votes neither way."""
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


def _votes(extrema, threshold_angle, shape, device, core=(slice(None),)):
    """(num_pos, num_neg) uint8: the directions of ``extrema`` (from
    :func:`_ladder_extrema`) voting at the pixels ``core`` selects."""
    T = _threshold_tangent(threshold_angle)
    num_pos = torch.zeros(shape, dtype=torch.uint8, device=device)
    num_neg = torch.zeros(shape, dtype=torch.uint8, device=device)
    for _, mx, mn in extrema:
        gt, lt = _classify(mx[core], mn[core], T)
        num_pos += gt
        num_neg += lt
    return num_pos, num_neg


def openness_counts_torch(Z, cellsize=1.0, lookup_pixels=1,
                          threshold_angle=1.0, fast=False, how_fast=20,
                          route=None):
    """(num_pos, num_neg) uint8 counts in plain PyTorch ops, on any
    device: the reference K1 and K5 are held against on the card, and the
    CPU path.  ``route`` ``'dynamic'`` (K1's) or ``'static'`` (K5's plan)
    routes the ladder per (thread block, direction) as that kernel does
    (:func:`_ladder_extrema`); the counts do not change."""
    _check_raster(Z)
    safe = _route(Z, lookup_pixels, fast, how_fast, route)
    return _votes(_ladder_extrema(Z, cellsize, lookup_pixels, fast,
                                  how_fast, safe=safe),
                  threshold_angle, Z.shape, Z.device)


def _block_core(block, lookup_pixels):
    """(R, bh, bw): the halo width and core shape of a block that carries
    an R-wide halo, R = ``lookup_pixels`` (as
    ``openness_counts_pallas_block``)."""
    R = int(lookup_pixels)
    bh, bw = block.shape[0] - 2 * R, block.shape[1] - 2 * R
    if bh < 0 or bw < 0:
        raise ValueError(f"block {tuple(block.shape)} cannot carry a halo of "
                         f"lookup_pixels={lookup_pixels} on each side")
    return R, bh, bw


def openness_counts_block_torch(block_haloed, origin, global_shape,
                                lookup_pixels, cellsize=1.0,
                                threshold_angle=1.0, fast=False, how_fast=20,
                                route=None):
    """K4's counts in plain PyTorch ops, on any device: the reference K4 is
    held against on the card, and the CPU path.  ``block_haloed`` is one
    shard block with an R-wide halo of its neighbours' data (NaN beyond
    the raster), R = ``lookup_pixels``; ``origin`` the global (row, col)
    of its core; ``global_shape`` the raster's.  Returns core-shaped
    (num_pos, num_neg) uint8, equal to the single-device counts there.
    ``route='dynamic'`` routes as K4 does."""
    _check_raster(block_haloed)
    R, bh, bw = _block_core(block_haloed, lookup_pixels)
    safe = _route(block_haloed, R, fast, how_fast, route, origin,
                  global_shape, core=R)
    extrema = _ladder_extrema(
        block_haloed, cellsize, R, fast, how_fast,
        origin=(int(origin[0]) - R, int(origin[1]) - R),
        global_shape=global_shape, safe=safe, grid0=(R, R))
    return _votes(extrema, threshold_angle, (bh, bw), block_haloed.device,
                  core=(slice(R, R + bh), slice(R, R + bw)))


def directional_extrema_torch(Z, cellsize=1.0, lookup_pixels=1, fast=False,
                              how_fast=20, origin=None, global_shape=None,
                              route=None):
    """(mx, mn), each (8, H, W) float32, in plain PyTorch ops on any
    device: the reference K3 is held against on the card, and the CPU
    path.  ``origin`` / ``global_shape``: a shard block's global position
    (:func:`_ladder_extrema`); ``route='dynamic'`` routes as K3 does."""
    _check_raster(Z)
    safe = _route(Z, lookup_pixels, fast, how_fast, route, origin,
                  global_shape)
    mx_all = torch.empty((8, *Z.shape), dtype=torch.float32, device=Z.device)
    mn_all = torch.empty_like(mx_all)
    for d, mx, mn in _ladder_extrema(Z, cellsize, lookup_pixels, fast,
                                     how_fast, origin, global_shape, safe):
        mx_all[d] = mx
        mn_all[d] = mn
    return mx_all, mn_all


def openness_reduced_torch(Z, mode, cellsize=1.0, lookup_pixels=1,
                           threshold_angle=0.0, neg_mode=True, fast=False,
                           how_fast=20, route=None):
    """K2's reduction in plain PyTorch ops, on any device: the reference
    K2 and K5 are held against on the card, and the CPU path.  Folds the
    directions in K2's order d = 0..7 and returns a tuple, as
    ``_reduced_call``: ``mode='openness'`` the positive and negative sums
    of ``pi/2 - atan`` in radians (+inf where a direction saw nothing);
    ``'svf'`` the sum of ``t/sqrt(1+t^2)``, ``t = max(mx, 0)``;
    ``'ternary'`` the base-3 code as uint16 (``neg_mode``: O = pos - neg,
    else O = pos - 90; digit 2 above ``threshold_angle``, 0 below its
    negative).  ``route`` as :func:`openness_counts_torch`."""
    _check_mode(mode)
    _check_raster(Z)
    T = _threshold_tangent(threshold_angle)
    safe = _route(Z, lookup_pixels, fast, how_fast, route)
    acc0 = torch.zeros(Z.shape, dtype=torch.float32, device=Z.device)
    acc1 = torch.zeros_like(acc0)
    code = torch.zeros(Z.shape, dtype=torch.int32, device=Z.device)
    for d, mx, mn in _ladder_extrema(Z, cellsize, lookup_pixels, fast,
                                     how_fast, safe=safe):
        seen = mx > -math.inf
        if mode == "openness":
            acc0 = acc0 + torch.where(seen, _HALF_PI - torch.atan(mx),
                                      math.inf)
            acc1 = acc1 + torch.where(seen, _HALF_PI - torch.atan(-mn),
                                      math.inf)
        elif mode == "svf":
            t = mx.clamp(min=0.0)  # also absorbs unseen (-inf)
            acc0 = acc0 + t / torch.sqrt(1.0 + t * t)
        else:
            if neg_mode:
                gt, lt = _classify(mx, mn, T)
            else:
                # O = pos - 90 = -atan(mx) deg: O > t <=> mx < -tan t;
                # unseen -> pos = +inf -> digit 2 (as the XLA path)
                gt = (mx < -T) | ~seen
                lt = seen & (mx > T)
            code += (1 + gt.int() - lt.int()) * 3 ** d
    if mode == "openness":
        return acc0, acc1
    if mode == "svf":
        return (acc0,)
    return (code.to(torch.uint16),)


# ----------------------------------------------------------------------
# CUDA kernels
# ----------------------------------------------------------------------
def _check_cuda(Z, name):
    _check_raster(Z)
    if not Z.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got one on {Z.device};"
                         " use the plain version (engine='torch') on the "
                         "CPU")
    if not Z.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    if Z.shape[0] > 8 * 65535:
        raise ValueError(f"{Z.shape[0]} rows exceed the kernels' grid "
                         "(524280)")


def _tile_args(Z, Rmax, K, plan, **geometry):
    """The tile arguments of the C entries: (halo, ty0, ty1, tx0, tx1, tma)
    for array ``Z`` and a shard block's ``geometry`` (:func:`tile_route`),
    all 0 when the tile path is off (``_ALLOW_TILE``), the route mask
    withholds a direction, or no tile fits."""
    t = (tile_route(*Z.shape, Rmax, plan, K, **geometry)
         if _ALLOW_TILE and _ALLOW_MASKLESS == 0xFF else _NO_TILE)
    if not t.n_tiles:
        return (0,) * 6
    return (t.halo, *t.rows, *t.cols, _tile_load(Z))


def _run_entry(Z, entry, args):
    """Call C entry ``entry`` with ``args`` and the current stream of Z's
    device; raise on a CUDA error.  Does not synchronise."""
    lib = _build.load()
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")


def _launch(Z, entry, cellsize, lookup_pixels, fast, how_fast, *args,
            plan=False, tiles=None):
    """Launch C entry ``entry`` for raster ``Z`` with its ladder tables,
    the dense-ladder flag and the route mask ``_ALLOW_MASKLESS``, then the
    tile arguments unless ``tiles`` is None (:func:`_tile_args` with the
    geometry ``tiles``, ``{}`` for a whole raster), then K5's region plan
    if ``plan``, then ``args``, on Z's device and current stream
    (:func:`_run_entry`)."""
    ladder = _ladder(int(lookup_pixels), fast, how_fast)
    Rmax = ladder[-1]
    ladder_t, scales = _device_tables(float(cellsize), ladder, Z.device)
    dense = ladder == tuple(range(1, len(ladder) + 1))
    H, W = Z.shape
    _run_entry(Z, entry, (
        Z.data_ptr(), H, W, ladder_t.data_ptr(), scales.data_ptr(),
        len(ladder), Rmax, int(dense), _ALLOW_MASKLESS,
        *(() if tiles is None
          else _tile_args(Z, Rmax, len(ladder), plan, **tiles)),
        *(region_plan(H, W, Rmax) if plan else ()), *args))


def _outputs(out, shape, dtype, device, name, n=2):
    """A kernel's ``n`` outputs: ``out`` checked (``n`` contiguous tensors
    of ``dtype`` and ``shape`` on ``device``), or ``n`` new ones."""
    if out is None:
        return tuple(torch.empty(shape, dtype=dtype, device=device)
                     for _ in range(n))
    out = tuple(out)
    if len(out) != n or any(
            t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous() for t in out):
        raise ValueError(f"{name}: out must be {n} contiguous {dtype} "
                         f"tensor{'s' if n > 1 else ''} of shape "
                         f"{tuple(shape)} on {device}")
    return out


def _counts_cuda(Z, name, cellsize, lookup_pixels, threshold_angle, fast,
                 how_fast, plan, out):
    _check_cuda(Z, name)
    num_pos, num_neg = _outputs(out, Z.shape, torch.uint8, Z.device, name)
    if Z.numel() == 0:
        return num_pos, num_neg, False
    _launch(Z, f"{name[:-len('_cuda')]}_launch", cellsize, lookup_pixels,
            fast, how_fast, _threshold_tangent(threshold_angle),
            num_pos.data_ptr(), num_neg.data_ptr(), plan=plan, tiles={})
    return num_pos, num_neg, True


def openness_counts_cuda(Z, cellsize=1.0, lookup_pixels=1,
                         threshold_angle=1.0, fast=False, how_fast=20,
                         out=None):
    """(num_pos, num_neg) uint8 counts from K1 (``csrc/openness_counts.cu``),
    on the dynamic route.  ``Z`` must be a contiguous 2-D float32 CUDA
    tensor; anything else raises.  ``out``: the (num_pos, num_neg) pair to
    write, contiguous uint8 tensors of Z's shape on its device (default:
    new ones).  Launches on the current stream and does not synchronise.
    ``openness_counts_cuda.launches`` counts the launches of this
    process."""
    num_pos, num_neg, launched = _counts_cuda(
        Z, "openness_counts_cuda", cellsize, lookup_pixels, threshold_angle,
        fast, how_fast, plan=False, out=out)
    openness_counts_cuda.launches += launched
    return num_pos, num_neg


openness_counts_cuda.launches = 0


def openness_counts_plan_cuda(Z, cellsize=1.0, lookup_pixels=1,
                              threshold_angle=1.0, fast=False, how_fast=20,
                              out=None):
    """K5 for the counts (``csrc/openness_counts_plan.cu``): K1's counts
    through the static region plan (:func:`region_plan`).  Same input
    rules, ``out``, stream and counter
    (``openness_counts_plan_cuda.launches``) as
    :func:`openness_counts_cuda`."""
    num_pos, num_neg, launched = _counts_cuda(
        Z, "openness_counts_plan_cuda", cellsize, lookup_pixels,
        threshold_angle, fast, how_fast, plan=True, out=out)
    openness_counts_plan_cuda.launches += launched
    return num_pos, num_neg


openness_counts_plan_cuda.launches = 0


def _block_tiles(block_haloed, origin, global_shape, R):
    """K4's tile geometry (:func:`tile_route`) for a block with an R-wide
    halo whose core lies at global ``origin``: the tiles lie on the core's
    grid, at (R, R) of the block, whose pixel (0, 0) lies at ``origin - R``
    of the raster."""
    R = int(R)
    return dict(grid0=(R, R), core=(block_haloed.shape[0] - 2 * R,
                                    block_haloed.shape[1] - 2 * R),
                origin=(int(origin[0]) - R, int(origin[1]) - R),
                global_shape=tuple(map(int, global_shape)))


def openness_counts_block_cuda(block_haloed, origin, global_shape,
                               lookup_pixels, cellsize=1.0,
                               threshold_angle=1.0, fast=False, how_fast=20,
                               out=None):
    """K4 (``csrc/openness_counts_block.cu``, dynamic route, tile path
    inside): the core-shaped counts of :func:`openness_counts_block_torch`.
    ``out``: the (num_pos, num_neg) pair to write, contiguous uint8 tensors
    of the core's shape on the block's device.  Same input rules, stream
    and counter (``openness_counts_block_cuda.launches``) as
    :func:`openness_counts_cuda`."""
    name = "openness_counts_block_cuda"
    _check_cuda(block_haloed, name)
    R, bh, bw = _block_core(block_haloed, lookup_pixels)
    num_pos, num_neg = _outputs(out, (bh, bw), torch.uint8,
                                block_haloed.device, name)
    if num_pos.numel() == 0:
        return num_pos, num_neg
    org = (int(origin[0]), int(origin[1]))
    gshape = (int(global_shape[0]), int(global_shape[1]))
    _launch(block_haloed, "openness_counts_block_launch", cellsize, R, fast,
            how_fast, R, *org, *gshape, _threshold_tangent(threshold_angle),
            num_pos.data_ptr(), num_neg.data_ptr(),
            tiles=_block_tiles(block_haloed, org, gshape, R))
    openness_counts_block_cuda.launches += 1
    return num_pos, num_neg


openness_counts_block_cuda.launches = 0


def directional_extrema_cuda(Z, cellsize=1.0, lookup_pixels=1, fast=False,
                             how_fast=20, origin=None, global_shape=None,
                             out=None):
    """(mx, mn), each (8, H, W) float32, from K3
    (``csrc/directional_extrema.cu``, dynamic route, tile path inside);
    given ``origin`` or ``global_shape``, from its entry for a shard block.
    ``out``: the (mx, mn) pair to write, contiguous float32 tensors of
    shape (8, H, W) on Z's device.  Same input rules, stream and counter
    (``directional_extrema_cuda.launches``, both entries) as
    :func:`openness_counts_cuda`."""
    name = "directional_extrema_cuda"
    _check_cuda(Z, name)
    mx, mn = _outputs(out, (8, *Z.shape), torch.float32, Z.device, name)
    if Z.numel() == 0:
        return mx, mn
    if origin is None and global_shape is None:
        _launch(Z, "directional_extrema_launch", cellsize, lookup_pixels,
                fast, how_fast, mx.data_ptr(), mn.data_ptr(), tiles={})
    else:
        org = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
        gshape = tuple(map(int, Z.shape if global_shape is None
                           else global_shape))
        _launch(Z, "directional_extrema_global_launch", cellsize,
                lookup_pixels, fast, how_fast, *org, *gshape, mx.data_ptr(),
                mn.data_ptr(), tiles=dict(origin=org, global_shape=gshape))
    directional_extrema_cuda.launches += 1
    return mx, mn


directional_extrema_cuda.launches = 0


def _reduced_cuda(Z, name, mode, cellsize, lookup_pixels, threshold_angle,
                  neg_mode, fast, how_fast, plan, out):
    _check_mode(mode)
    _check_cuda(Z, name)
    if mode == "ternary":
        outs = _outputs(out, Z.shape, torch.uint16, Z.device, name, 1)
        ptrs = (None, None, outs[0].data_ptr())
    else:
        outs = _outputs(out, Z.shape, torch.float32, Z.device, name,
                        2 if mode == "openness" else 1)
        ptrs = (outs[0].data_ptr(),
                outs[1].data_ptr() if mode == "openness" else None, None)
    if Z.numel() == 0:
        return outs, False
    _launch(Z, f"{name[:-len('_cuda')]}_launch", cellsize, lookup_pixels,
            fast, how_fast, _MODES[mode], int(bool(neg_mode)),
            _threshold_tangent(threshold_angle), *ptrs, plan=plan, tiles={})
    return outs, True


def openness_reduced_cuda(Z, mode, cellsize=1.0, lookup_pixels=1,
                          threshold_angle=0.0, neg_mode=True, fast=False,
                          how_fast=20, out=None):
    """K2 (``csrc/openness_reduced.cu``, dynamic route, tile path inside):
    the same tuple as :func:`openness_reduced_torch`.  ``out``: the tuple
    to write, contiguous tensors of Z's shape on its device: two float32
    for ``'openness'``, one float32 for ``'svf'``, one uint16 for
    ``'ternary'``.  Same input rules, stream and counter
    (``openness_reduced_cuda.launches``) as :func:`openness_counts_cuda`."""
    outs, launched = _reduced_cuda(
        Z, "openness_reduced_cuda", mode, cellsize, lookup_pixels,
        threshold_angle, neg_mode, fast, how_fast, plan=False, out=out)
    openness_reduced_cuda.launches += launched
    return outs


openness_reduced_cuda.launches = 0


def openness_reduced_plan_cuda(Z, mode, cellsize=1.0, lookup_pixels=1,
                               threshold_angle=0.0, neg_mode=True,
                               fast=False, how_fast=20, out=None):
    """K5 for the fused reductions (``csrc/openness_reduced_plan.cu``):
    K2's tuple through the static region plan (:func:`region_plan`), the
    tiles of the plan's interior on the tile path.  Same input rules,
    ``out``, stream and counter (``openness_reduced_plan_cuda.launches``)
    as :func:`openness_reduced_cuda`."""
    outs, launched = _reduced_cuda(
        Z, "openness_reduced_plan_cuda", mode, cellsize, lookup_pixels,
        threshold_angle, neg_mode, fast, how_fast, plan=True, out=out)
    openness_reduced_plan_cuda.launches += launched
    return outs


openness_reduced_plan_cuda.launches = 0


# ----------------------------------------------------------------------
# dispatchers
# ----------------------------------------------------------------------
def _pick(Z, engine, cuda_fn, torch_fn):
    """``engine='auto'``: the kernel for a CUDA tensor, the plain version
    for a CPU tensor; ``'cuda'`` / ``'torch'`` force one (``'cuda'``
    raises on a CPU tensor)."""
    if engine == "auto":
        engine = "cuda" if Z.is_cuda else "torch"
    if engine == "cuda":
        return cuda_fn
    if engine == "torch":
        return torch_fn
    raise ValueError(f"engine must be 'auto', 'cuda' or 'torch', got "
                     f"{engine!r}")


def _counts_kernel(specialize, fast):
    """K5 or K1 by ``specialize`` (:func:`_resolve_specialize`)."""
    return (openness_counts_plan_cuda
            if _resolve_specialize(specialize, False, fast)
            else openness_counts_cuda)


def _reduced_kernel(specialize, fast):
    """K5 or K2 by ``specialize`` (:func:`_resolve_specialize`)."""
    return (openness_reduced_plan_cuda
            if _resolve_specialize(specialize, False, fast)
            else openness_reduced_cuda)


def openness_counts(Z, cellsize=1.0, lookup_pixels=1, threshold_angle=1.0,
                    fast=False, how_fast=20, engine="auto", specialize=None):
    """(num_pos, num_neg) for a float32 tensor, by ``engine``
    (see :func:`_pick`).  ``specialize`` picks the kernel for a CUDA
    tensor as the JAX package picks its route: True K5's static region
    plan, False K1's dynamic route, None the plan for the exact ladder and
    K1 for ``fast``; the plain version ignores it."""
    fn = _pick(Z, engine, _counts_kernel(specialize, fast),
               openness_counts_torch)
    return fn(Z, cellsize=cellsize, lookup_pixels=lookup_pixels,
              threshold_angle=threshold_angle, fast=fast, how_fast=how_fast)


def openness_counts_block(block_haloed, origin, global_shape, lookup_pixels,
                          cellsize=1.0, threshold_angle=1.0, fast=False,
                          how_fast=20, engine="auto"):
    """K4's core-shaped (num_pos, num_neg) for one haloed shard block, by
    ``engine``."""
    fn = _pick(block_haloed, engine, openness_counts_block_cuda,
               openness_counts_block_torch)
    return fn(block_haloed, origin, global_shape, lookup_pixels,
              cellsize=cellsize, threshold_angle=threshold_angle, fast=fast,
              how_fast=how_fast)


def directional_extrema(Z, cellsize=1.0, lookup_pixels=1, fast=False,
                        how_fast=20, origin=None, global_shape=None,
                        engine="auto"):
    """(mx, mn) (8, H, W) planes for a float32 tensor, by ``engine``."""
    fn = _pick(Z, engine, directional_extrema_cuda,
               directional_extrema_torch)
    return fn(Z, cellsize=cellsize, lookup_pixels=lookup_pixels, fast=fast,
              how_fast=how_fast, origin=origin, global_shape=global_shape)


def openness_reduced(Z, mode, cellsize=1.0, lookup_pixels=1,
                     threshold_angle=0.0, neg_mode=True, fast=False,
                     how_fast=20, engine="auto", specialize=None):
    """K2's tuple for a float32 tensor, by ``engine``; ``specialize`` as
    :func:`openness_counts` (K5 or K2)."""
    fn = _pick(Z, engine, _reduced_kernel(specialize, fast),
               openness_reduced_torch)
    return fn(Z, mode, cellsize=cellsize, lookup_pixels=lookup_pixels,
              threshold_angle=threshold_angle, neg_mode=neg_mode, fast=fast,
              how_fast=how_fast)


# ----------------------------------------------------------------------
# counterparts of the Pallas entry points
# ----------------------------------------------------------------------
def openness_degrees(pos_sum, neg_sum):
    """Mean openness in degrees from K2's sums: ``sum * f32(180/pi/8)``,
    as ``openness_pallas``."""
    return pos_sum * _DEG_PER_SUM, neg_sum * _DEG_PER_SUM


def skyview_from_sum(s):
    """Skyview factor from K2's svf sum: ``1 - s * 0.125``, as
    ``skyview_pallas``."""
    return 1.0 - s * 0.125


def geomorphons_cuda(Z, cellsize=1, lookup_pixels=1, threshold_angle=1,
                     fast=False, how_fast=20, specialize=None):
    """Geomorphon classes from K5 or K1 by ``specialize`` (counterpart of
    ``geomorphons_pallas``: no enhance pass)."""
    from .visibility import classes_from_counts
    num_pos, num_neg = _counts_kernel(specialize, fast)(
        Z, cellsize=cellsize, lookup_pixels=lookup_pixels,
        threshold_angle=threshold_angle, fast=fast, how_fast=how_fast)
    return classes_from_counts(num_pos, num_neg)


def openness_cuda(Z, cellsize=1.0, lookup_pixels=1, fast=False,
                  how_fast=20, specialize=None):
    """(positive, negative) openness in degrees from one K5 or K2 launch
    (counterpart of ``openness_pallas``)."""
    return openness_degrees(*_reduced_kernel(specialize, fast)(
        Z, "openness", cellsize=cellsize, lookup_pixels=lookup_pixels,
        fast=fast, how_fast=how_fast))


def skyview_cuda(Z, cellsize=1.0, lookup_pixels=1, specialize=None):
    """Skyview factor from one K5 or K2 launch (counterpart of
    ``skyview_pallas``)."""
    (s,) = _reduced_kernel(specialize, False)(
        Z, "svf", cellsize=cellsize, lookup_pixels=lookup_pixels)
    return skyview_from_sum(s)


def ternary_cuda(Z, cellsize=1.0, lookup_pixels=1, threshold_angle=0.0,
                 use_negative_openness=True, specialize=None):
    """Base-3 ternary code (uint16) from one K5 or K2 launch (counterpart
    of ``ternary_pallas``)."""
    (code,) = _reduced_kernel(specialize, False)(
        Z, "ternary", cellsize=cellsize, lookup_pixels=lookup_pixels,
        threshold_angle=threshold_angle, neg_mode=use_negative_openness)
    return code
