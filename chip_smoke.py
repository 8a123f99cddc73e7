#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``neilpy_tpu_torch/csrc`` (nvcc,
into the git-ignored ``build/``) and its three host libraries from
``neilpy_tpu_torch/native`` (g++: the TIFF codec, the LAS decoder and the
point binning; ``host_build`` fails unless all three load, so no Python
fallback stands in for them here), and holds each kernel against its plain
PyTorch version on the card: K1 (openness counts), K2 (the fused
openness / skyview / ternary reduction), K3 (the per-direction extrema
planes, with and without a global origin), K4 (the counts of one
haloed shard block) and K5 (the static region plan of K1 and K2).  Each
kernel routes every (thread block, direction) pair to the masked or the
maskless ladder, and every kernel (K1, K2, K3 with both entries, K4, K5
for the counts and the reductions) runs its all-safe interior as tiles of
32 x 64 pixels with the Rmax halo in shared memory
(``csrc/ladder_tile.cuh``, filled by TMA or by cp.async; on a shard block
only where the window also lies inside the global raster; K2's and
K5/reduced's fold as the tile's epilogue); ``routes_vs_plain`` holds both
routes of K1 and K2 against each other (equal; K2's bit for bit) and
every kernel with the tile path on and off against the plain version,
on NaN holes (also inside tiles, on both load paths), unaligned shapes
and lookups 1 to 100, ``tile_reaches_vs_plain`` holds the seven tiled
launches (K1, K5/counts, K2 and K5/reduced in each mode, K3, K3's origin
entry, K4) against the plain version on every ladder that takes the tile
path (every halo bucket, on both load paths), the tiled kernels always
writing into outputs pre-filled with a value they never write (255 for
counts, NaN for planes and sums, 0xFFFF for ternary codes) so a pixel no
launch writes shows, and ``maskless_share`` checks that at 8192^2 the
host's route table sends more than 90% of the pairs down the maskless
ladder.  It checks the port against the f64 numpy
oracles of ``tests/reference_impls.py``, then drives three paths at the
reference scale, an 8192 x 8192 DEM written as a GeoTIFF and read back
with ``imread``, at lookup 50:

- ``main_path``: ``geomorphons`` (exact, enhance, fast) -> ``imwrite``
  of the classes (K5's static plan of K1 x 3 for the exact ladder, the
  JAX package's default route there, and K1 x 1 for fast);
- ``openness_path``: ``openness_pair`` (exact, then fast) ->
  ``skyview_factor`` -> ``ternary_pattern_from_openness(lowest=True)``
  -> ``openness(neighbors=[1, 5])`` ->
  ``geomorphons2(use_negative_openness=False, outfile=...)`` ->
  ``imwrite`` of the positive openness (K5's plan of K2 x 3, K2 x 1,
  K3 x 2);
- ``codec_path``: the DEM as ZSTD strips and tiles (the port's writer;
  deflate where libzstd is absent) and as LZW (PIL's libtiff) ->
  ``imread`` -> ``geomorphons`` exact and fast (K5/counts, K1) equal to
  main_path's classes of the uncompressed DEM -> the classes as ZSTD and
  (a 2048^2 crop) LZW, read back equal -> ``mosaic_terrain_products``
  over a ``GeoTiffSource`` of the ZSTD tiles (six products, K1 and K2 per
  tile) equal to the in-memory call; each codec's MB/s, the Python
  decoders' on a 2048^2 crop;
- ``sharded_path``: ``dist.sharded_geomorphons`` on ``make_mesh()`` (the
  visible cards; 1 x 1 on one card) and on a 2 x 2 mesh naming the card
  four times (exact and fast; K4 x 4 each), ``sharded_openness`` and
  ``sharded_skyview`` on that mesh (K3's origin entry x 4 each), each
  against the single-device function, then K4 and K3's origin entry, tile
  path on and off, against their plain versions on every haloed block of
  that mesh, then small multi-hop and non-divisible cases.

Each path runs with every launch count set to 0 just before it and read
just after, and every output is compared with its plain version (the
sharded outputs with the single-device ones) at full size.  Then
``full_size_vs_plain`` holds the raw outputs of K1 and K5 (counts, both
ladders), K2 and K5 (each reduction) and K3 (the planes) against their
plain versions at 8192^2, lookup 50, tile path on and off.  Last, it
times each kernel on each route (all blocks masked, dynamic, static;
each also per-thread, the tile path off; K3's origin entry on a 2 x 2
mesh block, K4 on a 2 x 2 block on both ladders and on
``make_mesh()``'s 1 x 1 block) and its plain version with
CUDA events, checks that both routes beat the all-masked launch (so the
kernels really take the maskless ladder) and that the tile path beats the
per-thread one (so it really runs), times K5/counts at lookup 12 (the
enhance pass's second launch) and the
``geomorphons`` call with the tile path on and off, and times the sharded
call against the single-device one; the kernel table gives each kernel's
bound (operations at the f32 instruction rate or bytes at the HBM rate,
whichever is larger; for K2 and K5/reduced the operations of the fold
too, counted from the TPU kernel's body).

Then the SMRF slice, which runs plain torch ops on the card and none of
K1-K5 (each phase raises on failure):

- ``smrf_path``: ``smrf`` on a seeded 5M-point ``lidar_tile`` (2000 m x
  2000 m of UTM-like coordinates, rolling ground, ~10% box buildings,
  ~10% canopy) at cellsize 1 (~2003^2 cells, ~29% empty), windows 18,
  the published thresholds: fast and exact labels agree on >= 99.9% of
  the points, >= 90% of building points are objects and >= 90% of bare
  ground is kept, ``chunk_points=1_999_999`` gives the one-shot labels
  bit for bit; each stage timed with CUDA events (CG iterations and host
  syncs per fill), the host legs alone, and one ``torch.profiler`` pass
  (device idle share, launches; also of one K-cycle application and one
  spline coefficient set);
- ``inpaint_scale``: ``inpaint_nans_by_springs`` at 4096^2 with a 30%
  contiguous hole, float32, within 1e-3 of the float64 fill at tol=1e-12;
- ``smrf_oracle``: ``precision='exact'`` on the card bit-identical to the
  script's own f64 scipy oracle (a copy of ``tests/reference_impls.py``'s
  on the port's ``disk`` and ``bin_points``) on tests/test_smrf.py's
  building scene, and at 200k points over 400 m (windows 12) equal to the
  port's CPU exact labels, cells differing only at threshold ties;
- ``las_path``: ``write_las`` the 5M-point cloud, ``smrf_las`` it (both
  passes through the native decoder's chunks, counted; a whole-file read
  fails the phase), read it back: classes equal ``smrf``'s labels on the
  decoded points, every byte but the classification bits unchanged; the
  native decoder equal to ``read_las`` on every field, native binning
  equal to numpy's off the cell edges, ``create_dem_from_las`` streamed
  in 1M-point chunks equal to its one-shot grid and its ``read_las``
  branch bit for bit; decode Mpts/s, gridding ms and ``smrf_las``'s peak
  host memory printed.

Then the DEM-products slice, plain torch ops on the card as well (none
of K1-K5; each phase raises on failure):

- ``surface_path``: the README's quickstart at 8192^2, cellsize 10: the
  GeoTIFF -> ``imread`` -> ``hillshade`` -> ``imwrite`` (.tif), then
  ``swiss_shading`` -> ``imwrite`` (.png), K1-K5 counted 0, each host and
  device leg clocked, under one ``torch.profiler`` pass (idle share);
- ``surface_vs_plain``: every public device function of the slice on the
  card against the port's CPU run on a 1024 x 1536 crop of the DEM with
  NaN holes (floats within rtol 1e-5 plus a small share of their range;
  uint8 off by one on < 0.1%; a table gather equal wherever both devices
  read one cell, which they do on > 99.9%; bins except at P ties), the
  uint8 cast (NaN -> 0, saturating) and the NaN holes on the card,
  ``convolve2d_nearest`` within 1e-5 of the sum of its |terms| (TF32 off;
  emulated TF32 must fail that), and float64 numpy oracles: hillshade
  (off by one on < 0.1%), curvature (-100 ndi.laplace) and swiss shading
  at 8192^2, Gi* (disk r=5) at 2048 x 4096 with its counts exact and z
  within 2e-4;
- ``sharded_surface``: ``sharded_hillshade``, ``sharded_rastergi``,
  ``sharded_morans_i`` and ``sharded_local_morans_i`` on the 2 x 2 mesh
  of this card at 8192^2 and on an 8191 x 8190 crop, against their
  single-device forms (hillshade at most one level apart, the statistics
  within tests/test_dist.py's tolerances), with sharded / single walls;
- ``surface_timing``: per function of the slice at 8192^2, the median of
  5 CUDA-event runs, the launches of one call (profiler), the peak
  memory above the input and the bytes-once bound at the HBM rate.

Then BASELINE config 5, the sharded SMRF (plain torch ops, none of
K1-K5) and the out-of-core mosaic stream (whose tile program launches K1
for the classes and K2 for the openness pair, dynamic route):

- ``sharded_smrf_path``: ``dist.sharded_smrf`` on a 2 x 2 mesh of this
  card against ``smrf`` fast on smrf_path's 5M points (windows 18):
  cells and labels equal on >= 99.9%, ``Zpro`` within 1e-3, K1-K5 counted
  0, both calls' stages on CUDA events (CG iterations per fill), one
  profiler pass; ``sharded_progressive_filter`` bit for bit at 2001^2;
  ``sharded_springs_fill`` on inpaint_scale's 4096^2 raster within 1e-3
  of the float64 fill;
- ``mosaic_path``: a seeded 32768^2 DEM in an ``np.memmap`` (a smaller
  side, printed first, where the disk is short) through
  ``mosaic_terrain_products`` (trio, lookup 25, tile 4096, exact wire,
  streamed) into three output memmaps: a child process SIGKILLed at half
  the tiles, the resume here (K1 one launch per remaining tile, all on the
  TMA load of the 4156^2 tile), an uninterrupted run under the profiler
  with the same CRC, three interior windows recomputed untiled on the
  card (``mosaic_child`` is the child's entry, ``--mosaic-child``);
- ``mosaic_vs_plain``: all six products at 8192^2, lookup 31 (4158^2
  tiles, K1's and K2's cp.async load): streamed == resident == a one-card
  2 x 2 mesh bit for bit, compact == exact where exact and its bf16
  rounding elsewhere, card == CPU plain on a 1024^2 crop; K1 and K2 timed
  on one mosaic tile each against their plain versions.

Tolerances, kernel against plain version: counts, classes, extrema and
ternary codes exact; openness within 5e-5 degrees, with +inf (a pixel
that saw nothing) at the same pixels; skyview factor within 1e-6.
Sharded against single-device: classes exact, openness within 1e-4
degrees, skyview within 1e-6 (tests/test_dist.py).

Every phase prints one JSON line.  The lines before the last are the
card's name and power limit as nvidia-smi reports them, then the kernel
table ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero without that line; so does a machine with no CUDA device.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
MAIN_SHAPE = (8192, 8192)      # bench.py SCALE_SHAPE: ~1e8 px, Poland EU-DEM scale
MAIN_LOOKUP = 50
ENHANCE_LOOKUP = 12            # geomorphons(enhance=True)'s second pass
TIMED_RUNS = 5
# the H100 SXM's published rates (NVIDIA's data sheet): float32 outside
# the tensor cores, 67 TFLOP/s counting an FMA as two operations, so
# 33.5e12 single f32 instructions per second; and HBM3
PEAK_F32_OPS = 67e12 / 2
PEAK_HBM_BYTES = 3.35e12
OPS_PER_STEP = 4               # sub, mul, max, min per ladder step: (Z-c)*s
# K2's fold per pixel and direction, counted as elementwise operations of
# the TPU kernel's own body (pallas_scan.py:911-942, reduce_dir), the same
# work whatever implements it, at its least: a multiply whose one use is an
# add or a subtract counts with it as one operation (an FMA, one
# instruction on the card).  Openness: two _atan_f32 (ATAN_OPS, the
# equations of its jaxpr, less ATAN_FMAS such pairs: its polynomial's
# three Horner steps and p*z*r + r) plus seen, two subtractions from pi/2,
# -mn, two selects and two accumulates; svf max, 1 + t*t (one FMA), sqrt,
# div, accumulate; ternary with neg_mode seen and the tangent-space
# classify (19, 1 + a*b one FMA: 18), two "&", the digit (two selects, add,
# sub), times 3^d and accumulate (one FMA); without it seen, two compares,
# not, or, and, the digit, times 3^d and accumulate (one FMA)
ATAN_OPS = 28
ATAN_FMAS = 4
FOLD_OPS = {("openness", True): 2 * (ATAN_OPS - ATAN_FMAS) + 8,
            ("svf", True): 5, ("ternary", True): 25, ("ternary", False): 11}
# both routes must beat the all-masked launch by this factor at 8192^2
# (they take the maskless ladder on ~99% of the pairs)
ROUTE_GAIN = 0.8
# the tile path of every tiled kernel must beat its per-thread body by
# this factor at 8192^2 (it takes ~97% of the pixels there)
TILE_GAIN = 0.9
OPENNESS_TOL = 5e-5            # degrees: atanf vs torch.atan, per direction
SVF_TOL = 1e-6
ORACLE_OPENNESS_TOL = 2e-4     # degrees, as tests/test_visibility.py
ORACLE_SVF_TOL = 2e-6          # as tests/test_visibility.py
SHARDED_OPENNESS_TOL = 1e-4    # degrees, as tests/test_dist.py


def emit(**record):
    print(json.dumps(record), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_input(shape):
    """bench.py's input (``_bench_input``) at ``shape``: cumulative sums
    of seeded normals along both axes, float32."""
    Z = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    return np.cumsum(Z, axis=0) + np.cumsum(Z, axis=1)


def kernel_fns(cuda_scan):
    """The kernels' wrappers, whose ``launches`` the paths count: K1-K4
    on the dynamic route, K5's region plan of K1 (counts) and of K2
    (reduced)."""
    return {"K1": cuda_scan.openness_counts_cuda,
            "K2": cuda_scan.openness_reduced_cuda,
            "K3": cuda_scan.directional_extrema_cuda,
            "K4": cuda_scan.openness_counts_block_cuda,
            "K5/counts": cuda_scan.openness_counts_plan_cuda,
            "K5/reduced": cuda_scan.openness_reduced_plan_cuda}


def reset_counts(cuda_scan):
    for fn in kernel_fns(cuda_scan).values():
        fn.launches = 0


def read_counts(cuda_scan):
    return {k: fn.launches for k, fn in kernel_fns(cuda_scan).items()}


def ladder_steps(H, W, ladder, core=None):
    """Ladder steps the kernels take on an (H, W) raster: per direction d
    and entry L, the pixels whose read p + d*L is on the array (the
    masked body stops at the edge; NaN reads are counted, the kernel makes
    them).  ``core``: a shard block's core shape, every step of which
    stays on its haloed array."""
    from neilpy_tpu_torch.core.shift import OFFSETS
    if core is not None:
        return 8 * len(ladder) * core[0] * core[1]
    return sum(max(0, H - abs(dr) * L) * max(0, W - abs(dc) * L)
               for dr, dc in OFFSETS for L in ladder)


def fold_ops(mode, pixels, neg_mode=True):
    """K2's fold over 8 directions of ``pixels`` pixels, in operations
    (``FOLD_OPS``; svf and openness take no ``neg_mode``)."""
    return FOLD_OPS[mode, neg_mode or mode != "ternary"] * 8 * pixels


def bound(steps, nbytes, fold=0, per_step=OPS_PER_STEP):
    """(ms, side): the least time the card could take, the larger of the
    operations at the f32 instruction rate and the bytes (each input read
    once, each output written once) at the HBM rate.  The operations are
    ``per_step`` per ladder step (``OPS_PER_STEP``, 3 where only the max is
    needed: (Z - c) * s rounds twice, so no FMA computes it) plus
    ``fold``, the operations K2 and K5/reduced spend folding the
    directions, which the TPU kernel spends too (``fold_ops``, with its
    multiply-adds fused).  A divide or a square root counts as one
    operation, though the card issues several instructions for it."""
    t_ops = (per_step * steps + fold) / PEAK_F32_OPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def float_err(got, want, tol, what):
    """Max |got - want| over finite values; +inf at the same pixels, no
    NaN anywhere; fails above ``tol``."""
    check(not torch.isnan(got).any() and not torch.isnan(want).any(),
          f"{what}: NaN in the output")
    inf = torch.isinf(got)
    check(torch.equal(inf, torch.isinf(want)),
          f"{what}: +inf (unseen) at other pixels")
    err = float((got[~inf] - want[~inf]).abs().max()) if (~inf).any() else 0.
    check(err <= tol, f"{what}: max |diff| {err} above {tol}")
    return err


def reduced_err(cuda_scan, mode, got, want, what):
    """K2's outputs against the plain version's, in the units the
    tolerances are stated in (openness in degrees)."""
    if mode == "ternary":
        err = int((got[0].int() - want[0].int()).abs().max())
        check(err == 0, f"{what}: ternary codes differ (max {err})")
        return err
    if mode == "openness":
        got = cuda_scan.openness_degrees(*got)
        want = cuda_scan.openness_degrees(*want)
    tol = OPENNESS_TOL if mode == "openness" else SVF_TOL
    return max(float_err(g, w, tol, what) for g, w in zip(got, want))


def kernel_vs_plain(cuda_scan, dev):
    """Phase 3: each kernel against its plain version on every case: K1
    and K3 exactly, K2 at the stated tolerances."""
    from neilpy_tpu_torch.ops.visibility import classes_from_counts
    r = np.random.default_rng(7)
    small = r.normal(size=(100, 140)).cumsum(0).cumsum(1).astype(np.float32)
    big = r.normal(size=(1000, 1537)).cumsum(0).cumsum(1).astype(np.float32)
    big[300:340, 500:620] = np.nan           # nodata hole
    big[700:712, :] = np.nan                 # all-NaN row band
    tiny = r.normal(size=(24, 32)).cumsum(0).astype(np.float32)
    isolated = np.full((32, 140), np.nan, dtype=np.float32)
    isolated[16, 70] = 5.0                   # every ray sees only NaN
    cases = [("100x140", small, lk, t, f)
             for lk in (1, 7, 50) for t in (0.0, 1.0, 5.0)
             for f in (False, True)]
    cases += [("1000x1537+nan", big, lk, 1.0, f)
              for lk in (1, 7, 50) for f in (False, True)]
    cases += [("1000x1537+nan", big, 7, t, False) for t in (0.0, 5.0)]
    cases += [("24x32", tiny, 100, 1.0, f) for f in (False, True)]
    worst = 0
    for name, Z, lk, t, f in cases:
        Zd = torch.from_numpy(Z).to(dev)
        kw = dict(cellsize=2.0, lookup_pixels=lk, threshold_angle=t, fast=f)
        k = cuda_scan.openness_counts_cuda(Zd, out=unwritten(Zd), **kw)
        p = cuda_scan.openness_counts_torch(Zd, **kw)
        torch.cuda.synchronize()
        err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, p))
        worst = max(worst, err)
        check(err == 0, f"kernel != plain on {name} lookup={lk} "
                        f"threshold={t} fast={f} (max |diff| {err})")
    Zd = torch.from_numpy(big).to(dev)
    G = cuda_scan.geomorphons_cuda(Zd, cellsize=2.0, lookup_pixels=50)
    plain = classes_from_counts(*cuda_scan.openness_counts_torch(
        Zd, cellsize=2.0, lookup_pixels=50))
    check(torch.equal(G, plain), "geomorphons_cuda != plain classes")
    emit(phase="kernel_vs_plain", kernel="K1", cases=len(cases),
         max_abs_err=worst)

    rasters = [("100x140", small, lk) for lk in (1, 7, 50)]
    rasters += [("1000x1537+nan", big, lk) for lk in (1, 7, 50)]
    rasters += [("24x32", tiny, 100), ("32x140 isolated", isolated, 3)]
    k2_variants = [("openness", {}), ("openness", {"fast": True}),
                   ("svf", {}),
                   ("ternary", {"threshold_angle": 0.0}),
                   ("ternary", {"threshold_angle": 1.0}),
                   ("ternary", {"threshold_angle": 1.0, "neg_mode": False})]
    k2_err = {"openness": 0.0, "svf": 0.0, "ternary": 0}
    k3_err = 0.0
    n2 = n3 = 0
    for name, Z, lk in rasters:
        Zd = torch.from_numpy(Z).to(dev)
        for mode, extra in k2_variants:
            kw = dict(cellsize=2.0, lookup_pixels=lk, **extra)
            k = cuda_scan.openness_reduced_cuda(Zd, mode, **kw)
            p = cuda_scan.openness_reduced_torch(Zd, mode, **kw)
            torch.cuda.synchronize()
            k2_err[mode] = max(k2_err[mode], reduced_err(
                cuda_scan, mode, k, p, f"K2 {mode} {extra} on {name} "
                                       f"lookup={lk}"))
            n2 += 1
        for f in (False, True):
            kw = dict(cellsize=2.0, lookup_pixels=lk, fast=f)
            k = cuda_scan.directional_extrema_cuda(Zd, **kw)
            p = cuda_scan.directional_extrema_torch(Zd, **kw)
            torch.cuda.synchronize()
            for a, b in zip(k, p):
                what = f"K3 extrema on {name} lookup={lk} fast={f}"
                check(torch.equal(a, b), f"{what}: kernel != plain")
                k3_err = max(k3_err, float_err(a, b, 0.0, what))
            n3 += 1
    pos, neg = cuda_scan.openness_cuda(torch.from_numpy(isolated).to(dev),
                                       lookup_pixels=3)
    check(bool(torch.isposinf(pos[16, 70])) and
          bool(torch.isposinf(neg[16, 70])),
          "isolated pixel: openness is not +inf")
    emit(phase="kernel_vs_plain", kernel="K2", cases=n2,
         max_abs_err_by_mode=k2_err, tolerance_by_mode={
             "openness_deg": OPENNESS_TOL, "svf": SVF_TOL, "ternary": 0})
    emit(phase="kernel_vs_plain", kernel="K3", cases=n3, max_abs_err=k3_err)
    k4_err, k3o_err = block_kernels_vs_plain(cuda_scan, dev, big)
    return {"K1": worst, "K2": max(k2_err.values()),
            "K3": max(k3_err, k3o_err), "K4": k4_err}


def block_kernels_vs_plain(cuda_scan, dev, big):
    """K4 and K3's origin entry against their plain versions on blocks cut
    from the NaN-padded 1000 x 1537 raster (nodata hole, all-NaN row
    band): corner, edge, interior and hole origins, lookups 7 and 50,
    both ladders, and a lookup larger than the block; K4 also against
    K1's single-device counts on the block's core.  All exact."""
    H, W = big.shape
    origins = [(0, 0), (0, W - 384), (300, 500), (H - 250, W - 384),
               (690, 700)]
    cases = [(o, (250, 384), lk, False) for o in origins for lk in (7, 50)]
    cases += [(o, (250, 384), lk, True) for o in origins[1:3]
              for lk in (7, 50)]
    cases += [(o, (40, 60), 100, False) for o in ((0, 0), (480, 700))]
    single = {}
    worst = 0
    for (oy, ox), (bh, bw), lk, fast in cases:
        Zp = np.pad(big, lk, constant_values=np.nan)
        block = torch.from_numpy(np.ascontiguousarray(
            Zp[oy:oy + bh + 2 * lk, ox:ox + bw + 2 * lk])).to(dev)
        kw = dict(cellsize=2.0, threshold_angle=1.0, fast=fast)
        args = (block, (oy, ox), (H, W), lk)
        k = cuda_scan.openness_counts_block_cuda(*args, **kw)
        p = cuda_scan.openness_counts_block_torch(*args, **kw)
        if (lk, fast) not in single:
            single[(lk, fast)] = cuda_scan.openness_counts_cuda(
                torch.from_numpy(big).to(dev), lookup_pixels=lk, **kw)
        s = [c[oy:oy + bh, ox:ox + bw] for c in single[(lk, fast)]]
        torch.cuda.synchronize()
        what = f"K4 at origin {(oy, ox)} block {(bh, bw)} lookup={lk} fast={fast}"
        err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, p))
        worst = max(worst, err)
        check(err == 0, f"{what}: kernel != plain (max |diff| {err})")
        check(all(torch.equal(a, b) for a, b in zip(k, s)),
              f"{what}: != single-device K1 counts on the core")
    emit(phase="kernel_vs_plain", kernel="K4", cases=len(cases),
         max_abs_err=worst)

    k3o = 0.0
    n = 0
    for (oy, ox), lk in (((0, 0), 7), ((300, 500), 50), ((H - 250, 0), 50),
                         ((690, 700), 7)):
        Zp = np.pad(big, lk, constant_values=np.nan)
        block = torch.from_numpy(np.ascontiguousarray(
            Zp[oy:oy + 250 + 2 * lk, ox:ox + 384 + 2 * lk])).to(dev)
        kw = dict(cellsize=2.0, lookup_pixels=lk, origin=(oy - lk, ox - lk),
                  global_shape=(H, W))
        k = cuda_scan.directional_extrema_cuda(block, **kw)
        p = cuda_scan.directional_extrema_torch(block, **kw)
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            what = f"K3 origin entry at {(oy, ox)} lookup={lk}"
            check(torch.equal(a, b), f"{what}: kernel != plain")
            k3o = max(k3o, float_err(a, b, 0.0, what))
        n += 1
    emit(phase="kernel_vs_plain", kernel="K3 origin entry", cases=n,
         max_abs_err=k3o)
    return worst, k3o


def route_rasters():
    """The routing cases: today's rasters plus a NaN hole deep inside an
    interior block, shapes that are not multiples of the 8 x 32 block,
    one raster smaller than the longest lookup, and one whose width is not
    a multiple of 4 (the tile path's cp.async load) with a NaN hole inside
    its tiles; the 600 x 900 raster's NaN lies in a TMA-loaded tile."""
    r = np.random.default_rng(11)
    small = r.normal(size=(100, 140)).cumsum(0).cumsum(1).astype(np.float32)
    big = r.normal(size=(1000, 1537)).cumsum(0).cumsum(1).astype(np.float32)
    big[300:340, 500:620] = np.nan           # nodata hole
    big[700:712, :] = np.nan                 # all-NaN row band
    deep = r.normal(size=(600, 900)).cumsum(0).cumsum(1).astype(np.float32)
    deep[300, 450] = np.nan                  # one NaN deep in the interior
    odd = r.normal(size=(257, 389)).cumsum(0).astype(np.float32)
    odd[100:120, 40:90] = np.nan
    thin = r.normal(size=(97, 45)).cumsum(1).astype(np.float32)
    tiny = r.normal(size=(24, 32)).cumsum(0).astype(np.float32)
    unaligned = r.normal(size=(515, 771)).cumsum(0).cumsum(1).astype(
        np.float32)
    unaligned[200:210, 300:330] = np.nan     # inside the tiles up to lookup 50
    return [("100x140", small), ("1000x1537+nan", big),
            ("600x900+deep nan", deep), ("257x389+nan", odd),
            ("97x45", thin), ("24x32", tiny),
            ("515x771+nan in a tile", unaligned)]


def unwritten(Zd, shape=None):
    """An ``out`` pair for the counts kernels (of ``shape``, default Zd's;
    K4: its core's), pre-filled with 255: a count is at most 8, so a pixel
    that no kernel of the launch writes differs from the plain version."""
    return tuple(torch.full(Zd.shape if shape is None else shape, 255,
                            dtype=torch.uint8, device=Zd.device)
                 for _ in range(2))


def unwritten_planes(Zd):
    """An ``out`` pair for K3, pre-filled with NaN: the ladder never keeps
    a NaN, so a plane value that no kernel of the launch writes differs
    from the plain version (and fails ``float_err``)."""
    return tuple(torch.full((8, *Zd.shape), float("nan"), device=Zd.device)
                 for _ in range(2))


# K2's mode variants: (mode, keyword arguments)
REDUCED_VARIANTS = {
    "openness": ("openness", {}), "svf": ("svf", {}),
    "ternary": ("ternary", {"threshold_angle": 1.0}),
    "ternary neg_mode=False": ("ternary", {"threshold_angle": 1.0,
                                           "neg_mode": False})}


def unwritten_reduced(Zd, mode):
    """An ``out`` tuple for K2 and K5/reduced in ``mode``, pre-filled with
    a value no launch writes: NaN for the sums (a sum is finite or +inf),
    0xFFFF for the codes (at most 6560)."""
    if mode == "ternary":
        return (torch.full(Zd.shape, 0xFFFF, dtype=torch.int32,
                           device=Zd.device).to(torch.uint16),)
    return tuple(torch.full(Zd.shape, float("nan"), device=Zd.device)
                 for _ in range(2 if mode == "openness" else 1))


def reduced_bits(t):
    """A reduced output as int32 bits: the sums by their bit pattern (so a
    -0 against a +0 shows), the uint16 codes widened (a storage type)."""
    return t.int() if t.dtype == torch.uint16 else t.view(torch.int32)


def reduced_identical(outs, what):
    """Every output tuple of ``outs`` ({label: tuple}) equals the first
    bit for bit."""
    (first, ref), *rest = outs.items()
    for label, got in rest:
        check(all(torch.equal(reduced_bits(a), reduced_bits(b))
                  for a, b in zip(got, ref)),
              f"{what}: {label} differs from {first} bit for bit")


def tile_case(cuda_scan, nan_grid, Zd, lookup, fast, plan=False,
              **geometry):
    """(load path, a NaN inside a tile) of one launch on the array ``Zd``
    as the host routes it (``cuda_scan._tile_args``, the arguments the
    kernel gets): K1, K2 or K3 (``plan`` False) or K5 on a whole raster,
    K4 or K3's origin entry given a shard block's ``geometry``
    (``cuda_scan.tile_route``); ``nan_grid`` marks the NaN cells of the
    kernel's grid (K4: the core).  None where no tile runs."""
    ladder = cuda_scan._ladder(lookup, fast)
    args = cuda_scan._tile_args(Zd, ladder[-1], len(ladder), plan,
                                **geometry)
    if not args[0]:
        return None
    t = cuda_scan.tile_route(*Zd.shape, ladder[-1], plan, len(ladder),
                             **geometry)
    return ("tma" if args[5] else "cp.async",
            bool((nan_grid & t.pixels(*nan_grid.shape)).any()))


def tiled_runs(cuda_scan, tiled=True):
    """Tile path on, then off (``per_thread``): the contexts a comparison
    runs each kernel under.  Where no tile runs (``tiled`` false) the two
    would be the same launch, so only the first."""
    runs = [(True, contextlib.nullcontext)]
    if tiled:
        runs.append((False, lambda: per_thread(cuda_scan)))
    return runs


def planes_equal(got, want, what):
    """K3's planes against the plain version's: equal by value (the
    maskless body may keep +0 for -0), no NaN (an unwritten value of
    ``unwritten_planes``); the max |diff| (0)."""
    for a, b in zip(got, want):
        check(torch.equal(a, b), f"{what}: kernel != plain (by value)")
    return max(float_err(a, b, 0.0, what) for a, b in zip(got, want))


def routes_vs_plain(cuda_scan, dev):
    """Phase 3b: both routes of K1 and K2 (the dynamic kernel and K5's
    static plan), exact and fast ladders, against each other and the
    plain version; every kernel (K1, K5/counts, K2 and K5/reduced in each
    mode variant, K3, K3's origin entry and K4, dynamic route only for the
    last three) with the tile path on and, where a tile runs (elsewhere
    the two are one launch), off against the plain version, into outputs
    no launch leaves unwritten unseen; lookups 1 to 100, so R
    also exceeds the smaller rasters.  Between routes and between tile
    path on and off every output is equal (counts exactly; K2's and
    K5/reduced's bit for bit, openness sums too); against the plain
    version counts, codes and extrema exactly (extrema by value), openness
    and skyview within the stated tolerances.  Both tile load paths must
    run in each tiled kernel, each also on a raster with a NaN inside its
    tiles."""
    worst = {"K1": 0, "K2": 0.0, "K3": 0.0, "K4": 0, "K5/counts": 0,
             "K5/reduced": 0.0}
    n = {k: 0 for k in worst}
    tiled_kernels = ("K1", "K5/counts", "K2", "K5/reduced", "K3",
                     "K3 origin", "K4")
    tile_runs = {f"{k} {load}": 0 for k in tiled_kernels
                 for load in ("tma", "cp.async")}
    nan_in_tile = dict(tile_runs)

    def count(kid, case):
        if case is not None:
            tile_runs[f"{kid} {case[0]}"] += 1
            nan_in_tile[f"{kid} {case[0]}"] += case[1]

    lookups = (1, 2, 7, 12, 24, 33, 50, 100)
    for name, Z in route_rasters():
        Zd = torch.from_numpy(Z).to(dev)
        nan = np.isnan(Z)
        for lk in lookups:
            for fast in (False, True):
                what = f"{name} lookup={lk} fast={fast}"
                kw = dict(cellsize=2.0, lookup_pixels=lk, fast=fast)
                p = cuda_scan.openness_counts_torch(Zd, threshold_angle=1.0,
                                                    **kw)
                for kid, fn in (("K1", cuda_scan.openness_counts_cuda),
                                ("K5/counts",
                                 cuda_scan.openness_counts_plan_cuda)):
                    case = tile_case(cuda_scan, nan, Zd, lk, fast,
                                     kid == "K5/counts")
                    for tiled, ctx in tiled_runs(cuda_scan, case):
                        with ctx():
                            k = fn(Zd, threshold_angle=1.0,
                                   out=unwritten(Zd), **kw)
                        torch.cuda.synchronize()
                        err = max(int((a.int() - b.int()).abs().max())
                                  for a, b in zip(k, p))
                        check(err == 0, f"{kid} counts (tile path "
                                        f"{'on' if tiled else 'off'}) != "
                                        f"plain on {what} (max |diff| {err})")
                        n[kid] += 1
                    count(kid, case)
                for variant, (mode, extra) in REDUCED_VARIANTS.items():
                    mkw = dict(kw, **extra)
                    p = cuda_scan.openness_reduced_torch(Zd, mode, **mkw)
                    outs = {}
                    for kid, fn in (("K2", cuda_scan.openness_reduced_cuda),
                                    ("K5/reduced",
                                     cuda_scan.openness_reduced_plan_cuda)):
                        case = tile_case(cuda_scan, nan, Zd, lk, fast,
                                         kid == "K5/reduced")
                        for tiled, ctx in tiled_runs(cuda_scan, case):
                            with ctx():
                                k = fn(Zd, mode, out=unwritten_reduced(
                                    Zd, mode), **mkw)
                            torch.cuda.synchronize()
                            label = (f"{kid} (tile path "
                                     f"{'on' if tiled else 'off'})")
                            worst[kid] = max(worst[kid], reduced_err(
                                cuda_scan, mode, k, p,
                                f"{label} {variant} on {what}"))
                            outs[label] = k
                            n[kid] += 1
                        count(kid, case)
                    reduced_identical(outs, f"{variant} on {what}")
                p = cuda_scan.directional_extrema_torch(Zd, **kw)
                case = tile_case(cuda_scan, nan, Zd, lk, fast)
                for tiled, ctx in tiled_runs(cuda_scan, case):
                    with ctx():
                        k = cuda_scan.directional_extrema_cuda(
                            Zd, out=unwritten_planes(Zd), **kw)
                    torch.cuda.synchronize()
                    state = "on" if tiled else "off"
                    worst["K3"] = max(worst["K3"], planes_equal(
                        k, p, f"K3 extrema (tile path {state}) on {what}"))
                    n["K3"] += 1
                count("K3", case)
        # K4 and K3's origin entry on blocks of this raster padded with NaN:
        # a corner block and, where the raster allows, an interior one
        H, W = Z.shape
        for lk in (2, 12, 50):
            Zp = np.pad(Z, lk, constant_values=np.nan)
            bh, bw = max(1, H // 2), max(1, W // 2)
            for oy, ox in {(0, 0), (H - bh, W - bw), (H // 4, W // 4)}:
                block = torch.from_numpy(np.ascontiguousarray(
                    Zp[oy:oy + bh + 2 * lk, ox:ox + bw + 2 * lk])).to(dev)
                where = f"{name} block at {(oy, ox)} lookup={lk}"
                args = (block, (oy, ox), (H, W), lk)
                core_nan = nan[oy:oy + bh, ox:ox + bw]
                for fast in (False, True):
                    bkw = dict(cellsize=2.0, threshold_angle=1.0, fast=fast)
                    p = cuda_scan.openness_counts_block_torch(*args, **bkw)
                    case = tile_case(
                        cuda_scan, core_nan, block, lk, fast,
                        **cuda_scan._block_tiles(block, (oy, ox), (H, W),
                                                 lk))
                    for tiled, ctx in tiled_runs(cuda_scan, case):
                        with ctx():
                            k = cuda_scan.openness_counts_block_cuda(
                                *args, out=unwritten(block, (bh, bw)), **bkw)
                        torch.cuda.synchronize()
                        err = max(int((a.int() - b.int()).abs().max())
                                  for a, b in zip(k, p))
                        check(err == 0, f"K4 (tile path "
                                        f"{'on' if tiled else 'off'}) != "
                                        f"plain on {where} fast={fast}")
                        n["K4"] += 1
                    count("K4", case)
                org = (oy - lk, ox - lk)
                okw = dict(cellsize=2.0, lookup_pixels=lk, origin=org,
                           global_shape=(H, W))
                p = cuda_scan.directional_extrema_torch(block, **okw)
                block_nan = np.isnan(block.cpu().numpy())
                case = tile_case(cuda_scan, block_nan, block, lk, False,
                                 origin=org, global_shape=(H, W))
                for tiled, ctx in tiled_runs(cuda_scan, case):
                    with ctx():
                        k = cuda_scan.directional_extrema_cuda(
                            block, out=unwritten_planes(block), **okw)
                    torch.cuda.synchronize()
                    state = "on" if tiled else "off"
                    worst["K3"] = max(worst["K3"], planes_equal(
                        k, p, f"K3 origin entry (tile path {state}) on "
                              f"{where}"))
                    n["K3"] += 1
                count("K3 origin", case)
    check(min(tile_runs.values()) > 0 and min(nan_in_tile.values()) > 0,
          f"a tile load path did not run in a kernel, or never over a NaN: "
          f"launches {tile_runs}, with a NaN in a tile {nan_in_tile}")
    emit(phase="routes_vs_plain", cases=n, max_abs_err=worst,
         lookups=list(lookups), rasters=[r[0] for r in route_rasters()],
         between_routes_max_abs_err=0, tile_launches_by_load=tile_runs,
         tile_launches_with_nan_by_load=nan_in_tile)
    return worst


def tile_reaches_vs_plain(cuda_scan, dev):
    """Phase 3c: every ladder that takes the tile path (exact lookups 1 to
    94, the fast ladders of lookups 1 to 120), on a raster that TMA loads
    and on one that cp.async loads (W % 4 != 0), each with a NaN inside
    the tiles: K1, K5/counts, K3, K3's origin entry and K4 (the raster as
    a haloed block with R = lookup, whose core sits at (1024, 1024) of a
    4096^2 raster, so only the block bounds its tiles; K4's window starts
    R % 16 columns further left), written into outputs pre-filled with a
    value they never write, against the plain version, max |diff| 0; K2
    and K5/reduced the same way in openness on every ladder and in each
    other mode variant (svf, ternary with and without ``neg_mode``) on
    the first ladder of each halo bucket and load path, against the plain
    version at the stated tolerances and, where both ran, against each
    other bit for bit.  Every halo bucket must run on both load paths in
    every kernel, and in K2 and K5/reduced in every mode variant."""
    r = np.random.default_rng(13)
    rasters = []
    for W in (512, 515):
        Z = r.normal(size=(384, W)).cumsum(0).cumsum(1).astype(np.float32)
        Z[190:194, 250:260] = np.nan
        rasters.append((f"384x{W}+nan", Z))
    ladders = {}
    for fast in (False, True):
        for lk in range(1, 121):
            ladders.setdefault(cuda_scan._ladder(lk, fast), (lk, fast))
    gshape = (4096, 4096)
    ran = {}
    worst = {"counts": 0, "planes": 0.0, "reduced": 0.0}
    for name, Z in rasters:
        Zd = torch.from_numpy(Z).to(dev)
        for ladder, (lk, fast) in ladders.items():
            Rmax, K = ladder[-1], len(ladder)
            kw = dict(cellsize=2.0, lookup_pixels=lk, fast=fast)
            origin = (1024 - lk, 1024 - lk)
            k4 = (Zd, (1024, 1024), gshape, lk)
            okw = dict(origin=origin, global_shape=gshape, **kw)
            # the plain versions, computed once per ladder where a tile runs
            plain_fns = {
                "counts": lambda: cuda_scan.openness_counts_torch(
                    Zd, threshold_angle=1.0, **kw),
                "planes": lambda: cuda_scan.directional_extrema_torch(
                    Zd, **kw),
                "origin": lambda: cuda_scan.directional_extrema_torch(
                    Zd, **okw),
                "block": lambda: cuda_scan.openness_counts_block_torch(
                    *k4, threshold_angle=1.0, fast=fast, cellsize=2.0)}
            # (kernel, tile geometry, launch into ``out``, plain version)
            runs = [
                ("K1", dict(plan=False), lambda out: cuda_scan
                 .openness_counts_cuda(Zd, threshold_angle=1.0, out=out,
                                       **kw), "counts"),
                ("K5/counts", dict(plan=True), lambda out: cuda_scan
                 .openness_counts_plan_cuda(Zd, threshold_angle=1.0,
                                            out=out, **kw), "counts"),
                ("K3", dict(plan=False), lambda out: cuda_scan
                 .directional_extrema_cuda(Zd, out=out, **kw), "planes"),
                ("K3 origin", dict(plan=False, origin=origin,
                                   global_shape=gshape),
                 lambda out: cuda_scan.directional_extrema_cuda(
                     Zd, out=out, **okw), "origin"),
                ("K4", dict(plan=False, **cuda_scan._block_tiles(*k4)),
                 lambda out: cuda_scan.openness_counts_block_cuda(
                     *k4, threshold_angle=1.0, fast=fast, cellsize=2.0,
                     out=out), "block")]
            plain = {}
            for kid, geom, launch, ref in runs:
                args = cuda_scan._tile_args(Zd, Rmax, K, **geom)
                if not args[0]:
                    continue
                if ref not in plain:
                    plain[ref] = plain_fns[ref]()
                p = plain[ref]
                kind = "planes" if ref in ("planes", "origin") else "counts"
                out = (unwritten(Zd, p[0].shape) if kind == "counts"
                       else unwritten_planes(Zd))
                k = launch(out)
                torch.cuda.synchronize()
                what = (f"{kid} tile path on {name} lookup={lk} fast={fast} "
                        f"halo={args[0]}")
                if kind == "counts":
                    err = max(int((a.int() - b.int()).abs().max())
                              for a, b in zip(k, p))
                    check(err == 0, f"{what}: != plain (max |diff| {err})")
                else:
                    err = planes_equal(k, p, what)
                worst[kind] = max(worst[kind], err)
                key = f"{kid} {'tma' if args[5] else 'cp.async'} {args[0]}"
                ran[key] = ran.get(key, 0) + 1
            outs = {variant: {} for variant in REDUCED_VARIANTS}
            for kid, fn, plan in (
                    ("K2", cuda_scan.openness_reduced_cuda, False),
                    ("K5/reduced", cuda_scan.openness_reduced_plan_cuda,
                     True)):
                args = cuda_scan._tile_args(Zd, Rmax, K, plan)
                if not args[0]:
                    continue
                load = "tma" if args[5] else "cp.async"
                for variant, (mode, extra) in REDUCED_VARIANTS.items():
                    key = f"{kid} {variant} {load} {args[0]}"
                    if variant != "openness" and key in ran:
                        continue
                    if variant not in plain:
                        plain[variant] = cuda_scan.openness_reduced_torch(
                            Zd, mode, **kw, **extra)
                    k = fn(Zd, mode, out=unwritten_reduced(Zd, mode), **kw,
                           **extra)
                    torch.cuda.synchronize()
                    worst["reduced"] = max(worst["reduced"], reduced_err(
                        cuda_scan, mode, k, plain[variant],
                        f"{kid} {variant} tile path on {name} lookup={lk} "
                        f"fast={fast} halo={args[0]}"))
                    outs[variant][kid] = k
                    ran[key] = ran.get(key, 0) + 1
            for variant, both in outs.items():
                if len(both) == 2:
                    reduced_identical(both, f"{variant} tile path on {name} "
                                            f"lookup={lk} fast={fast}")
    want = {f"{kid} {load} {h}"
            for kid in ("K1", "K5/counts", "K3", "K3 origin", "K4")
            for load in ("tma", "cp.async") for h in cuda_scan._TILE_HALOS}
    want |= {f"{kid} {variant} {load} {h}" for kid in ("K2", "K5/reduced")
             for variant in REDUCED_VARIANTS for load in ("tma", "cp.async")
             for h in cuda_scan._TILE_HALOS}
    check(want <= set(ran), f"halo buckets not run: {sorted(want - set(ran))}")
    emit(phase="tile_reaches_vs_plain", rasters=[r[0] for r in rasters],
         ladders=len(ladders), launches_by_kernel_load_halo=ran,
         max_abs_err=worst)
    return worst


def maskless_share(cuda_scan, Zd):
    """The share of (thread block, direction) pairs that the host's route
    table (``cuda_scan.route_table``, the numpy model of the kernels'
    predicate) sends down the maskless ladder on ``Zd`` at lookup 50,
    under K5's plan and the dynamic predicate.  What the kernels do is
    checked by ``timings``: both routes must beat the all-masked launch."""
    share = {}
    for name, spec in (("static", True), ("dynamic", False)):
        for fast in (False, True):
            t = cuda_scan.route_table(Zd, MAIN_LOOKUP, fast=fast,
                                      specialize=spec)
            share[f"{name}/{'fast' if fast else 'exact'}"] = float(
                t.float().mean())
    check(min(share.values()) > 0.9,
          f"maskless share at {tuple(Zd.shape)}: {share}, expected > 0.9")
    emit(phase="maskless_share", shape=list(Zd.shape), lookup=MAIN_LOOKUP,
         block=list(cuda_scan.BLOCK), share=share, source="host route table")
    return share


def full_size_vs_plain(cuda_scan, Zd):
    """Phase 6b: the kernels' raw outputs at 8192^2, lookup 50, against
    their plain versions on the same input (uncounted): K1 and K5/counts
    (threshold 1, both ladders, tile path on and off) exactly and equal to
    each other; K2 and K5/reduced (each mode, exact ladder, and openness
    on the fast ladder; tile path on and off, into outputs pre-filled with
    a value no launch writes) at the stated tolerances and equal to each
    other bit for bit; K3's planes (tile path on and off, into NaN-filled
    outputs) exactly by value.  The paths compare only what these outputs
    become (classes, degrees), which can hide a wrong count or
    extremum."""
    kw = dict(cellsize=10.0, lookup_pixels=MAIN_LOOKUP)
    worst = {"K1": 0, "K5/counts": 0, "K2": 0.0, "K5/reduced": 0.0,
             "K3": 0.0}
    for fast in (False, True):
        p = cuda_scan.openness_counts_torch(Zd, threshold_angle=1.0,
                                            fast=fast, **kw)
        outs = {}
        for kid, fn in (("K1", cuda_scan.openness_counts_cuda),
                        ("K5/counts", cuda_scan.openness_counts_plan_cuda)):
            for tiled, ctx in tiled_runs(cuda_scan):
                with ctx():
                    outs[kid, tiled] = fn(Zd, threshold_angle=1.0, fast=fast,
                                          out=unwritten(Zd), **kw)
                torch.cuda.synchronize()
                err = max(int((a.int() - b.int()).abs().max())
                          for a, b in zip(outs[kid, tiled], p))
                check(err == 0, f"{kid} counts at 8192^2 fast={fast} (tile "
                                f"path {'on' if tiled else 'off'}): kernel "
                                f"!= plain (max |diff| {err})")
                worst[kid] = max(worst[kid], err)
        check(all(torch.equal(a, b) for a, b in zip(outs["K1", True],
                                                    outs["K5/counts", True])),
              f"K1 and K5 counts differ at 8192^2 fast={fast}")
        del p, outs
    variants = [("openness", False, {}), ("svf", False, {}),
                ("ternary", False, {"threshold_angle": 1.0}),
                ("openness", True, {})]
    for mode, fast, extra in variants:
        mkw = dict(kw, fast=fast, **extra)
        p = cuda_scan.openness_reduced_torch(Zd, mode, **mkw)
        outs = {}
        for kid, fn in (("K2", cuda_scan.openness_reduced_cuda),
                        ("K5/reduced", cuda_scan.openness_reduced_plan_cuda)):
            for tiled, ctx in tiled_runs(cuda_scan):
                with ctx():
                    k = fn(Zd, mode, out=unwritten_reduced(Zd, mode), **mkw)
                torch.cuda.synchronize()
                label = f"{kid} (tile path {'on' if tiled else 'off'})"
                worst[kid] = max(worst[kid], reduced_err(
                    cuda_scan, mode, k, p,
                    f"{label} {mode} fast={fast} at 8192^2"))
                outs[label] = k
        reduced_identical(outs, f"{mode} fast={fast} at 8192^2")
        del p, outs, k
    p = cuda_scan.directional_extrema_torch(Zd, **kw)
    for tiled, ctx in tiled_runs(cuda_scan):
        with ctx():
            k = cuda_scan.directional_extrema_cuda(
                Zd, out=unwritten_planes(Zd), **kw)
        torch.cuda.synchronize()
        state = "on" if tiled else "off"
        worst["K3"] = max(worst["K3"], planes_equal(
            k, p, f"K3 planes at 8192^2 (tile path {state})"))
        del k
    del p
    emit(phase="full_size_vs_plain", shape=list(Zd.shape),
         lookup=MAIN_LOOKUP, max_abs_err=worst)
    return worst


def oracle_check(ntt, dev):
    """The repo's own oracles on the card: the J&S micro-morphologies,
    the f64 numpy geomorphon loop (classes may differ from it only at
    f32 decision ties, margin < 2e-3 deg), and the f64 numpy openness
    and skyview loops (within 2e-4 deg and 2e-6, tests/test_visibility.py's
    tolerances)."""
    sys.path.insert(0, str(HERE))
    from tests.reference_impls import (np_geomorphons, np_openness,
                                       np_skyview_factor)
    micro = [([[1, 1, 1], [1, 2, 1], [1, 1, 1]], 2),
             ([[0, 0, 0], [2, 1, 2], [2, 2, 2]], 7),
             ([[1, 1, 1], [1, 0, 1], [1, 1, 1]], 10),
             ([[0, 0, 0], [1, 1, 1], [2, 2, 2]], 6),
             ([[0, 1, 2], [2, 1, 0], [0, 1, 2]], 6),
             ([[1, 1, 1], [1, 1, 1], [1, 1, 1]], 1)]
    for Zm, code in micro:
        G = ntt.geomorphons(np.array(Zm, dtype=float), lookup_pixels=1,
                            device=dev)
        check(int(G[1, 1]) == code, f"micro-morphology {Zm} -> {code}")
    Z64 = bench_input((192, 256)).astype(np.float64)
    flips = 0
    for enhance, fast in ((False, False), (True, False), (False, True)):
        ref, margin = np_geomorphons(Z64, cellsize=10, lookup_pixels=50,
                                     threshold_angle=1, enhance=enhance,
                                     fast=fast, return_margin=True)
        G = ntt.geomorphons(Z64, cellsize=10, lookup_pixels=50,
                            threshold_angle=1, enhance=enhance, fast=fast,
                            device=dev).cpu().numpy()
        diff = G != ref
        flips += int(diff.sum())
        check(not diff.any() or margin[diff].max() < 2e-3,
              f"non-tie disagreement with the f64 oracle (enhance={enhance}"
              f", fast={fast})")
    kw = dict(cellsize=10, lookup_pixels=50)
    o_err = float(np.abs(ntt.openness(Z64, device=dev, **kw).cpu().numpy()
                         - np_openness(Z64, **kw)).max())
    check(o_err <= ORACLE_OPENNESS_TOL,
          f"openness vs the f64 oracle: {o_err} above {ORACLE_OPENNESS_TOL}")
    s_err = float(np.abs(ntt.skyview_factor(Z64, device=dev, **kw).cpu()
                         .numpy() - np_skyview_factor(Z64, **kw)).max())
    check(s_err <= ORACLE_SVF_TOL,
          f"skyview vs the f64 oracle: {s_err} above {ORACLE_SVF_TOL}")
    emit(phase="oracle", micro_morphologies=len(micro),
         f64_oracle_tie_flips=flips, openness_max_abs_err_deg=o_err,
         openness_tol_deg=ORACLE_OPENNESS_TOL, skyview_max_abs_err=s_err,
         skyview_tol=ORACLE_SVF_TOL)


def write_dem(ntt, tmp):
    """The reference-scale DEM as a GeoTIFF (set-up, not timed)."""
    H, _ = MAIN_SHAPE
    Z = bench_input(MAIN_SHAPE)
    dem = str(Path(tmp) / "dem.tif")
    ntt.imwrite(dem, Z, {"transform": ntt.from_origin(0.0, 10.0 * H, 10, 10),
                         "crs": 32633, "nodata": None})
    return Z, dem


def main_path(ntt, cuda_scan, dev, tmp, Z, dem):
    """Phase 4: GeoTIFF -> imread -> geomorphons (exact, enhance, fast)
    -> imwrite at 8192^2.  The exact calls take K5's static plan, the
    fast one K1's dynamic route, as ``specialize=None`` resolves."""
    out = str(Path(tmp) / "classes.tif")
    torch.cuda.synchronize()

    reset_counts(cuda_scan)
    t0 = time.perf_counter()
    Zr, meta = ntt.imread(dem)
    kw = dict(cellsize=meta["cellsize"], lookup_pixels=MAIN_LOOKUP,
              threshold_angle=1, device=dev)
    G = ntt.geomorphons(Zr, **kw)
    G_enh = ntt.geomorphons(Zr, enhance=True, **kw)
    G_fast = ntt.geomorphons(Zr, fast=True, **kw)
    ntt.imwrite(out, G, meta, colormap=ntt.geomorphon_cmap())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(cuda_scan)

    # geomorphons' default route on the card is the JAX package's:
    # K5's static plan for the exact ladder, K1's dynamic route for fast
    want = {k: 0 for k in counts}
    want.update({"K5/counts": 3, "K1": 1})
    check(counts == want, f"main path launched {counts}, expected K5/counts"
                          " x 3 (exact, enhance x2) and K1 x 1 (fast)")
    check(np.array_equal(Zr, Z), "GeoTIFF read-back differs from the DEM")
    check(meta["cellsize"] == 10.0, "cellsize lost in the GeoTIFF")
    Zd = torch.from_numpy(Zr).to(dev)
    for name, got, extra in (("exact", G, {}), ("enhance", G_enh,
                                               {"enhance": True}),
                             ("fast", G_fast, {"fast": True})):
        check(got.shape == MAIN_SHAPE and got.dtype == torch.uint8
              and got.is_cuda, f"{name}: classes shape/dtype/device")
        check(int(got.min()) >= 1 and int(got.max()) <= 10,
              f"{name}: classes outside 1..10")
        plain = ntt.geomorphons(Zd, engine="torch", **kw, **extra)
        check(torch.equal(got, plain), f"{name}: kernel classes != plain")
    back, _ = ntt.imread(out)
    check(np.array_equal(back, G.cpu().numpy()), "classes.tif read-back")
    hist = torch.bincount(G.flatten().long(), minlength=11)[1:].tolist()
    emit(phase="main_path", shape=list(MAIN_SHAPE), lookup=MAIN_LOOKUP,
         launches_by_kernel=counts, wall_s=wall, class_histogram=hist)
    return Zd, counts, G, G_fast


def openness_path(ntt, cuda_scan, dev, tmp, Z, dem):
    """Phase 5: GeoTIFF -> imread -> openness_pair (exact, then fast) ->
    skyview_factor -> ternary codes (lowest) -> openness over neighbours 1
    and 5 -> geomorphons2 without negative openness (PNG + worldfile) ->
    imwrite of the positive openness, at 8192^2, lookup 50."""
    png = str(Path(tmp) / "geomorphons2.png")
    out = str(Path(tmp) / "openness.tif")
    torch.cuda.synchronize()

    reset_counts(cuda_scan)
    t0 = time.perf_counter()
    Zr, meta = ntt.imread(dem)
    Zd = torch.from_numpy(Zr).to(dev)
    kw = dict(cellsize=meta["cellsize"], lookup_pixels=MAIN_LOOKUP)
    pos, neg = ntt.openness_pair(Zd, **kw)
    fpos, fneg = ntt.openness_pair(Zd, fast=True, **kw)
    svf = ntt.skyview_factor(Zd, **kw)
    codes = ntt.ternary_pattern_from_openness(Zd, lowest=True, **kw)
    o15 = ntt.openness(Zd, neighbors=[1, 5], **kw)
    G2 = ntt.geomorphons2(Zd, use_negative_openness=False, outfile=png,
                          out_transform=meta["transform"], **kw)
    ntt.imwrite(out, pos, meta)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(cuda_scan)

    want = {k: 0 for k in counts}
    want.update({"K5/reduced": 3, "K2": 1, "K3": 2})
    check(counts == want,
          f"openness path launched {counts}, expected K5/reduced x 3 (pair, "
          "skyview, ternary), K2 x 1 (fast pair) and K3 x 2 (neighbours, "
          "geomorphons2)")
    check(np.array_equal(Zr, Z), "GeoTIFF read-back differs from the DEM")
    for name, t in (("pos", pos), ("neg", neg), ("fast pos", fpos),
                    ("fast neg", fneg), ("svf", svf),
                    ("openness[1,5]", o15)):
        check(t.shape == MAIN_SHAPE and t.dtype == torch.float32
              and t.is_cuda and bool(torch.isfinite(t).all()),
              f"{name}: shape/dtype/device or a non-finite value")
    check(float(pos.min()) >= 0 and float(pos.max()) <= 180
          and float(neg.min()) >= 0 and float(neg.max()) <= 180,
          "openness outside 0..180 degrees")
    check(float(svf.min()) >= 0 and float(svf.max()) <= 1,
          "skyview factor outside 0..1")
    check(codes.dtype == torch.uint16 and int(codes.int().max()) <= 6560,
          "ternary codes: dtype or range")
    check(int(G2.min()) >= 1 and int(G2.max()) <= 10,
          "geomorphons2 classes outside 1..10")

    plain = dict(engine="torch", **kw)
    errs = {}
    pp, pn = ntt.openness_pair(Zd, **plain)
    errs["openness_pair_deg"] = max(
        float_err(pos, pp, OPENNESS_TOL, "openness_pair pos"),
        float_err(neg, pn, OPENNESS_TOL, "openness_pair neg"))
    pp, pn = ntt.openness_pair(Zd, fast=True, **plain)
    errs["openness_pair_fast_deg"] = max(
        float_err(fpos, pp, OPENNESS_TOL, "openness_pair fast pos"),
        float_err(fneg, pn, OPENNESS_TOL, "openness_pair fast neg"))
    del pp, pn, fpos, fneg
    errs["skyview"] = float_err(svf, ntt.skyview_factor(Zd, **plain),
                                SVF_TOL, "skyview_factor")
    check(torch.equal(codes.int(), ntt.ternary_pattern_from_openness(
        Zd, lowest=True, **plain).int()), "ternary codes != plain")
    check(torch.equal(o15, ntt.openness(Zd, neighbors=[1, 5], **plain)),
          "openness over neighbours 1, 5 != plain")
    check(torch.equal(G2, ntt.geomorphons2(
        Zd, use_negative_openness=False, **plain)), "geomorphons2 != plain")
    from PIL import Image
    with Image.open(png) as im:
        check(np.array_equal(np.asarray(im), G2.cpu().numpy()),
              "geomorphons2 PNG read-back")
    check(Path(png[:-3] + "pgw").is_file(), "geomorphons2 worldfile")
    back, _ = ntt.imread(out)
    check(back.dtype == np.float32 and np.array_equal(back, pos.cpu().numpy()),
          "openness.tif read-back")
    emit(phase="openness_path", shape=list(MAIN_SHAPE), lookup=MAIN_LOOKUP,
         launches_by_kernel=counts, wall_s=wall, max_abs_err=errs,
         mean_openness_deg=float(pos.double().mean()),
         mean_skyview=float(svf.double().mean()),
         class_histogram=torch.bincount(G2.flatten().long(),
                                        minlength=11)[1:].tolist())
    return counts


def sharded_path(ntt, cuda_scan, dev, Zd, G, G_fast):
    """Phase 6: the mesh-sharded path at 8192^2, lookup 50, threshold 1,
    against the single-device classes ``G`` / ``G_fast`` of the main
    path: ``sharded_geomorphons`` on ``make_mesh()`` and on a 2 x 2 mesh
    naming this card four times (K4 once per block, K1 never), then
    ``sharded_openness`` / ``sharded_skyview`` on the 2 x 2 mesh (K3's
    origin entry once per block) against ``openness`` /
    ``skyview_factor``; then K4 and K3's origin entry against their plain
    versions on the mesh's blocks (uncounted); last, small multi-hop and
    non-divisible cases on a 2 x 4 mesh of this card."""
    dist = ntt.dist
    kw = dict(cellsize=10.0, lookup_pixels=MAIN_LOOKUP)
    visible = dist.make_mesh()
    mesh = dist.make_mesh([dev] * 4)
    check(visible.devices.size == torch.cuda.device_count()
          and mesh.devices.shape == (2, 2), "mesh shapes")
    calls = [("make_mesh() exact", lambda: dist.sharded_geomorphons(
                 Zd, visible, threshold_angle=1, **kw), G, "K4"),
             ("2x2 exact", lambda: dist.sharded_geomorphons(
                 Zd, mesh, threshold_angle=1, **kw), G, "K4"),
             ("2x2 fast", lambda: dist.sharded_geomorphons(
                 Zd, mesh, threshold_angle=1, fast=True, **kw), G_fast, "K4"),
             ("2x2 openness", lambda: dist.sharded_openness(Zd, mesh, **kw),
              None, "K3"),
             ("2x2 skyview", lambda: dist.sharded_skyview(Zd, mesh, **kw),
              None, "K3")]
    torch.cuda.synchronize()

    reset_counts(cuda_scan)
    t0 = time.perf_counter()
    outs, per_call = [], []
    for name, call, _, _ in calls:
        before = read_counts(cuda_scan)
        outs.append(call())
        after = read_counts(cuda_scan)
        per_call.append({k: after[k] - before[k] for k in after})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(cuda_scan)

    for (name, _, want, kid), out, delta in zip(calls, outs, per_call):
        n_blocks = (visible if name.startswith("make_mesh") else mesh).devices.size
        others = {k: v for k, v in delta.items() if k != kid}
        check(delta[kid] == n_blocks and not any(others.values()),
              f"{name}: launched {delta}, expected {kid} x {n_blocks} only")
        check(out.shape == MAIN_SHAPE and out.is_cuda, f"{name}: shape/device")
        if want is not None:
            check(torch.equal(out, want), f"{name}: != single-device classes")
    errs = {
        "openness_deg": float_err(outs[3], ntt.openness(Zd, **kw),
                                  SHARDED_OPENNESS_TOL, "sharded_openness"),
        "skyview": float_err(outs[4], ntt.skyview_factor(Zd, **kw), SVF_TOL,
                             "sharded_skyview")}
    del outs
    block_errs = mesh_blocks_vs_plain(cuda_scan, dist, Zd, mesh)

    mesh8 = dist.make_mesh([dev] * 8, shape=(2, 4))
    small = 0
    for shape, lk in (((16, 32), 12), ((16, 32), 30), ((45, 53), 3)):
        Zs = torch.from_numpy(np.random.default_rng(0).normal(size=shape)
                              .cumsum(axis=0).astype(np.float32)).to(dev)
        got = dist.sharded_geomorphons(Zs, mesh8, lookup_pixels=lk)
        check(torch.equal(got, ntt.geomorphons(Zs, lookup_pixels=lk)),
              f"sharded {shape} lookup={lk} on 2x4 != single-device")
        small += 1
    emit(phase="sharded_path", shape=list(MAIN_SHAPE), lookup=MAIN_LOOKUP,
         meshes={"make_mesh()": list(visible.devices.shape),
                 "one card": list(mesh.devices.shape)},
         launches_by_kernel=counts, launches_by_call=dict(
             zip([c[0] for c in calls], per_call)),
         wall_s=wall, classes_equal_single_device=True, max_abs_err=errs,
         small_cases_equal=small)
    return counts, mesh, block_errs


def mesh_blocks_vs_plain(cuda_scan, dist, Zd, mesh):
    """K4 (both ladders) and K3's origin entry, tile path on and off,
    against their plain versions on every haloed block of the 2 x 2 mesh
    at 8192^2, lookup 50, the shapes and origins the sharded path gives
    them (4196^2 blocks, cores at (0 | 4096, 0 | 4096)), written into
    outputs pre-filled with a value they never write: counts and extrema
    planes exact.  The blocks must take the TMA load (contiguous, 16-byte
    aligned, 4196 floats wide), as ``halo_exchange_2d`` makes them."""
    from neilpy_tpu_torch.dist.halo import _shard, halo_exchange_2d
    R = MAIN_LOOKUP
    H, W = Zd.shape
    ny, nx = mesh.devices.shape
    bshape = (H // ny, W // nx)
    blocks = halo_exchange_2d(_shard(Zd, mesh.devices), R, "nan")
    k4 = k3 = n4 = n3 = 0
    loads = set()
    for y, row in enumerate(blocks):
        for x, block in enumerate(row):
            oy, ox = dist.block_origin(bshape, (y, x))
            where = f"2x2 block {(y, x)} at origin {(oy, ox)}"
            args = (block, (oy, ox), (H, W), R)
            for fast in (False, True):
                kw = dict(cellsize=10.0, threshold_angle=1.0, fast=fast)
                p = cuda_scan.openness_counts_block_torch(*args, **kw)
                for tiled, ctx in tiled_runs(cuda_scan):
                    with ctx():
                        k = cuda_scan.openness_counts_block_cuda(
                            *args, out=unwritten(block, bshape), **kw)
                    err = max(int((a.int() - b.int()).abs().max())
                              for a, b in zip(k, p))
                    check(err == 0, f"K4 on {where} fast={fast} (tile path "
                                    f"{'on' if tiled else 'off'}): kernel "
                                    f"!= plain (max |diff| {err})")
                    k4 = max(k4, err)
                    n4 += 1
                loads.add(tile_case(cuda_scan, np.zeros(bshape, bool), block,
                                    R, fast, **cuda_scan._block_tiles(*args)))
            kw = dict(cellsize=10.0, lookup_pixels=R, origin=(oy - R, ox - R),
                      global_shape=(H, W))
            p = cuda_scan.directional_extrema_torch(block, **kw)
            for tiled, ctx in tiled_runs(cuda_scan):
                with ctx():
                    k = cuda_scan.directional_extrema_cuda(
                        block, out=unwritten_planes(block), **kw)
                state = "on" if tiled else "off"
                k3 = max(k3, planes_equal(
                    k, p, f"K3 origin entry on {where} (tile path {state})"))
                n3 += 1
                del k
            loads.add(tile_case(cuda_scan, np.zeros(block.shape, bool), block,
                                R, False, origin=kw["origin"],
                                global_shape=(H, W)))
            del p
    check(loads == {("tma", False)},
          f"the 2x2 blocks' tile launches took {loads}, expected TMA")
    emit(phase="kernel_vs_plain", kernel="K4", cases=n4, max_abs_err=k4,
         at="every 2x2 mesh block, 8192^2, lookup 50, tile path on and off",
         tile_load="tma")
    emit(phase="kernel_vs_plain", kernel="K3 origin entry", cases=n3,
         max_abs_err=k3, tile_load="tma",
         at="every 2x2 mesh block, 8192^2, lookup 50, tile path on and off")
    return {"K4": k4, "K3": k3}


def sharded_blocks(Zd, mesh):
    """The haloed blocks the timings and the kernel table use: block (0, 0)
    of the 2 x 2 ``mesh`` (a 4096^2 core at (0, 0) with its halo, 4196^2)
    and ``make_mesh()``'s block on one card (the whole raster with its
    halo, 8292^2), as ``halo_exchange_2d`` makes them."""
    from neilpy_tpu_torch.dist.halo import _shard, halo_exchange_2d
    return (halo_exchange_2d(_shard(Zd, mesh.devices), MAIN_LOOKUP,
                             "nan")[0][0],
            halo_exchange_2d([[Zd]], MAIN_LOOKUP, "nan")[0][0])


def time_turns(fns, call):
    """CUDA-event ms of ``TIMED_RUNS`` runs of each ``fns[key]`` through
    ``call``, in turns (plain, kernel, kernel, plain, ...) after one
    warm-up each."""
    keys = list(fns)
    times = {k: [] for k in keys}
    for key in keys:
        call(fns[key])
    torch.cuda.synchronize()
    for rep in range(TIMED_RUNS):
        for key in (keys if rep % 2 == 0 else keys[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            call(fns[key])
            stop.record()
            stop.synchronize()
            times[key].append(start.elapsed_time(stop))
    return times


@contextlib.contextmanager
def _switched(cuda_scan, name, value):
    """Within the block, the module switch ``name`` of ``cuda_scan`` holds
    ``value``."""
    saved = getattr(cuda_scan, name)
    setattr(cuda_scan, name, value)
    try:
        yield
    finally:
        setattr(cuda_scan, name, saved)


def all_masked(cuda_scan):
    """The kernels' route mask is 0, so K1-K5 run the masked ladder in
    every direction, as the kernels did before the maskless ladder: a
    same-call baseline for the routes."""
    return _switched(cuda_scan, "_ALLOW_MASKLESS", 0)


def per_thread(cuda_scan):
    """The tile path is off, so every kernel (K1, K2, K3, K4, K5 for the
    counts and the reductions) runs every block on its per-thread bodies,
    as it did before the tile: a same-call baseline for the tile path."""
    return _switched(cuda_scan, "_ALLOW_TILE", False)


def timings(ntt, cuda_scan, Zd, mesh, card, share):
    """Phase 7: median of CUDA-event times, in turns, at 8192^2, lookup 50:
    the plain version, the kernel with every block on the masked ladder
    (``all_masked``), the dynamic route (K1-K4) and K5's static plan (K1,
    K2), for K1 (both ladders), K2 (each mode, and openness on the fast
    ladder), K3 (whole raster, and its origin entry on block (0, 0) of the
    2 x 2 mesh, 4196^2) and K4 (that block's 4096^2 core on both ladders,
    and ``make_mesh()``'s 1 x 1 block on one card, 8292^2); K1, K2, K3 and
    K4 also ``per_thread``, the dynamic (and K1's and K2's static) kernels
    with the tile path off; each route must take under ``ROUTE_GAIN`` of
    the all-masked time, which
    shows the kernels take the maskless ladder (``share`` is the host's
    route table's share, printed beside it), and each tile route under
    ``TILE_GAIN`` of its per-thread time, which shows the tile path runs;
    K5/counts at lookup 12, the enhance pass's second launch, the same
    way; the ``geomorphons`` call with the tile path on and off; then the
    halo exchange alone and the ``sharded_geomorphons`` call on the
    one-card 2 x 2 mesh against the single-device ``geomorphons``."""
    H, W = Zd.shape
    base = dict(cellsize=10.0, lookup_pixels=MAIN_LOOKUP)
    res = {}

    def record(kernel, label, times, shape=(H, W), lookup=MAIN_LOOKUP,
               **extra):
        """``shape``: the output pixels one run makes."""
        for impl, ts in times.items():
            ms = statistics.median(ts)
            res[(kernel, label, impl)] = ms
            emit(phase="timing", kernel=kernel, impl=impl, **extra,
                 shape=list(shape), lookup=lookup, runs=ts, median_ms=ms,
                 mpix_per_s=shape[0] * shape[1] / ms / 1e3, card=card)

    def under(switch, fn):
        def switched(*args, **kw):
            with switch(cuda_scan):
                return fn(*args, **kw)
        return switched

    def routes(plain, dynamic, static=None, tiled=False):
        """The implementations to time in turns: the masked one runs the
        dynamic kernel with the route mask 0; ``tiled``: the per-thread
        ones run the dynamic and static kernels with the tile path off."""
        fns = {"plain": plain, "masked": under(all_masked, dynamic),
               "dynamic": dynamic}
        if static is not None:
            fns["static"] = static
        if tiled:
            fns["per_thread"] = under(per_thread, dynamic)
            if static is not None:
                fns["static_per_thread"] = under(per_thread, static)
        return fns

    for fast in (False, True):
        ladder = "fast" if fast else "exact"
        record("K1", ladder, time_turns(
            routes(cuda_scan.openness_counts_torch,
                   cuda_scan.openness_counts_cuda,
                   cuda_scan.openness_counts_plan_cuda, tiled=True),
            lambda fn: fn(Zd, threshold_angle=1.0, fast=fast, **base)),
            ladder=ladder)
    # the enhance pass's second launch: K5/counts at lookup 12
    k5 = cuda_scan.openness_counts_plan_cuda
    record("K5/counts", "lookup12", time_turns(
        {"plain": cuda_scan.openness_counts_torch,
         "masked": under(all_masked, k5), "static": k5,
         "static_per_thread": under(per_thread, k5)},
        lambda fn: fn(Zd, threshold_angle=1.0, cellsize=10.0,
                      lookup_pixels=ENHANCE_LOOKUP)),
        ladder="exact", lookup=ENHANCE_LOOKUP)
    for mode, fast in (("openness", False), ("svf", False),
                       ("ternary", False), ("openness", True)):
        ladder = "fast" if fast else "exact"
        record("K2", f"{mode}/{ladder}", time_turns(
            routes(cuda_scan.openness_reduced_torch,
                   cuda_scan.openness_reduced_cuda,
                   cuda_scan.openness_reduced_plan_cuda, tiled=True),
            lambda fn: fn(Zd, mode, threshold_angle=1.0, fast=fast, **base)),
            mode=mode, ladder=ladder)
    k3 = routes(cuda_scan.directional_extrema_torch,
                cuda_scan.directional_extrema_cuda, tiled=True)
    record("K3", "exact", time_turns(k3, lambda fn: fn(Zd, **base)),
           ladder="exact")

    from neilpy_tpu_torch.dist.halo import _shard, halo_exchange_2d
    grid = mesh.devices
    R = MAIN_LOOKUP
    block, one = sharded_blocks(Zd, mesh)
    record("K3", "origin", time_turns(
        k3, lambda fn: fn(block, origin=(-R, -R), global_shape=(H, W),
                          **base)),
        shape=tuple(block.shape), ladder="exact", block=list(block.shape))
    k4 = routes(cuda_scan.openness_counts_block_torch,
                cuda_scan.openness_counts_block_cuda, tiled=True)
    for fast in (False, True):
        ladder = "fast" if fast else "exact"
        record("K4", ladder, time_turns(
            k4, lambda fn: fn(block, (0, 0), (H, W), threshold_angle=1.0,
                              fast=fast, **base)),
            shape=(H // 2, W // 2), ladder=ladder, block=list(block.shape))
    res["K4 block"] = tuple(block.shape)
    record("K4", "1x1", time_turns(
        k4, lambda fn: fn(one, (0, 0), (H, W), threshold_angle=1.0,
                          **base)),
        ladder="exact", block=list(one.shape))
    res["K4 1x1 block"] = tuple(one.shape)
    del block, one
    ratios, tile_ratios = {}, {}
    baseline = {"dynamic": "per_thread", "static": "static_per_thread"}
    for key, ms in res.items():
        if isinstance(key, tuple) and key[2] not in ("plain", "masked"):
            ratios[" ".join(key)] = ms / res[(*key[:2], "masked")]
            base_key = (*key[:2], baseline.get(key[2]))
            if base_key in res:
                tile_ratios[" ".join(key)] = ms / res[base_key]
    emit(phase="route_gain", over="all-masked launch, same run",
         ratio=ratios, limit=ROUTE_GAIN, host_maskless_share=share,
         tile_over_per_thread=tile_ratios, tile_limit=TILE_GAIN)
    check(max(ratios.values()) < ROUTE_GAIN,
          f"a route is not well below its all-masked time: {ratios}")
    check(max(tile_ratios.values()) < TILE_GAIN,
          f"a tile route is not well below its per-thread time: "
          f"{tile_ratios}")
    record("halo", "exchange", time_turns(
        {"2x2": lambda: halo_exchange_2d(_shard(Zd, grid), MAIN_LOOKUP,
                                         "nan")},
        lambda fn: fn()), what="halo_exchange_2d, 2x2 mesh on one card")
    gkw = dict(threshold_angle=1, **base)
    record("geomorphons", "tile", time_turns(
        {"tile": lambda: ntt.geomorphons(Zd, **gkw),
         "per_thread": under(per_thread, lambda: ntt.geomorphons(Zd, **gkw))},
        lambda fn: fn()), what="call, exact: K5/counts tile path on vs off")
    record("geomorphons", "wall", time_turns(
        {"single": lambda: ntt.geomorphons(Zd, **gkw),
         "sharded": lambda: ntt.dist.sharded_geomorphons(Zd, mesh, **gkw)},
        lambda fn: fn()), what="call, 2x2 mesh on one card vs one device")
    return res


def tile_launch(cuda_scan, Zd, lookup, fast, plan=False, **geometry):
    """What a launch on the array ``Zd`` gives its tile kernel: the tile
    arguments the wrapper passes (``cuda_scan._tile_args``; K4 and K3's
    origin entry with the block's ``geometry``), the dynamic shared memory
    of one tile CTA as the library computes it for the launch
    (``ladder_tile_smem_bytes``), and the share of the grid's pixels (K4:
    the core's) in the tiles.  The host model ``cuda_scan.tile_route``
    must agree."""
    from neilpy_tpu_torch import _build
    ladder = cuda_scan._ladder(lookup, fast)
    halo, ty0, ty1, tx0, tx1, tma = cuda_scan._tile_args(
        Zd, ladder[-1], len(ladder), plan, **geometry)
    check(halo > 0, f"no tile at lookup {lookup} fast={fast} {geometry}")
    smem = int(_build.load().ladder_tile_smem_bytes(halo, ladder[-1],
                                                    len(ladder)))
    model = cuda_scan.tile_route(*Zd.shape, ladder[-1], plan, len(ladder),
                                 **geometry)
    check(smem == model.smem_bytes and (halo, (ty0, ty1), (tx0, tx1))
          == model[:3], f"tile launch {smem} B {halo} {(ty0, ty1, tx0, tx1)}"
                        f" != host model {model}")
    th, tw = cuda_scan.TILE
    grid = geometry.get("core") or Zd.shape
    return {"smem_bytes": smem, "tile_load": "tma" if tma else "cp.async",
            "tile_share": (ty1 - ty0) * th * (tx1 - tx0) * tw
            / (grid[0] * grid[1])}


def kernel_table(cuda_scan, res, launches, max_err, Zd, blocks):
    """The ``kernels`` line: per kernel its launches on its path, its
    error against the plain version, its time and the plain version's at
    8192^2, lookup 50, on the ladder and route its path runs (K1 and K2:
    the fast ladder, dynamic route; K3, K4 and K5: the exact ladder; K4
    per 4096^2 core of a 2 x 2 block), and its bound from this run's
    shapes (K2 and K5/reduced: the ladder and the fold, ``fold_ops``); the
    other ladder's and route's times are extra fields.  Every kernel gives
    its per-thread time (the tile path off), a tile CTA's shared memory,
    the share of pixels in tiles and the load path, as its launches get
    them (``tile_launch``; K3 on ``Zd``, K4 on the 2 x 2 mesh's block
    (0, 0) of ``blocks``); K2 and K5/reduced also each mode's times and
    bounds on the exact ladder; K5/counts also its
    lookup-12 launch, K3 its origin entry on that block (``origin_entry``),
    K4 its fast-ladder launch on it (``fast``) and its launch on
    ``make_mesh()``'s 1 x 1 block (``one_by_one``).  No single PyTorch call
    computes these functions, so ``library_ms`` is null."""
    H, W = MAIN_SHAPE
    R = MAIN_LOOKUP
    px = H * W
    exact, fast = cuda_scan._ladder(R), cuda_scan._ladder(R, True)
    steps = {"exact": ladder_steps(H, W, exact),
             "fast": ladder_steps(H, W, fast)}
    bh, bw = H // 2, W // 2
    Hh, Wh = res["K4 block"]
    counts_bytes = 4 * px + 2 * px     # input once, outputs once
    # input once, the mode's outputs once: two f32 sums, one, a uint16 code
    reduced_bytes = {"openness": 12 * px, "svf": 8 * px, "ternary": 6 * px}
    block_bytes = 4 * Hh * Wh + 2 * bh * bw
    rows = [
        # id, source name, TPU kernel line, timing key, route, ladder,
        # bound (steps, bytes, fold operations)
        ("K1", "openness_counts", 401, ("K1", "fast"), "dynamic",
         (steps["fast"], counts_bytes, 0)),
        ("K2", "openness_reduced", 856, ("K2", "openness/fast"), "dynamic",
         (steps["fast"], reduced_bytes["openness"],
          fold_ops("openness", px))),
        ("K3", "directional_extrema", 292, ("K3", "exact"), "dynamic",
         (steps["exact"], 4 * px + 64 * px, 0)),
        ("K4", "openness_counts_block", 1121, ("K4", "exact"), "dynamic",
         (ladder_steps(Hh, Wh, exact, core=(bh, bw)), block_bytes, 0)),
        ("K5/counts", "openness_counts_plan", 774, ("K1", "exact"),
         "static", (steps["exact"], counts_bytes, 0)),
        ("K5/reduced", "openness_reduced_plan", 774,
         ("K2", "openness/exact"), "static",
         (steps["exact"], reduced_bytes["openness"],
          fold_ops("openness", px))),
    ]
    kernels = []
    for kid, name, line, key, route, (n_steps, nbytes, fold) in rows:
        bound_ms, side = bound(n_steps, nbytes, fold)
        kernels.append({
            "name": name, "id": kid, "route": "cuda",
            "source": f"neilpy_tpu_torch/csrc/{name}.cu",
            "replaces": f"neilpy_tpu/ops/pallas_scan.py:{line}",
            "launches": launches[kid], "max_abs_err": max_err[kid],
            "ms": res[(*key, route)], "plain_ms": res[(*key, "plain")],
            "bound_ms": bound_ms, "bound_by": side, "library_ms": None,
            "ladder": key[1].split("/")[-1], "masked_ms": res[(*key,
                                                              "masked")]})
    routes = ("plain", "masked", "dynamic", "static", "per_thread",
              "static_per_thread")
    modes = ("openness", "svf", "ternary")
    kernels[0]["exact"] = {"ms": {r: res[("K1", "exact", r)]
                                  for r in routes},
                           "bound_ms": bound(steps["exact"],
                                             counts_bytes)[0]}
    tile_source = "neilpy_tpu_torch/csrc/ladder_tile.cuh"
    reduced_tile_source = "neilpy_tpu_torch/csrc/openness_reduced_tile.cu"
    for k, kid, fast_, plan, impl in (
            (0, "K1", True, False, "per_thread"),
            (4, "K1", False, True, "static_per_thread"),
            (1, "K2", True, False, "per_thread"),
            (5, "K2", False, True, "static_per_thread")):
        key = (kid, ("fast" if fast_ else "exact") if kid == "K1" else
               f"openness/{'fast' if fast_ else 'exact'}", impl)
        kernels[k].update(
            per_thread_ms=res[key],
            **tile_launch(cuda_scan, Zd, R, fast_, plan),
            tile_source=tile_source if kid == "K1" else reduced_tile_source)
    lk12 = {r: res[("K5/counts", "lookup12", r)]
            for r in ("plain", "masked", "static", "static_per_thread")}
    kernels[4]["lookup12"] = dict(
        ms=lk12["static"], per_thread_ms=lk12["static_per_thread"],
        masked_ms=lk12["masked"], plain_ms=lk12["plain"],
        bound_ms=bound(ladder_steps(H, W, cuda_scan._ladder(ENHANCE_LOOKUP)),
                       counts_bytes)[0],
        **tile_launch(cuda_scan, Zd, ENHANCE_LOOKUP, False, True))
    # each mode on the exact ladder: the fold of ternary with neg_mode,
    # as the timings and the path run it; svf reads only each direction's
    # mx, so its ladder needs no min (the compiled kernel drops it too)
    exact_reduced_bound = {m: bound(
        steps["exact"], reduced_bytes[m], fold_ops(m, px),
        OPS_PER_STEP - (m == "svf"))[0] for m in modes}
    kernels[1]["exact"] = {
        "ms_by_mode": {m: {r: res[("K2", f"{m}/exact", r)] for r in routes}
                       for m in modes},
        "bound_ms_by_mode": exact_reduced_bound}
    kernels[1]["fast_static_ms"] = res[("K2", "openness/fast", "static")]
    kernels[0]["fast_static_ms"] = res[("K1", "fast", "static")]
    kernels[5]["ms_by_mode"] = {m: res[("K2", f"{m}/exact", "static")]
                                for m in modes}
    kernels[5]["per_thread_ms_by_mode"] = {
        m: res[("K2", f"{m}/exact", "static_per_thread")] for m in modes}
    kernels[5]["bound_ms_by_mode"] = exact_reduced_bound

    def timed(key):
        """A launch's times: its tile, per-thread, masked, plain ms."""
        return {"ms": res[(*key, "dynamic")],
                "per_thread_ms": res[(*key, "per_thread")],
                "masked_ms": res[(*key, "masked")],
                "plain_ms": res[(*key, "plain")]}

    block, one = blocks
    block_geom = cuda_scan._block_tiles(block, (0, 0), (H, W), R)
    kernels[2].update(
        per_thread_ms=res[("K3", "exact", "per_thread")],
        **tile_launch(cuda_scan, Zd, R, False), tile_source=tile_source)
    kernels[2]["origin_entry"] = dict(
        launches=launches["K3 origin"], **timed(("K3", "origin")),
        bound_ms=bound(ladder_steps(Hh, Wh, exact), 4 * Hh * Wh
                       + 64 * Hh * Wh)[0],
        shape=f"one {(Hh, Wh)} haloed block of 8192^2, 2x2",
        **tile_launch(cuda_scan, block, R, False, origin=(-R, -R),
                      global_shape=(H, W)))
    kernels[3].update(
        per_thread_ms=res[("K4", "exact", "per_thread")],
        **tile_launch(cuda_scan, block, R, False, **block_geom),
        tile_source=tile_source,
        shape=f"one {(Hh, Wh)} haloed block of 8192^2, 2x2")
    kernels[3]["fast"] = dict(
        **timed(("K4", "fast")),
        bound_ms=bound(ladder_steps(Hh, Wh, fast, core=(bh, bw)),
                       block_bytes)[0],
        **tile_launch(cuda_scan, block, R, True, **block_geom))
    H1, W1 = res["K4 1x1 block"]
    kernels[3]["one_by_one"] = dict(
        **timed(("K4", "1x1")),
        bound_ms=bound(ladder_steps(H1, W1, exact, core=(H, W)),
                       4 * H1 * W1 + 2 * px)[0],
        shape=f"make_mesh()'s {(H1, W1)} haloed block, 1x1",
        **tile_launch(cuda_scan, one, R, False,
                      **cuda_scan._block_tiles(one, (0, 0), (H, W), R)))
    return kernels


# ----------------------------------------------------------------------
# the SMRF slice (plain torch ops on the card; none of K1-K5)
# ----------------------------------------------------------------------
def lidar_tile(seed, n, side, x0=500000.0, y0=4200000.0):
    """A synthetic lidar tile: ``n`` points uniform over ``side`` x
    ``side`` metres of UTM-like coordinates, on seeded rolling ground
    (slopes under ~0.12), about 10% of them on flat-roofed box buildings
    10-24 m wide and 4-15 m high, about 10% scattered canopy returns
    2-20 m above the ground, and 5 cm of noise.  Returns (x, y, z,
    building, canopy)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, side, n)
    v = rng.uniform(0, side, n)
    k = 2 * np.pi / side
    z = (100 + 0.01 * side * (np.sin(1.3 * k * u + 0.7) * np.cos(0.9 * k * v)
                              + 0.5 * np.sin(2.3 * k * v)) + 0.02 * u)
    cells = int(np.ceil(side))
    roof = np.zeros((cells, cells), np.float32)
    nb = int(0.1 * side * side / 300)
    for cx, cy, hw, hh, ht in zip(rng.uniform(0, side, nb),
                                  rng.uniform(0, side, nb),
                                  rng.uniform(5, 12, nb),
                                  rng.uniform(5, 12, nb),
                                  rng.uniform(4, 15, nb)):
        roof[max(int(cy - hh), 0):int(cy + hh),
             max(int(cx - hw), 0):int(cx + hw)] = ht
    height = roof[np.minimum(v.astype(np.int64), cells - 1),
                  np.minimum(u.astype(np.int64), cells - 1)]
    building = height > 0
    canopy = ~building & (rng.random(n) < 0.11)
    z = (z + height + np.where(canopy, rng.uniform(2, 20, n), 0.0)
         + rng.normal(0, 0.05, n))
    return x0 + u, y0 + v, z, building, canopy


# The f64 scipy SMRF oracle: a copy of tests/reference_impls.py:171-288
# (np_progressive_filter, np_spring_inpaint's direct solve,
# np_ladder_margin, np_smrf) on the port's disk and bin_points, since that
# module reaches the JAX package for them.
def np_progressive_filter(Z, windows, cellsize=1, slope_threshold=.15):
    import scipy.ndimage as ndi
    from neilpy_tpu_torch.core.codes import disk
    last = Z.copy()
    is_obj = np.zeros(Z.shape, dtype=bool)
    thresholds = slope_threshold * (np.asarray(windows) * cellsize)
    for i, w in enumerate(np.atleast_1d(windows)):
        opened = ndi.grey_erosion(last, footprint=disk(w))
        opened = ndi.grey_dilation(opened, footprint=disk(w))
        is_obj |= (last - opened) > thresholds[i]
        last = opened.copy()
    return is_obj


def np_spring_inpaint(A):
    """D'Errico method-4 springs, solved exactly: the normal equations of
    the spring least-squares problem by a direct sparse factorisation."""
    from scipy import sparse
    from scipy.sparse import linalg
    m, n = A.shape
    nanmat = np.isnan(A)
    nan_list = np.flatnonzero(nanmat)
    known_list = np.flatnonzero(~nanmat)
    r, c = np.unravel_index(nan_list, (m, n))
    offsets = np.array([[0, 1], [0, -1], [-1, 0], [1, 0]])
    nbrs = np.vstack([np.vstack((r + o[0], c + o[1])).T for o in offsets])
    springs = np.tile(nan_list, 4)
    good = (np.all(nbrs >= 0, 1)) & (nbrs[:, 0] < m) & (nbrs[:, 1] < n)
    nbr_flat = np.ravel_multi_index((nbrs[good, 0], nbrs[good, 1]), (m, n))
    springs = np.sort(np.vstack((springs[good], nbr_flat)).T, axis=1)
    springs = np.unique(springs, axis=0)
    ns = springs.shape[0]
    i = np.tile(np.arange(ns), 2)
    data = np.hstack((np.ones(ns), -np.ones(ns)))
    S = sparse.coo_matrix((data, (i, springs.T.ravel())),
                          (ns, m * n)).tocsr()
    Su = S[:, nan_list]
    rhs = -S[:, known_list] * A[np.unravel_index(known_list, (m, n))]
    res = linalg.spsolve((Su.T @ Su).tocsc(), Su.T @ rhs)
    B = A.copy()
    B[np.unravel_index(nan_list, (m, n))] = res
    return B


def np_ladder_margin(Zi, windows, cellsize=1, slope_threshold=.15):
    """Per-cell minimum |(last - opened) - threshold| across the opening
    ladder: cells at ~0 are f64 threshold ties."""
    import scipy.ndimage as ndi
    from neilpy_tpu_torch.core.codes import disk
    last = Zi.copy()
    margin = np.full(Zi.shape, np.inf)
    thresholds = slope_threshold * (np.asarray(windows) * cellsize)
    for i, w in enumerate(np.atleast_1d(windows)):
        opened = ndi.grey_erosion(last, footprint=disk(w))
        opened = ndi.grey_dilation(opened, footprint=disk(w))
        margin = np.minimum(margin,
                            np.abs((last - opened) - thresholds[i]))
        last = opened.copy()
    return margin


def np_smrf(x, y, z, cellsize, windows, slope_threshold,
            elevation_threshold, elevation_scaler, low_filter_slope=5,
            return_margin=False):
    """The full f64 SMRF oracle from scipy building blocks (groupby-style
    binning, direct-solve springs, scipy disk opening ladder, FITPACK
    RectBivariateSpline lift; reference neilpy.py:1685-1808)."""
    from scipy.interpolate import RectBivariateSpline
    from neilpy_tpu_torch.ops.pointgrid import bin_points

    windows = np.arange(windows) + 1 if np.isscalar(windows) else windows
    flat, valid, (ny, nx), t = bin_points(x, y, cellsize=cellsize)
    z64 = np.asarray(z, float)
    Zmin = np.full(ny * nx, np.inf)
    np.minimum.at(Zmin, flat[valid], z64[valid])
    Zmin[np.isinf(Zmin)] = np.nan
    Zmin = Zmin.reshape(ny, nx)
    empty = np.isnan(Zmin)
    Zmin = np_spring_inpaint(Zmin)
    low = np_progressive_filter(-Zmin, [1], cellsize, low_filter_slope)
    obj = np_progressive_filter(Zmin, windows, cellsize, slope_threshold)
    obj = obj | empty | low
    if return_margin:
        margin = np.minimum(
            np_ladder_margin(Zmin, windows, cellsize, slope_threshold),
            np_ladder_margin(-Zmin, [1], cellsize, low_filter_slope))
    Zpro = Zmin.copy()
    Zpro[obj] = np.nan
    Zpro = np_spring_inpaint(Zpro)
    c, r = (~t) * (np.asarray(x, float), np.asarray(y, float))
    ev = RectBivariateSpline(np.arange(ny) + .5, np.arange(nx) + .5,
                             Zpro).ev(r, c)
    gy, gx = np.gradient(Zpro, cellsize)
    sv = RectBivariateSpline(np.arange(ny) + .5, np.arange(nx) + .5,
                             np.sqrt(gy ** 2 + gx ** 2)).ev(r, c)
    req = elevation_threshold + elevation_scaler * sv
    if return_margin:
        return np.abs(ev - z64) > req, obj, margin
    return np.abs(ev - z64) > req, obj


SMRF_POINTS = 5_000_000        # bench.py bench_gridding's cloud: 5M points
SMRF_SIDE = 2000.0             # over 2000 m x 2000 m; cellsize 1 -> ~2003^2
SMRF_CHUNK = 1_999_999         # the streamed point stage: 3 chunks
# the published parameters bench.py's bench_smrf uses
SMRF_KW = dict(cellsize=1, windows=18, slope_threshold=.15,
               elevation_threshold=.5, elevation_scaler=1.25)
INPAINT_SIDE = 4096            # bench.py bench_inpaint
MID_POINTS, MID_SIDE, MID_WINDOWS = 200_000, 400.0, 12
TIE_MARGIN = 1e-8              # tests/test_smrf.py: a differing cell is a tie


class StageClock:
    """The ``mark`` hook of ``pipelines/smrf._smrf_run``: after each stage
    a CUDA event and the host clock, with the CG counts the springs fills
    report."""

    def __init__(self):
        self.marks = []
        self("start")

    def __call__(self, stage, **info):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.marks.append((stage, event, time.perf_counter(), info))

    def stages(self):
        torch.cuda.synchronize()
        return {name: dict(device_ms=e0.elapsed_time(e1),
                           host_ms=(h1 - h0) * 1e3, **info)
                for (_, e0, h0, _), (name, e1, h1, info)
                in zip(self.marks, self.marks[1:])}


def device_profile(call):
    """One ``torch.profiler`` pass (CUDA activity) of ``call``: host-clock
    wall ms (ending in a synchronise), device ms (the union of the
    kernels', copies' and fills' spans), idle share, kernel launches and
    copies.  The profiler's first window in a process carries its start-
    up, so a small window runs first."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, kernels = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        kernels += not e.name().startswith(("Memcpy", "Memset"))
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return out, dict(wall_ms=wall, device_ms=busy / 1e6,
                     idle_share=1.0 - busy / 1e6 / wall, launches=kernels,
                     copies_and_fills=len(spans) - kernels)


def smrf_labels_check(pts, building, canopy, what):
    """>= 90% of building points objects, >= 90% of bare ground kept."""
    pts = pts.cpu().numpy()
    flagged = float(pts[building].mean())
    kept = float(1 - pts[~building & ~canopy].mean())
    check(flagged >= 0.9, f"{what}: {flagged:.4f} of building points "
                          "flagged (need >= 0.9)")
    check(kept >= 0.9, f"{what}: {kept:.4f} of bare ground kept "
                       "(need >= 0.9)")
    return flagged, kept


def smrf_path(ntt, cuda_scan, dev):
    """Phase 8: SMRF on a 5M-point synthetic tile (``lidar_tile``) at
    cellsize 1 (about 2003^2 cells, ~29% empty), windows 18 and the
    published thresholds: the fast call one-shot (the counted path run),
    the same call through its stage hook (CUDA events per stage, CG
    iterations and host syncs per fill), exact, the point stage streamed
    in chunks, the host legs alone, and a ``torch.profiler`` pass."""
    from neilpy_tpu_torch.ops import inpaint, pointgrid, spline
    from neilpy_tpu_torch.pipelines.smrf import _smrf_run
    x, y, z, building, canopy = lidar_tile(5, SMRF_POINTS, SMRF_SIDE)
    n = x.size
    kw = dict(SMRF_KW, device=dev)
    xs, ys, zs, *_ = lidar_tile(6, MID_POINTS, MID_SIDE)  # warm-up
    ntt.smrf(xs, ys, zs, **kw)
    torch.cuda.synchronize()

    reset_counts(cuda_scan)
    t0 = time.perf_counter()
    Zpro, t, cells, pts = ntt.smrf(x, y, z, chunk_points=n, **kw)
    torch.cuda.synchronize()
    wall_fast = time.perf_counter() - t0
    counts = read_counts(cuda_scan)
    check(not any(counts.values()),
          f"the SMRF path launched {counts}: it runs none of K1-K5")

    clock = StageClock()
    run_kw = dict(SMRF_KW, low_filter_slope=5, low_outlier_fill=False,
                  return_extras=False, chunk_points=n, device=dev)
    staged = _smrf_run(x, y, z, precision="fast", mark=clock,
                                **run_kw)
    stages = clock.stages()
    check(torch.equal(staged[3], pts) and torch.equal(staged[2], cells),
          "the stage-timed fast call differs from the untimed one")

    t0 = time.perf_counter()
    Zx, tx, cells_x, pts_x = ntt.smrf(x, y, z, chunk_points=n,
                                      precision="exact", **kw)
    torch.cuda.synchronize()
    wall_exact = time.perf_counter() - t0

    streamed = ntt.smrf(x, y, z, chunk_points=SMRF_CHUNK, **kw)[3]
    check(torch.equal(streamed, pts),
          f"chunk_points={SMRF_CHUNK} labels differ from the one-shot call")

    ny, nx = Zpro.shape
    side = SMRF_SIDE + 3  # the frame's half-cell margins and snapping
    check(tuple(t) == tuple(tx) and Zx.shape == (ny, nx)
          and abs(ny - side) <= 2 and abs(nx - side) <= 2,
          f"grid {ny}x{nx}: expected about {side:.0f}^2, one frame")
    for name, a, dt in (("fast", Zpro, torch.float32),
                        ("exact", Zx, torch.float64)):
        check(a.is_cuda and a.dtype == dt and bool(torch.isfinite(a).all()),
              f"{name} Zpro: device, dtype or a non-finite cell")
    for name, a in (("fast", pts), ("exact", pts_x)):
        check(a.is_cuda and a.dtype == torch.bool and a.shape == (n,),
              f"{name} labels: device, dtype or shape")
    agree = float((pts == pts_x).double().mean())
    check(agree >= 0.999, f"fast and exact labels agree on {agree:.5f} of "
                          "the points (need >= 0.999)")
    cells_agree = float((cells == cells_x).double().mean())
    flagged, kept = smrf_labels_check(pts, building, canopy, "fast")
    flagged_x, kept_x = smrf_labels_check(pts_x, building, canopy, "exact")

    # the host legs alone, and the copies, at this cloud's size
    legs = {}
    h0 = time.perf_counter()
    flat, valid, _, _ = pointgrid.bin_points(x, y, cellsize=1)
    legs["host_f64_binning_ms"] = (time.perf_counter() - h0) * 1e3
    h0 = time.perf_counter()
    c64, r64 = (~t) * (x, y)
    legs["host_inverse_affine_ms"] = (time.perf_counter() - h0) * 1e3
    z32 = z.astype(np.float32)
    r32, c32 = r64.astype(np.float32), c64.astype(np.float32)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    dev_in = [torch.from_numpy(a).to(dev) for a in (flat, valid, z32)]
    torch.cuda.synchronize()
    legs["h2d_grid_inputs_ms"] = (time.perf_counter() - h0) * 1e3
    h0 = time.perf_counter()
    grid = pointgrid.scatter_reduce(*dev_in, ny * nx, bin_type="min")
    torch.cuda.synchronize()
    legs["device_scatter_ms"] = (time.perf_counter() - h0) * 1e3
    h0 = time.perf_counter()
    dev_pts = [torch.from_numpy(a).to(dev) for a in (r32, c32, z32)]
    torch.cuda.synchronize()
    legs["h2d_points_ms"] = (time.perf_counter() - h0) * 1e3
    h0 = time.perf_counter()
    back = pts.cpu().numpy()
    legs["d2h_labels_ms"] = (time.perf_counter() - h0) * 1e3
    h0 = time.perf_counter()
    Zpro.cpu().numpy()
    legs["d2h_zpro_ms"] = (time.perf_counter() - h0) * 1e3
    check(int(torch.isnan(grid).sum()) > 0 and back.shape == (n,),
          "host-leg replay")
    empty_share = float(torch.isnan(grid).double().mean())
    del dev_in, dev_pts, grid

    # one torch.profiler pass of the fast call, and the launches of one
    # preconditioner application and one spline coefficient set
    _, prof = device_profile(lambda: ntt.smrf(x, y, z, chunk_points=n, **kw))
    unknown = torch.isnan(pointgrid.create_dem(
        x, y, z, cellsize=1, bin_type="min", device=dev)[0]).float()
    levels = inpaint._build_levels(unknown, inpaint._degree(
        unknown.shape, device=dev))
    r = torch.randn(unknown.shape, device=dev) * unknown
    _, kcycle = device_profile(lambda: inpaint._kcycle(r, levels, 0))
    _, coeffs = device_profile(lambda: spline.spline_coefficients_2d(Zpro))
    emit(phase="smrf_path", points=n, grid=[ny, nx],
         empty_cell_share=empty_share, windows=SMRF_KW["windows"],
         launches_by_kernel=counts, wall_s={"fast": wall_fast,
                                            "exact": wall_exact},
         stages_fast=stages, host_legs=legs,
         profile_fast=prof, kcycle_levels=len(levels),
         kcycle_application=kcycle, spline_coefficient_set=coeffs,
         fast_exact_label_agreement=agree,
         fast_exact_cell_agreement=cells_agree,
         building_flagged={"fast": flagged, "exact": flagged_x},
         ground_kept={"fast": kept, "exact": kept_x},
         object_share=float(pts.double().mean()))
    return (x, y, z), prof


def inpaint_scale(ntt, dev):
    """Phase 9: ``inpaint_nans_by_springs`` at 4096^2 with bench.py
    bench_inpaint's 30% contiguous hole, float32 on the card (after a
    warm-up), against the port's own float64 card solve at tol=1e-12."""
    H = W = INPAINT_SIDE
    rng = np.random.default_rng(2)
    Z = rng.normal(size=(H, W)).astype(np.float32)
    Z = np.cumsum(Z, axis=0) + np.cumsum(Z, axis=1)
    Z[900 * H // 4096:3200 * H // 4096, 800 * W // 4096:3000 * W // 4096] = \
        np.nan
    Zd = torch.from_numpy(Z).to(dev)
    ntt.inpaint_nans_by_springs(Zd[H // 4:H // 4 + 512, W // 4:W // 4 + 512])
    runs = {}
    for name, A, kw in (("f32", Zd, {}),
                        ("f64", Zd.double(), dict(tol=1e-12,
                                                  maxiter=100_000))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = ntt.inpaint_nans_by_springs(A, return_info=True, **kw)
        torch.cuda.synchronize()
        runs[name] = (out, dict(info, ms=(time.perf_counter() - t0) * 1e3))
        check(info["converged"] and bool(torch.isfinite(out).all()),
              f"{name} fill: not converged or non-finite")
    err = float((runs["f32"][0].double() - runs["f64"][0]).abs().max())
    check(err <= 1e-3, f"f32 fill vs the f64 fill: max |diff| {err} above "
                       "1e-3")
    known = ~torch.isnan(Zd)
    check(torch.equal(runs["f32"][0][known], Zd[known]),
          "the fill changed a known cell")
    emit(phase="inpaint_scale", shape=[H, W],
         hole_share=float((~known).double().mean()),
         f32=runs["f32"][1], f64_tol_1e12=runs["f64"][1],
         max_abs_diff_f32_vs_f64=err)
    return Zd, runs["f32"][0], runs["f64"][0]


def smrf_oracle(ntt, dev):
    """Phase 10: the card's ``precision='exact'`` against the f64 scipy
    oracle, bit for bit, on tests/test_smrf.py:140-156's building scene;
    then on a mid-size tile (200k points, 400 m, windows 12) the card's
    exact labels against the port's own CPU exact ones: equal point
    labels, any differing cell a threshold tie (oracle margin < 1e-8)."""
    rng = np.random.default_rng(12345)
    n = 4000
    x = rng.uniform(0, 50, n)
    y = rng.uniform(0, 40, n)
    z = rng.normal(0, 0.1, n) + 0.02 * x
    z = z + 6.0 * ((x > 15) & (x < 25) & (y > 10) & (y < 25))
    ref_pts, ref_obj = np_smrf(x, y, z, 1, 6, .15, .5, 1.25)
    _, _, obj, pts = ntt.smrf(x, y, z, 1, 6, .15, .5, 1.25,
                              precision="exact", device=dev)
    check(pts.is_cuda and np.array_equal(pts.cpu().numpy(), ref_pts),
          "exact point labels differ from the f64 oracle")
    check(np.array_equal(obj.cpu().numpy(), ref_obj),
          "exact object cells differ from the f64 oracle")

    x, y, z, *_ = lidar_tile(7, MID_POINTS, MID_SIDE)
    kw = dict(cellsize=1, windows=MID_WINDOWS, slope_threshold=.15,
              elevation_threshold=.5, elevation_scaler=1.25,
              precision="exact")
    t0 = time.perf_counter()
    _, _, cells_d, pts_d = ntt.smrf(x, y, z, device=dev, **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, cells_h, pts_h = ntt.smrf(x, y, z, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    check(torch.equal(pts_d.cpu(), pts_h),
          "mid-size exact point labels: card != CPU")
    diff = (cells_d.cpu() != cells_h).numpy()
    margin = None
    if diff.any():
        *_, margin = np_smrf(x, y, z, 1, MID_WINDOWS, .15, .5, 1.25,
                             return_margin=True)
        margin = float(margin[diff].max())
        check(margin < TIE_MARGIN, f"{int(diff.sum())} mid-size cells "
                                   f"differ, max oracle margin {margin}")
    emit(phase="smrf_oracle", building_scene_points=4000,
         building_scene_bit_identical=True, mid_points=MID_POINTS,
         mid_grid=list(cells_d.shape), mid_windows=MID_WINDOWS,
         mid_cells_differing=int(diff.sum()), mid_max_tie_margin=margin,
         mid_exact_s={"card": card_s, "cpu": cpu_s})


LAS_CHUNK = 1_000_000          # create_dem_from_las's streamed batches
LAS_FIELDS = ("x", "y", "z", "intensity", "class", "return_number",
              "return_max")
EDGE_TOL = 1e-6                # cells: native and numpy bins differ only here


def rss_mib():
    """This process's resident set (VmRSS of /proc/self/status), MiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class PeakRss:
    """Within the block, a thread samples the resident set every
    ``period`` seconds; ``before`` and ``peak`` in MiB (the kernel's own
    high-water mark cannot be reset everywhere)."""

    def __init__(self, period=0.005):
        import threading
        self.period, self._stop = period, threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self):
        while not self._stop.wait(self.period):
            self.peak = max(self.peak, rss_mib())

    def __enter__(self):
        self.before = self.peak = rss_mib()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_mib())


def grids_equal(a, b):
    """Same shape, NaN at the same cells, equal values elsewhere."""
    return (a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def las_path(ntt, dev, tmp, cloud):
    """Phase 11: ``write_las`` the smrf_path cloud (PDRF 0), ``smrf_las``
    it into a second file on the card (both passes through the native
    decoder's chunks: their sizes are counted and ``read_las`` refuses
    inside the call), read that back: every class is ``smrf``'s label on
    the file's decoded points, every byte but the classification bits is
    unchanged, n_object + n_ground == n.  Then the native decoder equals
    ``read_las`` on every field, native binning equals numpy's but for
    points within ``EDGE_TOL`` of a cell edge, and ``create_dem_from_las``
    streamed in ``LAS_CHUNK`` batches equals its one-shot grid and its
    ``read_las`` branch bit for bit, in the header's frame (which is the
    points' frame: ``write_las`` writes a truthful header).  Decode,
    gridding and the peak host memory of ``smrf_las`` are printed."""
    import inspect
    from neilpy_tpu_torch.io import las as las_py, las_native
    from neilpy_tpu_torch.ops import pointgrid
    x, y, z = cloud
    n = x.size
    src, out = str(Path(tmp) / "tile.las"), str(Path(tmp) / "classified.las")
    t0 = time.perf_counter()
    ntt.write_las(src, x, y, z, pdrf=0)
    write_s = time.perf_counter() - t0

    chunks = []
    real = las_native.read_las_chunks

    def counted(*args, **kw):
        for chunk in real(*args, **kw):
            chunks.append(int(chunk["x"].size))
            yield chunk

    def whole(*args, **kw):
        raise RuntimeError("smrf_las read the whole file through read_las")

    with _switched(las_native, "read_las_chunks", counted), \
            _switched(las_py, "read_las", whole), PeakRss() as rss:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, t, _, stats = ntt.smrf_las(src, out, device=dev, **SMRF_KW)
        torch.cuda.synchronize()
        smrf_las_s = time.perf_counter() - t0
    step = inspect.signature(ntt.smrf_las).parameters["chunk_points"].default
    per_pass = [min(step, n - i) for i in range(0, n, step)]
    check(chunks == per_pass * 2,
          f"smrf_las took decoder chunks of {chunks} points: expected "
          f"{per_pass} in each of its two passes")

    t0 = time.perf_counter()
    arrays = las_native.read_las_arrays(src)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hdr, df = ntt.read_las(src)
    python_s = time.perf_counter() - t0
    for key in LAS_FIELDS:
        check(np.array_equal(arrays[key], np.asarray(df[key])),
              f"read_las_arrays' {key} differs from read_las'")
    _, t2, _, is_obj = ntt.smrf(df.x, df.y, df.z, device=dev, **SMRF_KW)
    want = np.where(is_obj.cpu().numpy(), 1, 2)
    check(t == t2, "smrf_las frame != smrf's frame on the decoded points")
    _, dfo = ntt.read_las(out)
    check(np.array_equal(np.asarray(dfo["class"]) & 0x1F, want),
          "smrf_las classes differ from smrf's labels")
    check(stats["n_points"] == n and stats["n_object"] + stats["n_ground"]
          == n and stats["n_object"] == int(is_obj.sum()),
          f"smrf_las stats {stats}")
    raw_in = np.fromfile(src, np.uint8)
    raw_out = np.fromfile(out, np.uint8)
    off0, reclen = hdr["point_data_offset"], hdr["point_data_record_length"]
    check(raw_in.size == raw_out.size
          and np.array_equal(raw_in[:off0], raw_out[:off0]),
          "smrf_las changed the header or the file size")
    recs_in = raw_in[off0:off0 + n * reclen].reshape(n, reclen)
    recs_out = raw_out[off0:off0 + n * reclen].reshape(n, reclen)
    keep = np.ones(reclen, bool)
    keep[15] = False
    check(np.array_equal(recs_in[:, keep], recs_out[:, keep])
          and np.array_equal(recs_in[:, 15] & 0xE0, recs_out[:, 15] & 0xE0),
          "smrf_las changed a byte other than the classification bits")
    del raw_in, raw_out, recs_in, recs_out, dfo

    # binning: the native kernel against numpy on the decoded cloud
    xd, yd = arrays["x"], arrays["y"]
    bins, bin_ms = {}, {}
    for name, native in (("native", True), ("numpy", False)):
        t0 = time.perf_counter()
        bins[name] = pointgrid.bin_points(xd, yd, 1, native=native)
        bin_ms[name] = (time.perf_counter() - t0) * 1e3
    (fn_, vn, shape, tn), (f0, v0, shape0, t0_) = bins["native"], bins["numpy"]
    differ = (fn_ != f0) | (vn != v0)
    col = (xd[differ] - tn.c) / tn.a
    row = (tn.f - yd[differ]) / tn.a
    on_edge = ((np.abs(col - np.round(col)) <= EDGE_TOL)
               | (np.abs(row - np.round(row)) <= EDGE_TOL))
    check(shape == shape0 and tuple(tn) == tuple(t0_) and on_edge.all(),
          f"native binning differs from numpy off the cell edges "
          f"({int((~on_edge).sum())} points)")
    del bins, fn_, vn, f0, v0

    # create_dem_from_las: streamed, one-shot, and the read_las branch
    kw = dict(cellsize=1, bin_type="min", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Gs, ts = ntt.create_dem_from_las(src, chunk_points=LAS_CHUNK, **kw)
    torch.cuda.synchronize()
    streamed_s = time.perf_counter() - t0
    G1, t1 = ntt.create_dem_from_las(src, chunk_points=n, **kw)
    with _switched(las_native, "native_available", lambda: False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Gr, tr = ntt.create_dem_from_las(src, **kw)
        torch.cuda.synchronize()
        read_las_branch_s = time.perf_counter() - t0
    frame = pointgrid._grid_frame(xd, yd, 1)[2]
    check(tuple(ts) == tuple(t1) == tuple(tr) == tuple(frame),
          "create_dem_from_las: the header frame != the points' frame")
    check(Gs.is_cuda, "create_dem_from_las: the grid is not on the card")
    check(grids_equal(Gs, G1) and grids_equal(Gs, Gr),
          "create_dem_from_las streamed != one-shot != the read_las branch")
    emit(phase="las_path", points=n, file_mb=os.path.getsize(src) / 2**20,
         write_las_s=write_s, smrf_las_s=smrf_las_s, stats=stats,
         smrf_las_decoder_chunks=chunks,
         smrf_las_host_rss_mib=dict(before=rss.before, peak=rss.peak,
                                    rise=rss.peak - rss.before),
         decode_mpts_s={"native": n / native_s / 1e6,
                        "python_read_las": n / python_s / 1e6},
         binning_ms=bin_ms, binning_edge_points=int(differ.sum()),
         create_dem_from_las_s={"streamed": streamed_s,
                                "read_las_branch": read_las_branch_s},
         chunk_points=LAS_CHUNK, grid=list(Gs.shape))


# ----------------------------------------------------------------------
# the host ingest slice: the native host libraries (g++), the TIFF codecs
# on the raster path (K1, K2, K5/counts downstream)
# ----------------------------------------------------------------------
CODEC_CROP = 2048              # the Python codecs' raster side


def host_build():
    """Phase 1b: build the three host libraries from the checkout's
    ``neilpy_tpu_torch/native/*.cpp`` (one g++ each, started together)
    and fail unless the binning kernel, the LAS decoder and the TIFF
    codec all load: no Python fallback stands in for them on the card."""
    from concurrent.futures import ThreadPoolExecutor
    from neilpy_tpu_torch import _host_build
    from neilpy_tpu_torch.io import las_native, tiff_codec
    from neilpy_tpu_torch.ops import binning_native
    cxx = _host_build._cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]

    def timed(name):
        t0 = time.perf_counter()
        path = _host_build.build(name)
        return name, str(path.relative_to(HERE)), time.perf_counter() - t0

    with ThreadPoolExecutor(len(_host_build.NAMES)) as pool:
        built = list(pool.map(timed, _host_build.NAMES))
    available = {"binning": binning_native.native_available(),
                 "las_decoder": las_native.native_available(),
                 "tiffcodec": tiff_codec.codec_native_available()}
    check(all(available.values()),
          f"host libraries unavailable on the card: {available}")
    emit(phase="host_build", gxx=version, flags=list(_host_build._flags(cxx)),
         libraries={name: dict(path=path, build_s=secs)
                    for name, path, secs in built},
         available=available, zstd_available=tiff_codec.zstd_available())


def codec_path(ntt, cuda_scan, dev, tmp, Z, G, G_fast, card):
    """Phase 5b: compressed GeoTIFFs on the raster path.  Set-up: the
    8192^2 DEM written with the port's writer as ZSTD strips and ZSTD
    tiles (deflate where libzstd is absent, printed), and as LZW by PIL's
    libtiff (a 2048^2 crop by the port's Python encoder where PIL cannot).
    The counted run: ``imread`` each -> ``geomorphons`` exact (K5/counts)
    and fast (K1) on the card -> the classes written as ZSTD and (a 2048^2
    crop: the encoder is Python) as LZW and read back ->
    ``mosaic_terrain_products`` over a ``GeoTiffSource`` of the ZSTD tiles
    with mosaic_vs_plain's six products (K1 and K2 on each tile).  Every
    decoded DEM equals the array, every class raster main_path's classes
    of the uncompressed DEM, the read-back classes the written ones, and
    the mosaic the same call on the in-memory array.  Rates: each codec's
    encode and imread MB/s at full size (native), the Python LZW encoder
    (the classes' crop) and the Python LZW and PackBits decoders against
    the native ones on the 2048^2 crop of the classes."""
    from PIL import Image
    from neilpy_tpu_torch.io import tiff_codec
    H, W = Z.shape
    mb = Z.nbytes / 2**20
    geo = dict(transform=ntt.from_origin(0.0, 10.0 * H, 10, 10), crs=32633)
    zstd = tiff_codec.zstd_available()
    big = "zstd" if zstd else "deflate"
    rates, files = {}, {}
    for name, tiled in ((f"{big}_strips", False), (f"{big}_tiled", True)):
        files[name] = str(Path(tmp) / f"dem_{name}.tif")
        t0 = time.perf_counter()
        ntt.write_geotiff(files[name], Z, compress=big, tiled=tiled, **geo)
        rates[f"{name}_encode_MBps"] = mb / (time.perf_counter() - t0)
    files["lzw"] = str(Path(tmp) / "dem_lzw.tif")
    try:
        t0 = time.perf_counter()
        Image.fromarray(Z).save(files["lzw"], compression="tiff_lzw")
        rates["lzw_encode_MBps_pil_libtiff"] = mb / (time.perf_counter() - t0)
        lzw_writer = f"PIL libtiff, {H}x{W}"
    except (OSError, ValueError) as e:
        lzw_writer = f"the port's Python encoder, {CODEC_CROP}^2 ({e})"
        ntt.write_geotiff(files["lzw"], Z[:CODEC_CROP, :CODEC_CROP],
                          compress="lzw")

    kw = dict(cellsize=10.0, lookup_pixels=MAIN_LOOKUP, threshold_angle=1,
              device=dev)
    mkw = dict(VS_PLAIN_KW, device=dev)
    torch.cuda.synchronize()
    reset_counts(cuda_scan)
    t_path = time.perf_counter()
    classes = {}
    for name, fn in files.items():
        t0 = time.perf_counter()
        Zr, _ = ntt.imread(fn)
        rates[f"{name}_imread_MBps"] = Zr.nbytes / 2**20 / (
            time.perf_counter() - t0)
        check(np.array_equal(Zr, Z[:Zr.shape[0], :Zr.shape[1]]),
              f"{name}: the decoded DEM differs from the array")
        classes[name] = (ntt.geomorphons(Zr, **kw),
                         ntt.geomorphons(Zr, fast=True, **kw))
    G_cls = classes[f"{big}_tiled"][0]
    out_big = str(Path(tmp) / f"classes_{big}.tif")
    out_lzw = str(Path(tmp) / "classes_lzw.tif")
    ntt.imwrite(out_big, G_cls, {**geo, "nodata": None}, compress=big)
    G_crop = G_cls[:CODEC_CROP, :CODEC_CROP]
    t0 = time.perf_counter()
    ntt.imwrite(out_lzw, G_crop, {**geo, "nodata": None}, compress="lzw")
    rates["lzw_python_encode_MBps_crop"] = G_crop.numel() / 2**20 / (
        time.perf_counter() - t0)
    back_big, back_lzw = ntt.imread(out_big)[0], ntt.imread(out_lzw)[0]
    src = ntt.GeoTiffSource(files[f"{big}_tiled"])
    t0 = time.perf_counter()
    M = ntt.mosaic_terrain_products(src, **mkw)
    mosaic_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_path
    counts = read_counts(cuda_scan)

    ts = mkw["tile_size"]
    n_tiles = (-(-H // ts)) * (-(-W // ts))
    want = {k: 0 for k in counts}
    want.update({"K5/counts": len(files), "K1": len(files) + n_tiles,
                 "K2": n_tiles})
    check(counts == want, f"codec path launched {counts}, expected {want}")
    for name, (Ge, Gf) in classes.items():
        if Ge.shape == G.shape:
            ok = torch.equal(Ge, G) and torch.equal(Gf, G_fast)
        else:  # the crop written by the Python encoder
            crop = np.ascontiguousarray(Z[:Ge.shape[0], :Ge.shape[1]])
            ok = (torch.equal(Ge, ntt.geomorphons(crop, **kw)) and
                  torch.equal(Gf, ntt.geomorphons(crop, fast=True, **kw)))
        check(ok, f"{name}: classes differ from the uncompressed DEM's")
    check(np.array_equal(back_big, G_cls.cpu().numpy())
          and np.array_equal(back_lzw, G_crop.cpu().numpy()),
          f"the classes read back from {big} / LZW differ")
    ref = ntt.mosaic_terrain_products(Z, **mkw)
    for p, a, b in zip(SIX, M, ref):
        check(a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f"),
            f"mosaic from the {big} GeoTiffSource: {p} differs from the "
            "in-memory array's")

    # the Python decoders against the native ones on the 2048^2 crop of
    # the classes (PIL writes PackBits for 8-bit rasters only)
    a = G_crop.cpu().numpy()
    for codec in ("lzw", "packbits"):
        fn = str(Path(tmp) / f"crop_{codec}.tif")
        Image.fromarray(a).save(fn, compression={"lzw": "tiff_lzw"}.get(
            codec, codec))
        got = {}
        for how in ("native", "python"):
            t0 = time.perf_counter()
            if how == "native":
                got[how] = ntt.imread(fn)[0]
            else:
                with _switched(tiff_codec, "_native_call",
                               lambda *args: None):
                    got[how] = ntt.imread(fn)[0]
            rates[f"{codec}_{how}_decode_MBps_crop"] = a.nbytes / 2**20 / (
                time.perf_counter() - t0)
            check(np.array_equal(got[how], a),
                  f"{codec} {how} decode of the crop differs")
    emit(phase="codec_path", card=card, shape=[H, W],
         zstd="present" if zstd else "absent: deflate in its place",
         codec=big, lzw_writer=lzw_writer, wall_s=wall, mosaic_s=mosaic_s,
         launches_by_kernel=counts, rates_MBps=rates, crop=CODEC_CROP)
    return counts


# ----------------------------------------------------------------------
# the DEM products slice: surface stencils, shading, statistics and their
# sharded forms, plain torch ops on the card (none of K1-K5)
# ----------------------------------------------------------------------
SURFACE_CROP = (1024, 1536)    # surface_vs_plain: a crop of bench_input
STATS_SHAPE = (2048, 4096)     # bench.py BENCH_SHAPE, its bench_stats
SHARDED_CROP = (8191, 8190)    # the one-card 2 x 2 mesh does not divide it
# a float product on the card against the CPU: rtol, plus an absolute
# tolerance of this share of its largest |value| (tests/test_torch_surface
# .py's FLOAT_TOL, on a raster of another magnitude)
SURFACE_RTOL = 1e-5
SURFACE_ATOL_SHARE = 1e-6
CONV_RTOL = 1e-5               # of the sum of |terms|: TF32 errs ~5e-4
UINT8_SHARE = 1e-3             # off by one level on < 0.1% of the pixels
P_TIE = 1e-5                   # a bin may flip within this of .1/.05/.01
GI_ORACLE_TOL = 2e-4           # tests/test_stats_viz_aux.py's oracle test
SHARDED_STATS_TOL = 2e-4       # tests/test_dist.py
SHARDED_MORANS_RTOL = 5e-4     # tests/test_dist.py


def np_hillshade(Z, cellsize=1, z_factor=1, zenith=45, azimuth=315):
    """float64 numpy hillshade, a copy of tests/reference_impls.py's
    ``np_hillshade`` (with its ``np_gradient_slope``)."""
    zen, azi = np.deg2rad((zenith, azimuth))
    gy, gx = np.gradient(Z, cellsize / z_factor)
    S = np.arctan(np.sqrt(gx ** 2 + gy ** 2))
    gy, gx = np.gradient(Z)
    A = np.pi / 2 - np.arctan2(gy, -gx)
    A[A < 0] += 2 * np.pi
    A[(gx == 0) & (gy == 0)] = 0
    H = np.cos(zen) * np.cos(S) + np.sin(zen) * np.sin(S) * np.cos(azi - A)
    H[H < 0] = 0
    return np.round(255 * H).astype(np.uint8)


def holed(Z):
    """``Z`` (float32) with NaN holes: a block, a lone cell, a cell on the
    top edge and one in the last column."""
    Z = np.array(Z, dtype=np.float32)
    H, W = Z.shape
    Z[H // 3:H // 3 + 40, W // 3:W // 3 + 60] = np.nan
    Z[2 * H // 3, W // 10] = np.nan
    Z[0, W // 2] = np.nan
    Z[H // 2, W - 1] = np.nan
    return Z


def uint8_err(got, want, what):
    """(max |diff|, share of pixels that differ); fails past one level or
    on UINT8_SHARE of the pixels."""
    check(got.dtype == torch.uint8 and want.dtype == torch.uint8
          and got.shape == want.shape, f"{what}: dtype/shape")
    d = (got.int() - want.int()).abs()
    mx, share = int(d.max()), float((d > 0).double().mean())
    check(mx <= 1 and share < UINT8_SHARE,
          f"{what}: uint8 off by {mx} on {share:.2e} of the pixels")
    return mx, share


def scaled_err(got, want, what, rtol=SURFACE_RTOL, share=0.0, atol=0.0):
    """max |got - want| / (rtol |want| + atol + share max|want|) over the
    finite pixels, NaN and inf at the same pixels; fails above 1."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: dtype/shape")
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          f"{what}: NaN at other pixels")
    fin = torch.isfinite(want)
    check(torch.equal(fin, torch.isfinite(got)),
          f"{what}: inf at other pixels")
    g, w = got[fin].double(), want[fin].double()
    if not w.numel():
        return 0.0
    tol = rtol * w.abs() + atol + share * float(w.abs().max())
    r = float(((g - w).abs() / tol.clamp(min=1e-300)).max())
    check(r <= 1, f"{what}: {r:.3g} x its tolerance")
    return r


def bins_err(got, want, P, what):
    """Significance bins equal wherever P is not within P_TIE of .1, .05 or
    .01; returns the pixels that differ."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    edge = torch.zeros_like(same)
    for e in (.1, .05, .01):
        edge |= (P - e).abs() < P_TIE
    check(bool((same | edge).all()), f"{what}: a bin differs off a tie")
    return int((~same).sum())


def surface_calls(ntt, Z, cellsize, H):
    """Every public device function of the slice on ``Z`` (a tensor: its
    device decides where each runs), as (name, kind, call); ``H`` is the
    hillshade brassel takes, one input for both devices."""
    from neilpy_tpu_torch.ops import surface
    k = np.random.default_rng(1).normal(size=(5, 7))
    gray = ntt.swiss_lut()
    return [
        ("slope", "float", lambda: ntt.slope(Z, cellsize)),
        ("esri_slope", "float", lambda: ntt.esri_slope(Z, cellsize)),
        ("aspect", "float", lambda: ntt.aspect(Z)),
        ("hillshade", "uint8", lambda: ntt.hillshade(Z, cellsize)),
        ("hillshade float", "float",
         lambda: ntt.hillshade(Z, cellsize, return_uint8=False)),
        ("multiple_illumination", "uint8",
         lambda: ntt.multiple_illumination(Z, cellsize)),
        ("pssm", "uint8", lambda: ntt.pssm(Z, cellsize,
                                           apply_colormap=False)),
        ("pssm colormap", "lut:pssm", lambda: ntt.pssm(Z, cellsize)),
        ("z_factor", "float", lambda: ntt.z_factor(Z[:4, :4] % 90)),
        ("curvature", "float", lambda: ntt.curvature(Z, cellsize)),
        ("esri_curvature", "float", lambda: ntt.esri_curvature(Z, cellsize)),
        ("zevenbergen_and_thorne_curvature", "float",
         lambda: ntt.zevenbergen_and_thorne_curvature(Z, cellsize)),
        ("evans_curvature", "float",
         lambda: ntt.evans_curvature(Z, cellsize)),
        ("wilson_gallant_curvature", "float",
         lambda: ntt.wilson_gallant_curvature(Z, cellsize)),
        ("scaled_morphometry", "float",
         lambda: ntt.scaled_morphometry(Z, cellsize, 1)),
        ("scaled_morphometry 50", "float",
         lambda: ntt.scaled_morphometry(Z, cellsize, 50)),
        ("triangle_height", "float",
         lambda: ntt.triangle_height(Z[1:] - Z[:-1], Z[:-1] - Z[1:] * 0.5,
                                     cellsize)),
        ("vip_score", "float", lambda: ntt.vip_score(Z, cellsize)),
        ("std", "float", lambda: ntt.std(Z, ntt.disk(5))),
        ("std2", "float", lambda: ntt.std2(Z, ntt.disk(3))),
        ("reduce_peaks", "float", lambda: ntt.reduce_peaks(Z, 5)),
        ("topographic_position_index", "float",
         lambda: ntt.topographic_position_index(Z, 5)),
        ("convolve2d_nearest", "conv",
         lambda: surface.convolve2d_nearest(Z, k)),
        ("binary_footprint_sum", "exact",
         lambda: surface.binary_footprint_sum(torch.isfinite(Z).float(),
                                              ntt.disk(13))),
        ("swiss_shading", "lut:shade",
         lambda: ntt.swiss_shading(Z, cellsize)),
        ("colortable_shade", "lut:shade", lambda: ntt.colortable_shade(
            Z, "gray_high_contrast", cellsize)),
        ("lut_shade", "lut:shade", lambda: ntt.lut_shade(Z, gray, cellsize)),
        ("brassel_atmospheric_perspective", "uint8",
         lambda: ntt.brassel_atmospheric_perspective(H, Z, 2)),
        ("rasterGi", "gi", lambda: ntt.rasterGi(Z, ntt.disk(5), star=True)),
        ("rasterGi corrected", "gi",
         lambda: ntt.rasterGi(Z, 2, apply_correction=True)),
        ("morans_i", "scalars", lambda: ntt.morans_i(Z, 3)),
        ("local_morans_i", "float", lambda: ntt.local_morans_i(Z, 3)),
        ("rmse", "scalars", lambda: (ntt.rmse(Z),)),
        ("shi_landslides", "bool",
         lambda: ntt.shi_landslides(Z, (5, 13), cellsize)),
    ]


def flat_outputs(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return list(out)
    return [out]


def lut_indices(ntt, Z, cellsize):
    """Where each table gather of the slice reads: the shading's
    (elevation, hillshade) cell and pssm's class, on ``Z``'s device."""
    from neilpy_tpu_torch.core.device import to_uint8
    from neilpy_tpu_torch.viz.shading import _nan_extreme
    zmin, zmax = _nan_extreme(Z, False), _nan_extreme(Z, True)
    zn = to_uint8(torch.round(255 * (Z - zmin) / (zmax - zmin)))
    H = ntt.hillshade(Z, cellsize)
    return {"shade": zn.long() * 256 + H.long(),
            "pssm": ntt.pssm(Z, cellsize, apply_colormap=False)}


def compare_products(name, kind, got, want, same=None):
    """One output of ``surface_calls`` on the card against the CPU's;
    ``same`` maps a gather (``lut_indices``) to the pixels where both
    devices read one table cell."""
    got = [g.cpu() for g in flat_outputs(got)]
    want = flat_outputs(want)
    check(len(got) == len(want), f"{name}: outputs")
    if kind.startswith("lut:"):
        # a gather: equal wherever both devices index one cell, and those
        # cells apart only where a uint8 index sits on an f32 tie
        mask = same[kind[4:]]
        share = float((~mask).double().mean())
        check(share < UINT8_SHARE, f"{name}: indices differ on {share:.2e}")
        check(torch.equal(got[0][mask], want[0][mask]),
              f"{name}: differs where the indices agree")
        return share
    if kind == "uint8":
        return max(uint8_err(g, w, name)[1] for g, w in zip(got, want))
    if kind == "exact":
        check(torch.equal(got[0], want[0]), f"{name}: differs")
        return 0.0
    if kind == "bool":
        share = float((got[0] != want[0]).double().mean())
        check(share < UINT8_SHARE, f"{name}: {share:.2e} of pixels differ")
        return share
    if kind == "scalars":
        r = [abs(float(g) - float(w)) / (SURFACE_RTOL * abs(float(w)))
             for g, w in zip(got, want)]
        check(max(r) <= 1, f"{name}: {max(r):.3g} x its tolerance")
        return max(r)
    if kind == "gi":
        (gz, gp, gs), (wz, wp, ws) = got, want
        r = max(scaled_err(gz, wz, name + " z", atol=1e-5),
                scaled_err(gp, wp, name + " P", atol=1e-6))
        bins_err(gs, ws, wp, name)
        return r
    return max(scaled_err(g, w, name, share=SURFACE_ATOL_SHARE)
               for g, w in zip(got, want))


def tf32_round(X):
    """float32 ``X`` rounded to TF32's 10-bit mantissa (nearest, ties
    away: add half of the dropped 13 bits, then clear them)."""
    bits = X.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def conv_rel_err(got, want, Zc, k):
    """max |got - want| over the sum of |terms| of each output (the CPU
    correlation of |Z| with |k|): f32 order of adds stays near 1e-7,
    TF32's 10-bit mantissa near 5e-4."""
    from neilpy_tpu_torch.ops import surface
    mag = surface.convolve2d_nearest(Zc.abs(), np.abs(k))
    fin = torch.isfinite(want)
    return float(((got.cpu() - want).abs()[fin] / mag[fin]).max())


def surface_vs_plain(ntt, dev, Z8):
    """Phase 12: every public device function of the DEM-products slice
    on the card against the port's own CPU run on a 1024 x 1536 crop of
    bench_input with NaN holes (the CPU tests' tolerances); the uint8 cast
    on the card; ``convolve2d_nearest`` within CONV_RTOL of the sum of
    its |terms| (TF32 off); then against float64 numpy oracles:
    ``hillshade``, ``curvature`` and ``swiss_shading`` at 8192^2 and Gi*
    (disk r=5) at 2048 x 4096, its neighbour counts exact."""
    from neilpy_tpu_torch.core.device import to_uint8
    from neilpy_tpu_torch.ops import surface
    import scipy.ndimage as ndi
    cs = 10.0
    crop = holed(Z8[:SURFACE_CROP[0], :SURFACE_CROP[1]])
    Zc, Zg = torch.from_numpy(crop), torch.from_numpy(crop).to(dev)
    Hc = ntt.hillshade(Zc, cs)
    on_card = surface_calls(ntt, Zg, cs, Hc.to(dev))
    on_cpu = surface_calls(ntt, Zc, cs, Hc)
    idx_card, idx_cpu = lut_indices(ntt, Zg, cs), lut_indices(ntt, Zc, cs)
    same = {k: idx_card[k].cpu() == idx_cpu[k] for k in idx_cpu}
    errs = {}
    for (name, kind, card_call), (_, _, cpu_call) in zip(on_card, on_cpu):
        got = card_call()
        for g in flat_outputs(got):
            check(g.is_cuda, f"{name}: output not on the card")
        errs[name] = compare_products(name, kind, got, cpu_call(), same)

    # the uint8 cast and NaN holes on the card
    vals = torch.tensor([float("nan"), -3, 0.4999, 254.6, 300,
                         float("inf"), -float("inf")], device=dev)
    check(to_uint8(vals).tolist() == [0, 0, 0, 254, 255, 255, 0],
          f"uint8 cast on the card: {to_uint8(vals).tolist()}")
    hole = torch.isnan(torch.from_numpy(crop))
    hole_in = hole.clone()
    hole_in[1:-1, 1:-1] = (hole[:-2, 1:-1] & hole[2:, 1:-1] & hole[1:-1, :-2]
                           & hole[1:-1, 2:] & hole[1:-1, 1:-1])
    H = ntt.hillshade(Zg, cs).cpu()
    P = ntt.pssm(Zg, cs, apply_colormap=False).cpu()
    rgb = ntt.swiss_shading(Zg, cs).cpu()
    lut00 = torch.from_numpy(np.array(ntt.swiss_lut()[0, 0]))
    check(int(hole_in.sum()) > 1000 and not H[hole_in].any()
          and not P[hole_in].any() and bool((rgb[hole_in] == lut00).all()),
          "hole: hillshade/pssm 0 and swiss lut[0, 0]")

    # convolve2d_nearest: TF32 off; the same call with TF32 let on
    k = np.random.default_rng(1).normal(size=(5, 7))
    want = surface.convolve2d_nearest(Zc, k)
    conv = {"tf32_off": conv_rel_err(surface.convolve2d_nearest(Zg, k), want,
                                     Zc, k)}
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                     allow_tf32=True):
        kf = torch.from_numpy(np.ascontiguousarray(
            k[::-1, ::-1]).astype(np.float32)).to(dev)
        Xp = surface._pad_footprint(Zg, k.shape, "nearest")
        tf32 = torch.nn.functional.conv2d(Xp[None, None], kf[None, None])[0, 0]
    conv["tf32_on"] = conv_rel_err(tf32, want, Zc, k)
    # what TF32 would give: both operands rounded to a 10-bit mantissa
    conv["tf32_emulated"] = conv_rel_err(surface.convolve2d_nearest(
        tf32_round(Zc), tf32_round(torch.from_numpy(k)).numpy()), want, Zc,
        k)
    check(conv["tf32_emulated"] > CONV_RTOL,
          f"a TF32 convolution would pass the check: {conv}")
    check(conv["tf32_off"] <= CONV_RTOL,
          f"convolve2d_nearest: {conv['tf32_off']:.3g} of |terms| (TF32?)")

    # float64 numpy oracles at 8192^2
    Zd = torch.from_numpy(Z8).to(dev)
    Z64 = Z8.astype(np.float64)
    H = ntt.hillshade(Zd, cs).cpu().numpy()
    H_ref = np_hillshade(Z64, cs)
    hd = np.abs(H.astype(int) - H_ref)
    oracle = {"hillshade_off_by_one_share": float((hd > 0).mean())}
    check(hd.max() <= 1 and oracle["hillshade_off_by_one_share"]
          < UINT8_SHARE, f"hillshade vs the f64 oracle: off by {hd.max()} "
          f"on {oracle['hillshade_off_by_one_share']:.2e}")
    K = ntt.curvature(Zd, cs).cpu().numpy()
    K_ref = -100 * ndi.laplace(Z64 / cs)
    oracle["curvature_err_over_tol"] = float(np.max(
        np.abs(K - K_ref) / (3e-4 * np.abs(K_ref) + 1e-3)))
    check(oracle["curvature_err_over_tol"] <= 1,
          f"curvature vs -100 laplace: {oracle['curvature_err_over_tol']}")
    rgb = ntt.swiss_shading(Zd, cs).cpu().numpy()
    lut = ntt.swiss_lut()
    zn = np.round(255 * (Z64 - Z64.min()) / (Z64.max() - Z64.min()))
    rgb_ref = lut[zn.astype(np.int64), H_ref]
    oracle["swiss_differ_share"] = float((rgb != rgb_ref).any(axis=2).mean())
    check(oracle["swiss_differ_share"] < UINT8_SHARE,
          f"swiss vs numpy gather: {oracle['swiss_differ_share']}")
    del H, H_ref, hd, K, K_ref, rgb, rgb_ref, zn

    # Gi* at bench.py's BENCH_SHAPE: counts exact, z within 2e-4
    Zs = holed(bench_input(STATS_SHAPE))
    fp = ntt.disk(5)
    fin = np.isfinite(Zs)
    Zsd = torch.from_numpy(Zs).to(dev)
    w = surface.binary_footprint_sum(torch.isfinite(Zsd).float(), fp)
    w_ref = ndi.correlate(fin.astype(np.float64), fp.astype(np.float64),
                          mode="nearest")
    check(np.array_equal(w.cpu().numpy(), w_ref), "Gi* counts != scipy")
    z, _, _ = ntt.rasterGi(Zsd, fp, star=True)
    Zs64 = np.where(fin, Zs, 0.0).astype(np.float64)
    s = ndi.correlate(Zs64, fp.astype(np.float64), mode="nearest")
    n = fin.sum()
    a = s - w_ref * np.nanmean(Zs.astype(np.float64))
    b = np.sqrt((w_ref / (n - 1)) * (n - w_ref)
                * np.nanstd(Zs.astype(np.float64)) ** 2)
    with np.errstate(invalid="ignore", divide="ignore"):
        z_ref = np.where(fin, a / b, np.nan)
    z = z.cpu().numpy()
    check(np.array_equal(np.isnan(z), np.isnan(z_ref)), "Gi* NaN pixels")
    oracle["gi_star_max_abs_z_err"] = float(np.nanmax(np.abs(z - z_ref)))
    check(oracle["gi_star_max_abs_z_err"] <= GI_ORACLE_TOL,
          f"Gi* z vs the f64 oracle: {oracle['gi_star_max_abs_z_err']}")
    emit(phase="surface_vs_plain", crop=list(SURFACE_CROP),
         functions=len(errs), err_over_tol=errs, conv_rel_err=conv,
         hole_pixels=int(hole_in.sum()), oracle=oracle,
         gi_star_shape=list(STATS_SHAPE))


def surface_path(ntt, cuda_scan, dev, tmp, dem):
    """Phase 13: the README's quickstart on the DEM products at 8192^2,
    cellsize 10: GeoTIFF -> ``imread`` -> ``hillshade`` -> ``imwrite``
    (.tif), then ``swiss_shading`` -> ``imwrite`` (.png), once, under one
    ``torch.profiler`` pass (device idle share), each host and device leg
    clocked on the host after a synchronise.  It runs none of K1-K5."""
    tif, png = str(Path(tmp) / "hillshade.tif"), str(Path(tmp) / "swiss.png")
    ntt.swiss_shading(torch.zeros((64, 64), device=dev), device=dev)  # warm-up
    legs = {}

    def leg(name, fn):
        h0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        legs[name] = (time.perf_counter() - h0) * 1e3
        return out

    def path():
        Zr, meta = leg("imread_ms", lambda: ntt.imread(dem))
        Zd = leg("h2d_dem_ms", lambda: torch.from_numpy(Zr).to(dev))
        H = leg("hillshade_device_ms",
                lambda: ntt.hillshade(Zd, cellsize=meta["cellsize"]))
        Hh = leg("d2h_hillshade_ms", lambda: H.cpu().numpy())
        leg("imwrite_tif_ms", lambda: ntt.imwrite(tif, Hh, meta))
        rgb = leg("swiss_device_ms",
                  lambda: ntt.swiss_shading(Zd, cellsize=meta["cellsize"]))
        rgbh = leg("d2h_swiss_ms", lambda: rgb.cpu().numpy())
        leg("imwrite_png_ms", lambda: ntt.imwrite(png, rgbh))
        return Zd, H, rgb

    torch.cuda.synchronize()
    reset_counts(cuda_scan)
    (Zd, H, rgb), prof = device_profile(path)
    counts = read_counts(cuda_scan)
    check(not any(counts.values()),
          f"the DEM-products path launched {counts}: it runs none of K1-K5")
    check(H.is_cuda and H.dtype == torch.uint8 and H.shape == MAIN_SHAPE,
          "hillshade: device, dtype or shape")
    check(rgb.is_cuda and rgb.dtype == torch.uint8
          and rgb.shape == MAIN_SHAPE + (3,), "swiss: device, dtype or shape")
    check(np.array_equal(ntt.imread(tif)[0], H.cpu().numpy()),
          "hillshade.tif read-back")
    from PIL import Image
    check(np.array_equal(np.asarray(Image.open(png)), rgb.cpu().numpy()),
          "swiss.png read-back")
    emit(phase="surface_path", shape=list(MAIN_SHAPE), cellsize=10,
         launches_by_kernel=counts, wall_s=prof["wall_ms"] / 1e3, legs=legs,
         profile=prof, png_mb=Path(png).stat().st_size / 2**20)
    return Zd


def sharded_surface(ntt, dev, Zd):
    """Phase 14: the four sharded DEM products on a 2 x 2 mesh naming this
    card four times, against their single-device forms, at 8192^2 and on
    an 8191 x 8190 crop the mesh does not divide: ``sharded_hillshade``
    equal to ``hillshade`` (at most one level, and counted), Gi* (disk
    r=5) and local Moran's I within tests/test_dist.py's 2e-4, their bins
    on > 99.9%, Moran's I within 5e-4; and each sharded / single wall."""
    dist = ntt.dist
    mesh = dist.make_mesh([dev] * 4)
    fp = ntt.disk(5)
    calls = {
        "hillshade": (lambda Z: dist.sharded_hillshade(Z, mesh, cellsize=10),
                      lambda Z: ntt.hillshade(Z, cellsize=10)),
        "rastergi": (lambda Z: dist.sharded_rastergi(Z, fp, mesh, star=True),
                     lambda Z: ntt.rasterGi(Z, fp, star=True)),
        "morans_i": (lambda Z: dist.sharded_morans_i(Z, 3, mesh),
                     lambda Z: ntt.morans_i(Z, 3)),
        "local_morans_i": (lambda Z: dist.sharded_local_morans_i(Z, 3, mesh),
                           lambda Z: ntt.local_morans_i(Z, 3)),
    }
    res = {}
    for shape in (MAIN_SHAPE, SHARDED_CROP):
        Z = Zd[:shape[0], :shape[1]]
        for name, (sharded, single) in calls.items():
            walls = []
            for fn in (sharded, single, sharded, single):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(Z)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if fn is sharded:
                    got = out
                else:
                    want = out
            key = f"{name} {shape[0]}x{shape[1]}"
            r = {"sharded_over_single_wall": walls[2] / walls[3],
                 "sharded_ms": walls[2] * 1e3, "single_ms": walls[3] * 1e3}
            if name == "hillshade":
                d = (got.int() - want.int()).abs()
                r["max_levels"] = int(d.max())
                r["pixels_differ"] = int((d > 0).sum())
                check(r["max_levels"] <= 1, f"{key}: {r['max_levels']} levels")
            elif name == "morans_i":
                r["rel_err"] = max(abs(float(g) - float(w)) / abs(float(w))
                                   for g, w in zip(got, want))
                check(r["rel_err"] <= SHARDED_MORANS_RTOL, f"{key}: {r}")
            elif name == "local_morans_i":
                r["err_over_tol"] = scaled_err(
                    got, want, key, rtol=SHARDED_STATS_TOL,
                    atol=SHARDED_STATS_TOL)
            else:
                (gz, gp, gs), (wz, wp, ws) = got, want
                r["err_over_tol"] = max(
                    scaled_err(gz, wz, key + " z", rtol=SHARDED_STATS_TOL,
                               atol=SHARDED_STATS_TOL),
                    scaled_err(gp, wp, key + " P", rtol=0,
                               atol=SHARDED_STATS_TOL))
                same = (gs == ws) | (torch.isnan(gs) & torch.isnan(ws))
                r["bins_equal_share"] = float(same.double().mean())
                check(r["bins_equal_share"] > 0.999, f"{key}: bins")
            res[key] = r
    emit(phase="sharded_surface", mesh=list(mesh.devices.shape), results=res)


# (name, call, bytes per pixel moved at least: input read + outputs written)
def timed_products(ntt, Zd, H):
    fp5, fp13 = ntt.disk(5), ntt.disk(13)
    return [
        ("slope", lambda: ntt.slope(Zd, 10), 8),
        ("aspect", lambda: ntt.aspect(Zd), 8),
        ("hillshade", lambda: ntt.hillshade(Zd, 10), 5),
        ("multiple_illumination", lambda: ntt.multiple_illumination(Zd, 10),
         5),
        ("pssm", lambda: ntt.pssm(Zd, 10), 4 + 32),
        ("curvature", lambda: ntt.curvature(Zd, 10), 8),
        ("esri_curvature", lambda: ntt.esri_curvature(Zd, 10), 4 + 12),
        ("zevenbergen_and_thorne_curvature",
         lambda: ntt.zevenbergen_and_thorne_curvature(Zd, 10), 4 + 24),
        ("evans_curvature", lambda: ntt.evans_curvature(Zd, 10), 4 + 24),
        ("wilson_gallant_curvature",
         lambda: ntt.wilson_gallant_curvature(Zd, 10), 4 + 16),
        ("scaled_morphometry lookup 1",
         lambda: ntt.scaled_morphometry(Zd, 10, 1), 4 + 32),
        ("scaled_morphometry lookup 50",
         lambda: ntt.scaled_morphometry(Zd, 10, 50), 4 + 32),
        ("vip_score", lambda: ntt.vip_score(Zd, 10), 8),
        ("std disk 5", lambda: ntt.std(Zd, fp5), 8),
        ("reduce_peaks radius 5", lambda: ntt.reduce_peaks(Zd, 5), 8),
        ("topographic_position_index radius 5",
         lambda: ntt.topographic_position_index(Zd, 5), 8),
        ("swiss_shading", lambda: ntt.swiss_shading(Zd, 10), 4 + 3),
        ("brassel_atmospheric_perspective",
         lambda: ntt.brassel_atmospheric_perspective(H, Zd, 2), 1 + 4 + 1),
        ("rasterGi star disk 5", lambda: ntt.rasterGi(Zd, fp5, star=True),
         4 + 12),
        ("rasterGi star disk 13", lambda: ntt.rasterGi(Zd, fp13, star=True),
         4 + 12),
        ("morans_i 3", lambda: ntt.morans_i(Zd, 3), 4),
        ("local_morans_i 3", lambda: ntt.local_morans_i(Zd, 3), 8),
        ("shi_landslides 5 13",
         lambda: ntt.shi_landslides(Zd, (5, 13), 10), 4 + 1),
    ]


def launches_of(call):
    """Kernel launches of one call by ``torch.profiler`` (CUDA activity;
    the process's first profiled window has run already)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset")))


def surface_timing(ntt, dev, Zd, card):
    """Phase 15: CUDA-event medians of TIMED_RUNS calls at 8192^2,
    cellsize 10, of the slice's functions; each with its launches per
    call (profiler), its peak memory above the input
    (``max_memory_allocated`` after a reset), its bytes-once bound (the
    input read and the outputs written once at the HBM rate) and time /
    bound."""
    H = ntt.hillshade(Zd, 10)
    rows = {}
    for name, call, bpp in timed_products(ntt, Zd, H):
        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(TIMED_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = statistics.median(times)
        bound_ms = bpp * Zd.numel() / PEAK_HBM_BYTES * 1e3
        rows[name] = {"ms": ms, "launches": launches_of(call),
                      "peak_mib": peak / 2**20, "bound_ms": bound_ms,
                      "bytes_per_pixel": bpp, "over_bound": ms / bound_ms}
    emit(phase="surface_timing", shape=list(MAIN_SHAPE), card=card,
         runs=TIMED_RUNS, functions=rows)


# ----------------------------------------------------------------------
# BASELINE config 5: the sharded SMRF (plain torch ops on the card, none
# of K1-K5) and the out-of-core mosaic stream (its tile program launches
# K1 for the classes and K2 for the openness pair)
# ----------------------------------------------------------------------
SHARDED_ZPRO_TOL = 1e-3        # tests/test_torch_dist_smrf.py
SHARDED_FILL_TOL = 1e-3        # of the f64 fill, as inpaint_scale's f32 one
MOSAIC_SIDES = (32768, 24576, 16384)   # the first that fits on the disk
MOSAIC_PX_BYTES = 4 + 1 + 1 + 4        # DEM + classes + objects + Moran
MOSAIC_KW = dict(cellsize=1, lookup_pixels=25, threshold_angle=1,
                 windows=5, slope_threshold=.15, gi_radius=3,
                 tile_size=4096, wire="exact", device_input=False)
MOSAIC_OUT_DTYPES = (np.uint8, bool, np.float32)
MOSAIC_WINDOW = 2048           # three interior windows recomputed untiled
MORAN_TOL = 1e-5               # tests/test_torch_tiling.py
SIX = ("geomorphons", "objects", "moran", "gi", "openness_pos",
       "openness_neg")
# lookup 31: overlap 31, a 4158^2 tile (W % 4 = 2), K1's and K2's cp.async
# load; mosaic_path's lookup 25 gives overlap 30 (the ladder's 2 * 15), a
# 4156^2 tile and the TMA load
VS_PLAIN_KW = dict(cellsize=1, lookup_pixels=31, threshold_angle=1,
                   windows=5, gi_radius=3, tile_size=4096, products=SIX)
VS_PLAIN_CROP = 1024


def sharded_smrf_path(ntt, cuda_scan, dev, cloud, single_prof, fills):
    """Phase 16: ``dist.sharded_smrf`` on a 2 x 2 mesh naming this card
    four times against ``smrf`` fast on smrf_path's 5M-point tile (cellsize
    1, windows 18): object cells and point labels equal on >= 99.9%,
    ``Zpro`` within 1e-3; each call's stages on CUDA events (CG iterations
    and host syncs per fill) in this run; K1-K5 counted 0 over the sharded
    call; one ``torch.profiler`` pass of it (launches, idle share; the
    single call's is smrf_path's).  Then ``sharded_progressive_filter`` bit
    for bit ``progressive_filter`` on the filled 2001^2 surface, windows
    1-18, and ``sharded_springs_fill`` on inpaint_scale's 4096^2 holed
    raster within 1e-3 of the float64 fill, as the single f32 fill is."""
    from neilpy_tpu_torch.dist.smrf import _sharded_fill, _sharded_smrf_run
    from neilpy_tpu_torch.ops import inpaint, pointgrid
    from neilpy_tpu_torch.pipelines.smrf import _smrf_run
    x, y, z = cloud
    n = x.size
    mesh = ntt.dist.make_mesh([dev] * 4)
    xs, ys, zs, *_ = lidar_tile(6, MID_POINTS, MID_SIDE)  # warm-up
    ntt.dist.sharded_smrf(xs, ys, zs, mesh=mesh, **SMRF_KW)
    torch.cuda.synchronize()

    single_clock = StageClock()
    Zp, t, cells, pts = _smrf_run(
        x, y, z, precision="fast", mark=single_clock, chunk_points=n,
        low_filter_slope=5, low_outlier_fill=False, return_extras=False,
        device=dev, **SMRF_KW)
    reset_counts(cuda_scan)
    clock = StageClock()
    sZp, st, scells, spts = _sharded_smrf_run(
        x, y, z, SMRF_KW["cellsize"], SMRF_KW["windows"],
        SMRF_KW["slope_threshold"], SMRF_KW["elevation_threshold"],
        SMRF_KW["elevation_scaler"], 5, False, mesh, ("ty", "tx"), 1e-7,
        4000, 256, mark=clock)
    counts = read_counts(cuda_scan)
    check(not any(counts.values()),
          f"sharded_smrf launched {counts}: it runs none of K1-K5")
    stages, single_stages = clock.stages(), single_clock.stages()
    wall = clock.marks[0][1].elapsed_time(clock.marks[-1][1])
    single_wall = single_clock.marks[0][1].elapsed_time(
        single_clock.marks[-1][1])
    check(tuple(st) == tuple(t) and sZp.shape == Zp.shape
          and spts.shape == (n,) and spts.is_cuda,
          "sharded_smrf: frame, shape or device differs")
    cells_agree = float((scells == cells).double().mean())
    pts_agree = float((spts == pts).double().mean())
    zpro_err = float((sZp - Zp).abs().max())
    check(cells_agree >= 0.999 and pts_agree >= 0.999,
          f"sharded_smrf agrees with smrf on {cells_agree:.5f} of the "
          f"cells and {pts_agree:.5f} of the points (need >= 0.999)")
    check(zpro_err <= SHARDED_ZPRO_TOL,
          f"sharded Zpro: max |diff| {zpro_err} above {SHARDED_ZPRO_TOL}")
    _, prof = device_profile(lambda: ntt.dist.sharded_smrf(
        x, y, z, mesh=mesh, **SMRF_KW))

    Zmin, _ = pointgrid.create_dem(x, y, z, cellsize=1, bin_type="min",
                                   device=dev)
    Zf = inpaint.springs_fill(Zmin)
    windows = np.arange(1, SMRF_KW["windows"] + 1)
    pf = ntt.progressive_filter(Zf, windows, 1, .15, device=dev)
    spf = ntt.dist.sharded_progressive_filter(Zf, windows, mesh, 1, .15)
    check(torch.equal(pf, spf), "sharded_progressive_filter differs from "
                                "progressive_filter")

    Zh, f32, f64 = fills
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    sfill, info = _sharded_fill(Zh, mesh, ("ty", "tx"), 1e-7, 4000, 256)
    stop.record()
    stop.synchronize()
    fill_err = float((sfill.double() - f64).abs().max())
    known = ~torch.isnan(Zh)
    check(torch.equal(sfill[known], Zh[known]),
          "the sharded fill changed a known cell")
    check(fill_err <= SHARDED_FILL_TOL,
          f"sharded fill vs the f64 fill: max |diff| {fill_err} above "
          f"{SHARDED_FILL_TOL}")
    emit(phase="sharded_smrf_path", mesh=[2, 2], points=n,
         grid=list(Zp.shape), windows=SMRF_KW["windows"],
         launches_by_kernel=counts,
         wall_ms={"sharded": wall, "single": single_wall,
                  "ratio": wall / single_wall},
         stages_sharded=stages, stages_single=single_stages,
         profile_sharded=prof, profile_single=single_prof,
         launch_ratio=prof["launches"] / single_prof["launches"],
         cell_agreement=cells_agree, label_agreement=pts_agree,
         zpro_max_abs_diff=zpro_err, progressive_filter_bit_identical=True,
         springs_fill_4096=dict(
             ms=start.elapsed_time(stop), **info,
             max_abs_diff_vs_f64=fill_err,
             max_abs_diff_vs_single_f32=float((sfill - f32).abs().max())))


def write_mosaic_dem(path, side, dev, band=2048, seed=0):
    """bench_input's recipe at ``side``^2 straight into an ``np.memmap``:
    seeded normals drawn on the card in row bands, summed along columns
    (carried across bands) and along rows, each band copied out as it is
    made, so host memory holds one band."""
    Z = np.memmap(path, dtype=np.float32, mode="w+", shape=(side, side))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    carry = torch.zeros(side, device=dev)
    for r0 in range(0, side, band):
        e = torch.randn((min(band, side - r0), side), generator=g,
                        device=dev)
        down = torch.cumsum(e, dim=0) + carry
        carry = down[-1].clone()
        Z[r0:r0 + e.shape[0]] = (down + torch.cumsum(e, dim=1)).cpu().numpy()
    Z.flush()
    del Z


def mosaic_arrays(spec, mode):
    """The DEM (read-only) and the three output memmaps of ``spec``."""
    side = spec["side"]
    Z = np.memmap(spec["dem"], dtype=np.float32, mode="r",
                  shape=(side, side))
    outs = tuple(np.memmap(p, dtype=dt, mode=mode, shape=(side, side))
                 for p, dt in zip(spec["outs"], MOSAIC_OUT_DTYPES))
    return Z, outs


def mosaic_child(arg):
    """``--mosaic-child <spec>``: mosaic_path's run to be killed, the
    spec's mosaic into its memmaps with its checkpoint."""
    import neilpy_tpu_torch as ntt
    spec = json.loads(arg)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    Z, outs = mosaic_arrays(spec, "r+")
    ntt.mosaic_terrain_products(Z, checkpoint=spec["checkpoint"], out=outs,
                                device=dev, **spec["kw"])
    return 0


def crc_of(arrays, band=2048):
    """CRC-32 of arrays' bytes, in row bands (mosaic outputs on disk)."""
    crc = 0
    for a in arrays:
        for r0 in range(0, a.shape[0], band):
            crc = zlib.crc32(np.ascontiguousarray(
                a[r0:r0 + band]).view(np.uint8).data, crc)
    return crc


@contextlib.contextmanager
def recorded_loads(cuda_scan, seen):
    """Within the block, every tile-path launch records its array's shape
    and load path (``cuda_scan._tile_load``: 1 TMA, 0 cp.async) in
    ``seen``."""
    real = cuda_scan._tile_load

    def rec(Z):
        load = real(Z)
        seen.append((tuple(Z.shape), load))
        return load

    cuda_scan._tile_load = rec
    try:
        yield
    finally:
        cuda_scan._tile_load = real


def mosaic_path(ntt, cuda_scan, dev, tmp, card):
    """Phase 17: the out-of-core mosaic disk to disk.  A seeded
    32768^2 float32 DEM (``write_mosaic_dem``, 4.3 GB; 24576^2 or 16384^2
    where the disk is short, the cut printed first) in an ``np.memmap``,
    the default trio (geomorphons, objects, moran) at lookup 25, windows
    5, gi_radius 3, tile 4096, exact wire, streamed (``device_input=
    False``) into three output memmaps.  A child process runs it with a
    checkpoint and is SIGKILLed once the checkpoint lists half the tiles;
    the run resumes here (K1 counted: one launch per remaining tile, on
    the TMA load); the outputs' CRC is kept, an uninterrupted run without
    checkpoint rewrites them under one ``torch.profiler`` pass (K1 one
    launch per tile, idle share) and must give the same CRC; then three
    random interior 2048^2 windows recomputed from the DEM with the
    untiled functions on the card: classes and objects equal, Moran
    within 1e-5.  Returns each kernel's launches on the counted run."""
    import shutil
    import signal
    free = shutil.disk_usage(tmp).free
    fits = [s for s in MOSAIC_SIDES if 1.05 * s * s * MOSAIC_PX_BYTES < free]
    check(bool(fits), f"{free / 1e9:.1f} GB free at {tmp}: no mosaic fits")
    side = fits[0]
    if side != MOSAIC_SIDES[0]:
        emit(phase="mosaic_cut", side=side, wanted=MOSAIC_SIDES[0],
             free_gb=free / 1e9, needed_gb=1.05 * MOSAIC_SIDES[0] ** 2
             * MOSAIC_PX_BYTES / 1e9)
    ts = MOSAIC_KW["tile_size"]
    n_tiles = (-(-side // ts)) ** 2
    ov = ntt.pipelines.mosaic.required_overlap(
        MOSAIC_KW["lookup_pixels"], np.arange(1, MOSAIC_KW["windows"] + 1),
        MOSAIC_KW["gi_radius"])
    spec = dict(side=side, device=str(dev), kw=MOSAIC_KW,
                dem=str(Path(tmp) / "dem.f32"),
                outs=[str(Path(tmp) / f"{p}.out") for p in
                      ("classes", "objects", "moran")],
                checkpoint=str(Path(tmp) / "mosaic.json"))
    t0 = time.perf_counter()
    write_mosaic_dem(spec["dem"], side, dev)
    dem_s = time.perf_counter() - t0
    Z, outs = mosaic_arrays(spec, "w+")
    del outs

    log = Path(tmp) / "child.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        child = subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--mosaic-child",
             json.dumps(spec)], cwd=HERE, stdout=f, stderr=subprocess.STDOUT)
    try:
        while child.poll() is None and time.perf_counter() - t0 < 300:
            try:
                with open(spec["checkpoint"]) as f:
                    if len(json.load(f)) >= n_tiles // 2:
                        break
            except (FileNotFoundError, json.JSONDecodeError):
                pass
            time.sleep(0.02)
        child.send_signal(signal.SIGKILL)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
    to_kill_s = time.perf_counter() - t0
    tail = log.read_text()[-2000:]
    check(child.returncode == -signal.SIGKILL,
          f"the mosaic child ended by itself (rc {child.returncode}): {tail}")
    ckpt = ntt.TileCheckpoint(spec["checkpoint"])
    done = len(ckpt.done)
    check(0 < done < n_tiles, f"killed with {done} of {n_tiles} tiles done")

    Z, outs = mosaic_arrays(spec, "r+")
    reset_counts(cuda_scan)
    loads, resumed_ps = [], {}
    t0 = time.perf_counter()
    with recorded_loads(cuda_scan, loads):
        ntt.mosaic_terrain_products(Z, checkpoint=spec["checkpoint"],
                                    out=outs, phase_stats=resumed_ps,
                                    device=dev, **MOSAIC_KW)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resumed = read_counts(cuda_scan)
    check(resumed["K1"] == n_tiles - done
          and sum(resumed.values()) == resumed["K1"],
          f"the resumed run launched {resumed}: one K1 per remaining tile")
    check(len(ntt.TileCheckpoint(spec["checkpoint"]).done) == n_tiles,
          "the resumed run left tiles unmarked")
    check({s for s, _ in loads} == {(ts + 2 * ov,) * 2}
          and {lo for _, lo in loads} == {1},
          f"mosaic_path's K1 tiles took {set(loads)}: expected TMA on "
          f"{ts + 2 * ov}^2")
    for o in outs:
        o.flush()
    crc_resumed = crc_of(outs)

    reset_counts(cuda_scan)
    full_ps = {}
    _, prof = device_profile(lambda: ntt.mosaic_terrain_products(
        Z, out=outs, phase_stats=full_ps, device=dev, **MOSAIC_KW))
    launches = read_counts(cuda_scan)
    check(launches["K1"] == n_tiles
          and sum(launches.values()) == n_tiles,
          f"the uninterrupted mosaic launched {launches}: one K1 per tile")
    for o in outs:
        o.flush()
    check(crc_of(outs) == crc_resumed,
          "the killed-and-resumed mosaic differs from the uninterrupted one")

    with open(spec["checkpoint"] + ".moments") as f:
        mom = json.load(f)
    rng = np.random.default_rng(11)
    windows = np.arange(1, MOSAIC_KW["windows"] + 1)
    w = MOSAIC_WINDOW
    checked = []
    for _ in range(3):
        r0, c0 = (int(v) for v in rng.integers(ov, side - ov - w, 2))
        blk = torch.from_numpy(np.array(Z[r0 - ov:r0 + w + ov,
                                          c0 - ov:c0 + w + ov])).to(dev)
        core = np.s_[ov:ov + w, ov:ov + w]
        G = ntt.geomorphons(blk, 1, MOSAIC_KW["lookup_pixels"], 1)[core]
        O = ntt.progressive_filter(blk, windows, 1, .15)[core]
        M = ntt.local_morans_i(blk, MOSAIC_KW["gi_radius"], mean=mom["mean"],
                               s2=mom["s2"])[core]
        sl = np.s_[r0:r0 + w, c0:c0 + w]
        check(np.array_equal(G.cpu().numpy(), outs[0][sl]),
              f"mosaic classes differ from geomorphons at {r0, c0}")
        check(np.array_equal(O.cpu().numpy(), outs[1][sl]),
              f"mosaic objects differ from progressive_filter at {r0, c0}")
        merr = float(np.nanmax(np.abs(M.cpu().numpy() - outs[2][sl])))
        check(np.array_equal(np.isnan(M.cpu().numpy()), np.isnan(outs[2][sl]))
              and merr <= MORAN_TOL,
              f"mosaic Moran at {r0, c0}: max |diff| {merr}")
        checked.append({"at": [r0, c0], "moran_max_abs_diff": merr})
    px = side * side
    emit(phase="mosaic_path", card=card, side=side, tiles=n_tiles,
         tile=ts + 2 * ov, overlap=ov, dem_write_s=dem_s,
         killed_at_tiles=done, child_to_kill_s=to_kill_s,
         resumed=dict(seconds=resume_s, tiles=n_tiles - done,
                      mpix_s=(n_tiles - done) * ts * ts / resume_s / 1e6,
                      phase_stats=resumed_ps, launches_by_kernel=resumed),
         uninterrupted=dict(mpix_s=px / prof["wall_ms"] * 1e3 / 1e6,
                            phase_stats=full_ps, launches_by_kernel=launches,
                            profile=prof,
                            moments_and_setup_s=prof["wall_ms"] / 1e3
                            - full_ps["total"]),
         k1_tile_load="tma", resume_equals_uninterrupted=True,
         windows_checked=checked)
    return {"K1": launches["K1"], "K2": launches["K2"]}


def tuple_readback(ntt, dev, timeout=120.0):
    """``tiled_apply`` on the card with ``fn`` returning k float32 planes
    of one shape (k = 2 and 4) over 16 streamed tiles at pipeline depths 0
    and 2: every plane equal to the host's product, and no wait for a
    readback buffer that only a stored tile could return (a call that has
    not returned after ``timeout`` seconds fails the run).  Returns the
    cases run."""
    import threading
    Z = np.random.default_rng(5).standard_normal((256, 256)).astype(
        np.float32)
    cases = []
    for k in (2, 4):
        for depth in (0, 2):
            box = {}

            def call():
                box["out"] = ntt.tiled_apply(
                    lambda t: tuple(t * (i + 1) for i in range(k)), Z, 64, 4,
                    pipeline_depth=depth, device_input=False, device=dev)

            th = threading.Thread(target=call, daemon=True)
            th.start()
            th.join(timeout)
            check(not th.is_alive(),
                  f"tiled_apply with {k} results per tile at depth {depth} "
                  f"has not returned after {timeout} s")
            check("out" in box and all(
                np.array_equal(g, Z * (i + 1)) for i, g in enumerate(
                    box["out"])), f"tiled_apply's {k} results per tile at "
                  f"depth {depth} differ from the host's")
            cases.append([k, depth])
    return cases


def mosaic_vs_plain(ntt, cuda_scan, dev, card):
    """Phase 18: all six products at 8192^2 (bench_input), lookup 31
    (overlap 31: 4158^2 tiles, the cp.async load), windows 5, gi_radius 3,
    tile 4096: the streamed run (K1 and K2 counted: one launch each per
    tile, every tile on cp.async), the device-resident run and a one-card
    2 x 2 mesh equal to it bit for bit, the compact wire equal where it is
    exact (classes, objects, Gi bins) and the bf16 rounding of the exact
    wire elsewhere, and on a 1024^2 crop (tile 512) the card against the
    CPU's plain versions: classes, objects and Gi bins equal, Moran within
    1e-5, openness within 5e-5 degrees.  Then K1 and K2 timed on one
    mosaic tile each (mosaic_path's 4156^2 at lookup 25, this phase's
    4158^2 at lookup 31) against their plain versions, with bounds.
    ``tuple_readback`` runs after the warm-up."""
    from neilpy_tpu_torch.pipelines.mosaic import (_bf16_bits, _bf16_to_f32,
                                                   required_overlap)
    Z = bench_input(MAIN_SHAPE)
    kw = dict(VS_PLAIN_KW, device=dev)
    ts = kw["tile_size"]
    n_tiles = (-(-MAIN_SHAPE[0] // ts)) * (-(-MAIN_SHAPE[1] // ts))

    def same(a, b):
        return a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f")

    walls = {}

    def run(name, Zin, **extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ntt.mosaic_terrain_products(Zin, **{**kw, **extra})
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    run("warm-up", Z[:1024, :1024], tile_size=512)
    readback_cases = tuple_readback(ntt, dev)
    reset_counts(cuda_scan)
    loads = []
    with recorded_loads(cuda_scan, loads):
        A = run("streamed", Z, device_input=False)
    counts = read_counts(cuda_scan)
    check(counts["K1"] == n_tiles and counts["K2"] == n_tiles
          and sum(counts.values()) == 2 * n_tiles,
          f"the six-product mosaic launched {counts}: one K1 and one K2 "
          "per tile")
    tile = ts + 2 * kw["lookup_pixels"]
    check(set(loads) == {((tile, tile), 0)},
          f"mosaic_vs_plain's tiles took {set(loads)}: expected cp.async "
          f"on {tile}^2")
    for name, extra in (("resident", dict(device_input="auto")),
                        ("mesh_2x2", dict(mesh=ntt.dist.make_mesh(
                            [dev] * 4)))):
        got = run(name, Z, **extra)
        check(all(same(a, b) for a, b in zip(got, A)),
              f"the {name} mosaic differs from the streamed one")
        del got
    C = run("compact", Z, wire="compact")
    for i, p in enumerate(SIX):
        exact = p in ("geomorphons", "objects", "gi")
        if exact:
            ok = same(C[i], A[i])
        else:
            bf = _bf16_bits(torch.from_numpy(A[i]))
            ok = same(C[i], _bf16_to_f32(bf.numpy().view(np.uint16)))
        check(ok, f"compact {p} is not the exact wire's "
                  f"{'value' if exact else 'bf16 rounding'}")
    del A, C

    crop = np.ascontiguousarray(Z[:VS_PLAIN_CROP, :VS_PLAIN_CROP])
    on_card = run("crop_card", crop, tile_size=512)
    on_cpu = run("crop_cpu", crop, tile_size=512, device="cpu")
    errs = {}
    for p, a, b in zip(SIX, on_card, on_cpu):
        if p in ("geomorphons", "objects", "gi"):
            check(same(a, b), f"crop {p}: card != CPU")
            continue
        check(np.array_equal(np.isnan(a), np.isnan(b))
              and np.array_equal(np.isinf(a), np.isinf(b)),
              f"crop {p}: NaN/inf at other pixels")
        fin = np.isfinite(a)
        errs[p] = float(np.max(np.abs(a[fin] - b[fin]))) if fin.any() else 0.
        tol = MORAN_TOL if p == "moran" else OPENNESS_TOL
        check(errs[p] <= tol, f"crop {p}: card vs CPU {errs[p]} above {tol}")

    tiles = {}
    mosaic_tile = MOSAIC_KW["tile_size"] + 2 * required_overlap(
        MOSAIC_KW["lookup_pixels"], np.arange(1, MOSAIC_KW["windows"] + 1),
        MOSAIC_KW["gi_radius"])
    for kid, lookup, side, mode in (
            ("K1", MOSAIC_KW["lookup_pixels"], mosaic_tile, None),
            ("K2", VS_PLAIN_KW["lookup_pixels"], tile, "openness")):
        Zt = torch.from_numpy(np.ascontiguousarray(Z[:side, :side])).to(dev)
        if mode is None:
            fns = {"kernel": cuda_scan.openness_counts_cuda,
                   "plain": cuda_scan.openness_counts_torch}
            call = lambda f: f(Zt, cellsize=1.0, lookup_pixels=lookup,
                               threshold_angle=1.0)
            nbytes, fold = 6 * side * side, 0
        else:
            fns = {"kernel": cuda_scan.openness_reduced_cuda,
                   "plain": cuda_scan.openness_reduced_torch}
            call = lambda f: f(Zt, "openness", cellsize=1.0,
                               lookup_pixels=lookup)
            nbytes = 12 * side * side
            fold = fold_ops("openness", side * side)
        got, want = call(fns["kernel"]), call(fns["plain"])
        if mode is None:
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{kid} on the {side}^2 mosaic tile != plain")
        else:
            reduced_err(cuda_scan, mode, got, want,
                        f"{kid} on the {side}^2 mosaic tile")
        times = time_turns(fns, call)
        bound_ms, side_by = bound(ladder_steps(
            side, side, cuda_scan._ladder(lookup)), nbytes, fold)
        tiles[kid] = dict(
            tile=[side, side], lookup=lookup, ladder="exact",
            route="dynamic", tile_load="tma" if cuda_scan._tile_load(Zt)
            else "cp.async", tile_ms=statistics.median(times["kernel"]),
            tile_plain_ms=statistics.median(times["plain"]),
            tile_bound_ms=bound_ms, tile_bound_by=side_by,
            vs_plain_launches=counts[kid])
    emit(phase="mosaic_vs_plain", card=card, shape=list(MAIN_SHAPE),
         products=list(SIX), tile=tile, launches_by_kernel=counts,
         walls_s=walls, crop=VS_PLAIN_CROP, crop_max_abs_diff=errs,
         tiles=tiles, tuple_readback_k_depth=readback_cases)
    return tiles


def main():
    if sys.argv[1:2] == ["--mosaic-child"]:
        return mosaic_child(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import neilpy_tpu_torch as ntt
    from neilpy_tpu_torch import _build
    from neilpy_tpu_torch.ops import cuda_scan
    check(Path(ntt.__file__).resolve().parent == HERE / "neilpy_tpu_torch",
          f"imported {ntt.__file__}, not this checkout's package")
    check("jax" not in sys.modules and "neilpy_tpu" not in sys.modules,
          "the port must not import jax or neilpy_tpu")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = card_line()
    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), card=card)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    emit(phase="build", seconds=time.perf_counter() - t0,
         library=str(lib.relative_to(HERE)),
         ptxas=_build.ptxas_summary(lib.with_suffix(".log").read_text()))

    walls = {}  # seconds of each phase, where the script's time goes

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        return out

    phase("host_build", host_build)

    max_err = phase("kernel_vs_plain", kernel_vs_plain, cuda_scan, dev)
    for kid, err in phase("routes_vs_plain", routes_vs_plain, cuda_scan,
                          dev).items():
        max_err[kid] = max(max_err.get(kid, 0), err)
    err = phase("tile_reaches_vs_plain", tile_reaches_vs_plain, cuda_scan,
                dev)
    for kid, kind in (("K1", "counts"), ("K5/counts", "counts"),
                      ("K3", "planes"), ("K4", "counts"),
                      ("K2", "reduced"), ("K5/reduced", "reduced")):
        max_err[kid] = max(max_err[kid], err[kind])
    phase("oracle", oracle_check, ntt, dev)
    with tempfile.TemporaryDirectory() as tmp:
        Z, dem = write_dem(ntt, tmp)
        Zd, main_counts, G, G_fast = phase(
            "main_path", main_path, ntt, cuda_scan, dev, tmp, Z, dem)
        counts = phase("openness_path", openness_path, ntt, cuda_scan, dev,
                       tmp, Z, dem)
        codec_counts = phase("codec_path", codec_path, ntt, cuda_scan, dev,
                             tmp, Z, G, G_fast, card)
    share = maskless_share(cuda_scan, Zd)
    sharded_counts, mesh, block_errs = phase(
        "sharded_path", sharded_path, ntt, cuda_scan, dev, Zd, G, G_fast)
    del G, G_fast
    for kid, err in [*block_errs.items(),
                     *phase("full_size_vs_plain", full_size_vs_plain,
                            cuda_scan, Zd).items()]:
        max_err[kid] = max(max_err[kid], err)
    res = phase("timings", timings, ntt, cuda_scan, Zd, mesh, card, share)
    cloud, smrf_prof = phase("smrf_path", smrf_path, ntt, cuda_scan, dev)
    fills = phase("inpaint_scale", inpaint_scale, ntt, dev)
    phase("smrf_oracle", smrf_oracle, ntt, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase("las_path", las_path, ntt, dev, tmp, cloud)
    phase("sharded_smrf_path", sharded_smrf_path, ntt, cuda_scan, dev,
          cloud, smrf_prof, fills)
    del cloud, fills
    with tempfile.TemporaryDirectory() as tmp:
        Z, dem = write_dem(ntt, tmp)
        Zdem = phase("surface_path", surface_path, ntt, cuda_scan, dev,
                     tmp, dem)
    phase("surface_vs_plain", surface_vs_plain, ntt, dev, Z)
    del Z
    phase("sharded_surface", sharded_surface, ntt, dev, Zdem)
    phase("surface_timing", surface_timing, ntt, dev, Zdem, card)
    del Zdem
    with tempfile.TemporaryDirectory() as tmp:
        mosaic_launches = phase("mosaic_path", mosaic_path, ntt, cuda_scan,
                                dev, tmp, card)
    mosaic_tiles = phase("mosaic_vs_plain", mosaic_vs_plain, ntt, cuda_scan,
                         dev, card)
    emit(phase="walls", seconds=walls, total=sum(walls.values()))

    # each kernel's launches on the path that runs it
    launches = {"K1": main_counts["K1"],
                "K5/counts": main_counts["K5/counts"],
                "K2": counts["K2"], "K3": counts["K3"],
                "K3 origin": sharded_counts["K3"],
                "K5/reduced": counts["K5/reduced"],
                "K4": sharded_counts["K4"]}
    kernels = kernel_table(cuda_scan, res, launches, max_err, Zd,
                           sharded_blocks(Zd, mesh))
    for k in kernels:
        if codec_counts.get(k["id"]):
            k["codec_path_launches"] = codec_counts[k["id"]]
        if k["id"] in mosaic_tiles:
            tiles = dict(mosaic_tiles[k["id"]])
            k["mosaic"] = dict(launches={
                "mosaic_path": mosaic_launches[k["id"]],
                "mosaic_vs_plain": tiles.pop("vs_plain_launches")}, **tiles)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
