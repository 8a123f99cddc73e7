"""Openness, skyview factor, ternary codes and geomorphon terrain
classification (reference neilpy/neilpy.py:1325-1356 openness, 1360-1384
skyview_factor, 1404-1430 ternary_pattern_from_openness, 1600-1610
count_openness, 1617-1654 geomorphons, 1579-1596 geomorphons2).

PyTorch counterpart of ``neilpy_tpu/ops/visibility.py``, with the same
names and arguments; ``engine`` is ``'auto'`` / ``'cuda'`` / ``'torch'``
and ``device=`` says where numpy input goes (:func:`as_raster`).  The
ladder runs in ``ops/cuda_scan.py``: a CUDA kernel for a CUDA tensor, its
plain PyTorch version for a CPU tensor.  Which kernel each function
takes is the one its Pallas engine takes in the JAX package:

- counts (K1; on the exact ladder K5, its static region plan, the JAX
  package's default route): ``count_openness``, ``geomorphons``,
  ``geomorphons2`` with negative openness;
- the fused reduction (K2; K5 on the exact ladder): ``openness`` over all
  8 directions, ``openness_pair``, ``skyview_factor``,
  ``ternary_pattern_from_openness``;
- the extrema planes (K3): ``directional_ratio_extrema``, ``openness``
  over a ``neighbors`` subset, ``geomorphons2`` without negative
  openness.

The port follows the Pallas kernels' arithmetic, so counts, classes,
extrema and ternary codes equal them; on the test fixtures they also
equal the atan-space XLA path (only an f32 decision tie could differ),
and openness and skyview agree with both within the JAX package's own
engine tolerances (PERF.md).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .. import profiling
from ..core.codes import (geomorphon_cmap, jasiewicz_stepinski_table,
                          lowest_equivalent_table)
from ..core.device import to_device
from ..io.png import write_paletted_png
from ..io.worldfile import write_worldfile
from .cuda_scan import (_HALF_PI, _resolve_specialize, _threshold_tangent,
                        directional_extrema, openness_counts,
                        openness_degrees, openness_reduced, skyview_from_sum)

__all__ = ["openness", "openness_pair", "skyview_factor", "svf_from_extrema",
           "count_openness", "classes_from_counts", "geomorphons",
           "geomorphons2", "ternary_pattern_from_openness",
           "directional_ratio_extrema", "get_geomorphons",
           "get_geomorphon_from_openness"]


def as_raster(Z, device=None):
    """``Z`` as a contiguous float32 tensor, placed by the port's device
    rule (``core/device.py``): a tensor stays on its own device unless
    ``device`` is given, any other input goes to ``device`` (CUDA by
    default; without a CUDA device that raises rather than running on the
    CPU unasked — pass ``device='cpu'`` for the plain PyTorch version on
    the host)."""
    return to_device(Z, device, torch.float32).contiguous()


# ----------------------------------------------------------------------
# extrema planes (K3)
# ----------------------------------------------------------------------
def directional_ratio_extrema(Z, cellsize=1.0, lookup_pixels=1,
                              directions=tuple(range(8)), fast=False,
                              how_fast=20, origin=None, global_shape=None,
                              engine="auto", device=None):
    """Running max/min of the slope ratio over the scan ladder, per
    direction: ``(mx, mn, seen)``, each (n_directions, H, W), with
    ``seen = mx > -inf`` (False only where every ladder step hit NaN).
    The ratio rounds like the Pallas kernel, ``(src - Z) * (f32(inv_w) /
    f32(L))``; the JAX package's XLA path divides, within 1e-5.

    Shard blocks: ``origin`` is the global (row, col) of ``Z[0, 0]`` and
    ``global_shape`` the raster's, so the edge-replication epilogue is
    decided in global coordinates for every pixel of ``Z``, halo pixels
    too, while reads still end at ``Z``'s own edge.  A block carrying an
    R-wide halo of real neighbour data (NaN beyond the raster) then gives
    its core pixels the single-device extrema (``dist.sharded_openness``).
    """
    mx, mn = directional_extrema(
        as_raster(Z, device), cellsize=float(cellsize),
        lookup_pixels=int(lookup_pixels), fast=bool(fast),
        how_fast=int(how_fast), origin=origin, global_shape=global_shape,
        engine=engine)
    dirs = [int(d) for d in directions]
    if dirs != list(range(8)):
        mx, mn = mx[dirs], mn[dirs]
    return mx, mn, mx > -math.inf


def _angles_from_extrema(mx, seen):
    """Per-direction minimum zenith angle in radians: pi/2 - atan(mx),
    +inf where the ladder never saw a finite value."""
    return torch.where(seen, _HALF_PI - torch.atan(mx), math.inf)


# ----------------------------------------------------------------------
# public surface
# ----------------------------------------------------------------------
def openness(Z, cellsize=1, lookup_pixels=1, neighbors=None, skyview=False,
             fast=False, how_fast=20, engine="auto", device=None):
    """Yokoyama positive openness in degrees (neilpy.py:1325-1356): the
    mean over the requested directions of the minimum zenith angle along
    the scan ladder.  Negative openness is ``openness(-Z, ...)`` or the
    second plane of :func:`openness_pair`.

    All 8 directions take the fused reduction (K2); a ``neighbors``
    subset takes the extrema planes (K3) and the mean over the subset.
    ``skyview`` is accepted and ignored, as in the reference, whose body
    never reads it; use :func:`skyview_factor`."""
    Z = as_raster(Z, device)
    if neighbors is None:
        neighbors = range(8)
    dirs = tuple(int(d) for d in np.atleast_1d(np.asarray(neighbors)))
    if dirs == tuple(range(8)):
        pos, _ = openness_pair(Z, cellsize=cellsize,
                               lookup_pixels=lookup_pixels, fast=fast,
                               how_fast=how_fast, engine=engine)
        return pos
    mx, _, seen = directional_ratio_extrema(
        Z, cellsize=cellsize, lookup_pixels=lookup_pixels, directions=dirs,
        fast=fast, how_fast=how_fast, engine=engine)
    return torch.rad2deg(_angles_from_extrema(mx, seen).mean(dim=0))


def openness_pair(Z, cellsize=1, lookup_pixels=1, fast=False, how_fast=20,
                  engine="auto", specialize=None, device=None):
    """(positive, negative) openness in degrees from ONE ladder pass
    (K2, or K5's static plan of it): negative openness comes from the same
    ladder's ``mn``, so this is half the cost of ``openness(Z)`` +
    ``openness(-Z)``.  ``specialize`` picks the kernel on a CUDA tensor as
    the JAX package picks its route: True K5's static region plan, False
    K2's dynamic route, None the plan for the exact ladder and K2 for
    ``fast``.  The outputs are bit-identical either way; on the CPU the
    plain version runs and ``specialize`` changes nothing.  While a
    ``torch.profiler`` profile is open the call is the span
    ``visibility.openness_pair`` (:func:`_reduced_span`)."""
    with _reduced_span("visibility.openness_pair", Z, device, engine,
                       specialize, fast) as Z:
        return openness_degrees(*openness_reduced(
            Z, "openness", cellsize=float(cellsize),
            lookup_pixels=int(lookup_pixels), fast=bool(fast),
            how_fast=int(how_fast), engine=engine, specialize=specialize))


def skyview_factor(Z, cellsize=1, lookup_pixels=1, engine="auto",
                   device=None):
    """Skyview factor: 1 - mean_d sin(atan(max(mx_d, 0)))
    (neilpy.py:1360-1384), with sin(atan(t)) = t/sqrt(1+t^2), from the
    fused reduction (K2; K5's static plan of it, the ladder being exact).
    The max over the ladder's valid steps equals the reference loop's
    frozen-exit-elevation quirk (see the JAX package's docstring).  While
    a ``torch.profiler`` profile is open the call is the span
    ``visibility.skyview_factor`` (:func:`_reduced_span`)."""
    with _reduced_span("visibility.skyview_factor", Z, device, engine,
                       None, False) as Z:
        (s,) = openness_reduced(
            Z, "svf", cellsize=float(cellsize),
            lookup_pixels=int(lookup_pixels), engine=engine)
        return skyview_from_sum(s)


@contextlib.contextmanager
def _reduced_span(name, Z, device, engine, specialize, fast):
    """Yield ``as_raster(Z, device)`` inside the root span ``name`` of a
    fused-reduction call, with the child ``visibility.as_raster``; the
    root's ``attr`` is the route the call takes: ``'plan'`` (K5),
    ``'dynamic'`` (K2) or ``'torch'`` (the plain version).  Its launch's
    ``cuda_scan.launch`` span sits under it."""
    with profiling.span(name) as call:
        with profiling.span("visibility.as_raster"):
            Z = as_raster(Z, device)
        if call is not None:
            if engine == "torch" or (engine == "auto" and not Z.is_cuda):
                call.attr = "torch"
            else:
                call.attr = ("plan" if _resolve_specialize(specialize, False,
                                                           fast)
                             else "dynamic")
        yield Z


def svf_from_extrema(mx):
    """SVF from per-direction max ratios ``mx`` (n, H, W): 1 - mean
    sin(atan(max(t, 0))) with sin(atan(t)) = t/sqrt(1+t^2); the clip at 0
    also absorbs unseen rays (mx = -inf)."""
    t = mx.clamp(min=0.0)
    return 1.0 - (t / torch.sqrt(1.0 + t * t)).mean(dim=0)


def count_openness(Z, cellsize, lookup_pixels, threshold_angle, fast=False,
                   how_fast=20, engine="auto", device=None):
    """Per-pixel counts of directions whose (positive - negative)
    openness difference exceeds +/- threshold (neilpy.py:1600-1610), as
    uint8 tensors ``(num_pos, num_neg)`` (K1)."""
    return openness_counts(
        as_raster(Z, device), cellsize=float(cellsize),
        lookup_pixels=int(lookup_pixels),
        threshold_angle=float(threshold_angle), fast=bool(fast),
        how_fast=int(how_fast), engine=engine)


def classes_from_counts(num_pos, num_neg):
    """J&S 9x9 table lookup: class = table[num_pos, num_neg], a gather
    on the 81-entry table."""
    with profiling.span("visibility.classes_from_counts",
                        device=num_pos.device):
        tbl = torch.from_numpy(jasiewicz_stepinski_table().ravel())
        idx = num_pos.long() * 9 + num_neg.long()
        return tbl.to(num_pos.device)[idx]


def geomorphons(Z, cellsize=1, lookup_pixels=1, threshold_angle=1,
                enhance=False, fast=False, how_fast=20, engine="auto",
                device=None):
    """Geomorphon classes 1-10 (uint8 tensor) from openness counts + the
    J&S 9x9 lookup (neilpy.py:1617-1654), with the optional 'enhance'
    correction-of-forms second pass.  While a ``torch.profiler`` profile
    is open the call is the span ``visibility.geomorphons``
    (``profiling.span``), its launches and class lookups spans inside it.
    """
    with profiling.span("visibility.geomorphons"):
        with profiling.span("visibility.as_raster"):
            Z = as_raster(Z, device)

        def classes(lp, f=False):
            num_pos, num_neg = openness_counts(
                Z, cellsize=float(cellsize), lookup_pixels=int(lp),
                threshold_angle=float(threshold_angle), fast=f,
                how_fast=int(how_fast), engine=engine)
            return classes_from_counts(num_pos, num_neg)

        G = classes(lookup_pixels, bool(fast))
        if enhance and lookup_pixels > 16:
            G_sm = classes(max(int(np.floor(lookup_pixels / 4)), 4))
            G = G.masked_fill((G == 4) & (G_sm == 1), 1)
            G = G.masked_fill((G == 8) & (G_sm == 1), 1)
            G = torch.where((G == 2) | (G == 3), G_sm, G)
        return G


# Aliases used in the reference notebooks
get_geomorphons = geomorphons
get_geomorphon_from_openness = geomorphons


def ternary_pattern_from_openness(Z, cellsize=1, lookup_pixels=1,
                                  threshold_angle=0,
                                  use_negative_openness=True, lowest=False,
                                  engine="auto", device=None):
    """8-direction ternary code packed base-3 into uint16
    (neilpy.py:1404-1430): direction i contributes digit {0: lower,
    1: equal, 2: higher} * 3**i, decided exactly in tangent space by the
    fused reduction (K2).  ``lowest`` maps each code to its lowest
    rotational/reflectional equivalent (a 6561-entry gather)."""
    (tc,) = openness_reduced(
        as_raster(Z, device), "ternary", cellsize=float(cellsize),
        lookup_pixels=int(lookup_pixels),
        threshold_angle=float(threshold_angle),
        neg_mode=bool(use_negative_openness), engine=engine)
    if lowest:
        # gathered as int32 and converted back: uint16 is a storage type
        tbl = torch.from_numpy(lowest_equivalent_table().astype(np.int32))
        tc = tbl.to(tc.device)[tc.long()].to(torch.uint16)
    return tc


def geomorphons2(Z, cellsize=1, lookup_pixels=5, threshold_angle=1,
                 use_negative_openness=True, method="loose", outfile=None,
                 out_transform=None, engine="auto", device=None):
    """Geomorphons via ternary pattern -> class (neilpy.py:1579-1596),
    with an optional paletted PNG + worldfile.

    The 'loose' class depends only on the per-direction digit counts,
    which rotations and reflections preserve, so the pipeline collapses
    to counts + the J&S table, as in the JAX package (which likewise
    reads no other ``method``).  With negative openness the digit counts
    are the geomorphon counts (K1); without it, the extrema planes (K3)
    are thresholded in tangent space: O = pos - 90 = -atan(mx), so
    O > t <=> mx < -tan t, and an unseen direction counts as '2'."""
    Z = as_raster(Z, device)
    if use_negative_openness:
        num2, num0 = openness_counts(
            Z, cellsize=float(cellsize), lookup_pixels=int(lookup_pixels),
            threshold_angle=float(threshold_angle), engine=engine)
    else:
        mx, _, seen = directional_ratio_extrema(
            Z, cellsize=cellsize, lookup_pixels=lookup_pixels, engine=engine)
        T = _threshold_tangent(threshold_angle)
        num2 = ((mx < -T) | ~seen).sum(dim=0, dtype=torch.uint8)
        num0 = (seen & (mx > T)).sum(dim=0, dtype=torch.uint8)
    G = classes_from_counts(num2, num0)
    if outfile is not None:
        write_paletted_png(outfile, G.cpu().numpy(), geomorphon_cmap())
        if out_transform is not None:
            write_worldfile(out_transform, outfile[:-3] + "pgw")
    return G
