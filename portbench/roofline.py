"""Roofline arithmetic of the openness ladder, from published peaks.

Copied from ``chip_smoke.py`` (``PEAK_F32_OPS``, ``PEAK_HBM_BYTES``,
``OPS_PER_STEP``, ``ladder_steps``, ``bound``) so that the yardstick
cannot move with the program; ``ladder`` is the copy of the program's
scan distances (``core/codes.py:progressive_window`` for the fast
ladder), kept in ``reference/plain.py``.
"""

from __future__ import annotations

from .reference.plain import OFFSETS, scan_ladder

# the H100 SXM's published rates (NVIDIA's data sheet, at its 700 W
# limit): float32 outside the tensor cores, 67 TFLOP/s counting an FMA as
# two operations, so 33.5e12 single f32 instructions per second; and HBM3
PEAK_F32_OPS = 67e12 / 2
PEAK_HBM_BYTES = 3.35e12
OPS_PER_STEP = 4               # sub, mul, max, min per ladder step: (Z-c)*s


def ladder_steps(H, W, ladder):
    """Ladder steps an (H, W) raster takes: per direction d and entry L,
    the pixels whose read p + d*L is on the array (the ladder stops at
    the edge; a NaN read counts, the kernels make it)."""
    return sum(max(0, H - abs(dr) * L) * max(0, W - abs(dc) * L)
               for dr, dc in OFFSETS for L in ladder)


def bound_seconds(ops, nbytes):
    """(seconds, side): the least time the card could take, the larger of
    the operations at the f32 instruction rate and the bytes (each input
    read once, each output written once) at the HBM rate."""
    t_ops = ops / PEAK_F32_OPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def geomorphons_work(H, W, lookup_pixels, fast=False, how_fast=20):
    """Operations and bytes of one ``geomorphons`` call on an (H, W)
    float32 raster: ``OPS_PER_STEP`` per ladder step of its ladder, the
    raster read once (4 B a pixel) and the classes written once (1 B)."""
    steps = ladder_steps(H, W, scan_ladder(lookup_pixels, fast, how_fast))
    return {"ops": OPS_PER_STEP * steps, "bytes": 5 * H * W}
