"""Geomorphon openness counts: the hand-written CUDA kernel and its
plain PyTorch version.

Counterpart of the counts part of ``neilpy_tpu/ops/pallas_scan.py``
(``openness_counts_pallas`` / ``_counts_kernel`` / ``_extrema_ladder``).
For every pixel and each of the 8 directions, the running max ``mx`` and
min ``mn`` over the scan ladder of the slope ratio
``(Z[p + d*L] - Z[p]) * scale[d, L]`` are kept (NaN reads and reads off
the raster are skipped); an out-of-range last step clamps ``mx >= 0`` and
``mn <= 0``; then each direction votes ``num_pos`` / ``num_neg`` by
comparing the openness difference ``atan(-mn) - atan(mx)`` with the
threshold exactly in tangent space.

Both versions round exactly like the Pallas kernel: the ratio is a
subtract and a multiply by ``scale[d, k] = f32(1/(cellsize*w_d)) /
f32(L_k)``, a host table they share (``_ladder_scales``), and no
multiply-add is fused.  So their uint8 counts are equal to each other on
the card and to ``openness_counts_pallas`` on the CPU.

``openness_counts`` dispatches on the tensor's device: the kernel for a
CUDA tensor, the plain version for a CPU tensor.  Nothing falls back: a
kernel that does not build or launch raises.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build
from ..core.codes import progressive_window
from ..core.shift import OFFSETS, STEP_LENGTH

__all__ = ["openness_counts", "openness_counts_torch",
           "openness_counts_cuda", "geomorphons_cuda"]


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
    on the host in f32 so neither the kernel nor the plain version
    divides on the device."""
    inv_w = np.array([1.0 / (float(cellsize) * STEP_LENGTH[d])
                      for d in range(8)], dtype=np.float32)
    return inv_w[:, None] / np.asarray(ladder, dtype=np.float32)[None, :]


@functools.lru_cache(maxsize=64)
def _device_tables(cellsize, ladder, device):
    """The kernel's ladder (int32) and scale table on ``device``, kept so
    that repeated calls make no blocking host-to-device copy.  Read-only:
    the kernel never writes them."""
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


def openness_counts_torch(Z, cellsize=1.0, lookup_pixels=1,
                          threshold_angle=1.0, fast=False, how_fast=20):
    """(num_pos, num_neg) uint8 counts in plain PyTorch ops, on any
    device: the reference the kernel is held against on the card, and
    the CPU path.  Follows the Pallas formulation step for step: NaN pad,
    one shifted slice per (d, L), compare-select extrema (NaN never
    enters; ``torch.maximum`` would propagate it), the out-of-range
    epilogue, the tangent-space classify."""
    _check_raster(Z)
    H, W = Z.shape
    R = int(lookup_pixels)
    ladder = _ladder(R, fast, how_fast)
    Rmax = ladder[-1]
    # python floats holding f32 values: a tensor-scalar op computes in f32
    scales = _ladder_scales(cellsize, ladder).tolist()
    T = _threshold_tangent(threshold_angle)
    Zp = torch.nn.functional.pad(Z, (R, R, R, R), value=float("nan"))
    rows = torch.arange(H, device=Z.device)[:, None]
    cols = torch.arange(W, device=Z.device)[None, :]
    num_pos = torch.zeros((H, W), dtype=torch.uint8, device=Z.device)
    num_neg = torch.zeros((H, W), dtype=torch.uint8, device=Z.device)
    for d, (dr, dc) in enumerate(OFFSETS):
        mx = torch.full((H, W), -math.inf, device=Z.device)
        mn = torch.full((H, W), math.inf, device=Z.device)
        for k, L in enumerate(ladder):
            src = Zp[R + dr * L:R + dr * L + H, R + dc * L:R + dc * L + W]
            ratio = (src - Z) * scales[d][k]
            mx = torch.where(ratio > mx, ratio, mx)
            mn = torch.where(ratio < mn, ratio, mn)
        sr = rows + dr * Rmax
        sc = cols + dc * Rmax
        oob = (sr < 0) | (sr >= H) | (sc < 0) | (sc >= W)
        mx = torch.where(oob, mx.clamp(min=0.0), mx)
        mn = torch.where(oob, mn.clamp(max=0.0), mn)
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
        num_pos += gt
        num_neg += lt
    return num_pos, num_neg


def openness_counts_cuda(Z, cellsize=1.0, lookup_pixels=1,
                         threshold_angle=1.0, fast=False, how_fast=20):
    """(num_pos, num_neg) uint8 counts from the CUDA kernel
    (``csrc/openness_counts.cu``).  ``Z`` must be a contiguous 2-D
    float32 CUDA tensor; anything else raises.  Launches on the current
    stream and does not synchronise.  ``openness_counts_cuda.launches``
    counts the launches of this process."""
    _check_raster(Z)
    if not Z.is_cuda:
        raise ValueError("openness_counts_cuda needs a CUDA tensor, got one "
                         f"on {Z.device}; use openness_counts_torch on the "
                         "CPU")
    if not Z.is_contiguous():
        raise ValueError("openness_counts_cuda needs a contiguous tensor")
    H, W = Z.shape
    if H > 8 * 65535:
        raise ValueError(f"{H} rows exceed the kernel's grid (524280)")
    lib = _build.load()
    ladder = _ladder(int(lookup_pixels), fast, how_fast)
    ladder_t, scales = _device_tables(float(cellsize), ladder, Z.device)
    num_pos = torch.empty((H, W), dtype=torch.uint8, device=Z.device)
    num_neg = torch.empty((H, W), dtype=torch.uint8, device=Z.device)
    if H == 0 or W == 0:
        return num_pos, num_neg
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = lib.openness_counts_launch(
            Z.data_ptr(), H, W, ladder_t.data_ptr(), scales.data_ptr(),
            len(ladder), ladder[-1], _threshold_tangent(threshold_angle),
            num_pos.data_ptr(), num_neg.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"openness_counts kernel launch failed: CUDA "
                           f"error {err}")
    openness_counts_cuda.launches += 1
    return num_pos, num_neg


openness_counts_cuda.launches = 0


def openness_counts(Z, cellsize=1.0, lookup_pixels=1, threshold_angle=1.0,
                    fast=False, how_fast=20, engine="auto"):
    """(num_pos, num_neg) for a float32 tensor.  ``engine='auto'`` runs
    the CUDA kernel for a CUDA tensor and the plain PyTorch version for a
    CPU tensor; ``'cuda'`` / ``'torch'`` force one (``'cuda'`` raises on
    a CPU tensor)."""
    if engine == "auto":
        engine = "cuda" if Z.is_cuda else "torch"
    if engine == "cuda":
        fn = openness_counts_cuda
    elif engine == "torch":
        fn = openness_counts_torch
    else:
        raise ValueError(f"engine must be 'auto', 'cuda' or 'torch', got "
                         f"{engine!r}")
    return fn(Z, cellsize=cellsize, lookup_pixels=lookup_pixels,
              threshold_angle=threshold_angle, fast=fast, how_fast=how_fast)


def geomorphons_cuda(Z, cellsize=1, lookup_pixels=1, threshold_angle=1,
                     fast=False, how_fast=20):
    """Geomorphon classes from the CUDA counts kernel (counterpart of
    ``geomorphons_pallas``: no enhance pass)."""
    from .visibility import classes_from_counts
    num_pos, num_neg = openness_counts_cuda(
        Z, cellsize=cellsize, lookup_pixels=lookup_pixels,
        threshold_angle=threshold_angle, fast=fast, how_fast=how_fast)
    return classes_from_counts(num_pos, num_neg)
