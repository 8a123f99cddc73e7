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
  halo, with the epilogue decided in global coordinates.

A shard block (K4, and K3 given ``origin``) separates two limits: the
ladder ends at the edge of the block in memory, and the epilogue tests
the last step against the edge of the GLOBAL raster, from the block's
``origin`` and ``global_shape`` (``dist/api.py``).

All versions round exactly like the Pallas kernels: the ratio is a
subtract and a multiply by ``scale[d, k] = f32(1/(cellsize*w_d)) /
f32(L_k)``, a host table they share (``_ladder_scales``), and no
multiply-add is fused.  So extrema, counts and ternary codes are equal
between kernel and plain version on the card, and equal to the Pallas
kernels (interpret mode) on the CPU.  Openness calls ``atanf`` /
``torch.atan`` where the TPU kernel has its own polynomial, so it agrees
within a tolerance (PERF.md).

Each dispatcher (``openness_counts``, ``directional_extrema``,
``openness_reduced``, ``openness_counts_block``) picks by the tensor's device: the kernel for a
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
           "openness_counts_cuda", "geomorphons_cuda",
           "openness_counts_block", "openness_counts_block_torch",
           "openness_counts_block_cuda",
           "directional_extrema", "directional_extrema_torch",
           "directional_extrema_cuda",
           "openness_reduced", "openness_reduced_torch",
           "openness_reduced_cuda", "openness_cuda", "skyview_cuda",
           "ternary_cuda", "openness_degrees", "skyview_from_sum"]

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
# plain PyTorch versions
# ----------------------------------------------------------------------
def _ladder_extrema(Z, cellsize, lookup_pixels, fast, how_fast, origin=None,
                    global_shape=None):
    """Yield ``(d, mx, mn)`` for d = 0..7: the ladder of every plain
    version, in plain PyTorch ops on any device.  Follows the Pallas
    formulation step for step: NaN pad, one shifted slice per (d, L),
    compare-select extrema (NaN never enters; ``torch.maximum`` would
    propagate it), the out-of-range epilogue at ``Rmax``.

    ``origin`` (global row, col of ``Z[0, 0]``) and ``global_shape`` put
    the epilogue in global coordinates for a shard block, as the XLA
    function does (neilpy_tpu/ops/visibility.py:140-144); reads still end
    at the block's own edge (the NaN pad)."""
    H, W = Z.shape
    R = int(lookup_pixels)
    ladder = _ladder(R, fast, how_fast)
    Rmax = ladder[-1]
    # python floats holding f32 values: a tensor-scalar op computes in f32
    scales = _ladder_scales(cellsize, ladder).tolist()
    Zp = torch.nn.functional.pad(Z, (R, R, R, R), value=float("nan"))
    rows = torch.arange(H, device=Z.device)[:, None]
    cols = torch.arange(W, device=Z.device)[None, :]
    if origin is not None:
        rows = rows + int(origin[0])
        cols = cols + int(origin[1])
    GH, GW = (H, W) if global_shape is None else map(int, global_shape)
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
        oob = (sr < 0) | (sr >= GH) | (sc < 0) | (sc >= GW)
        mx = torch.where(oob, mx.clamp(min=0.0), mx)
        mn = torch.where(oob, mn.clamp(max=0.0), mn)
        yield d, mx, mn


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
                          threshold_angle=1.0, fast=False, how_fast=20):
    """(num_pos, num_neg) uint8 counts in plain PyTorch ops, on any
    device: the reference K1 is held against on the card, and the CPU
    path."""
    _check_raster(Z)
    return _votes(_ladder_extrema(Z, cellsize, lookup_pixels, fast,
                                  how_fast),
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
                                threshold_angle=1.0, fast=False, how_fast=20):
    """K4's counts in plain PyTorch ops, on any device: the reference K4 is
    held against on the card, and the CPU path.  ``block_haloed`` is one
    shard block with an R-wide halo of its neighbours' data (NaN beyond
    the raster), R = ``lookup_pixels``; ``origin`` the global (row, col)
    of its core; ``global_shape`` the raster's.  Returns core-shaped
    (num_pos, num_neg) uint8, equal to the single-device counts there."""
    _check_raster(block_haloed)
    R, bh, bw = _block_core(block_haloed, lookup_pixels)
    extrema = _ladder_extrema(
        block_haloed, cellsize, R, fast, how_fast,
        origin=(int(origin[0]) - R, int(origin[1]) - R),
        global_shape=global_shape)
    return _votes(extrema, threshold_angle, (bh, bw), block_haloed.device,
                  core=(slice(R, R + bh), slice(R, R + bw)))


def directional_extrema_torch(Z, cellsize=1.0, lookup_pixels=1, fast=False,
                              how_fast=20, origin=None, global_shape=None):
    """(mx, mn), each (8, H, W) float32, in plain PyTorch ops on any
    device: the reference K3 is held against on the card, and the CPU
    path.  ``origin`` / ``global_shape``: a shard block's global position
    (:func:`_ladder_extrema`)."""
    _check_raster(Z)
    mx_all = torch.empty((8, *Z.shape), dtype=torch.float32, device=Z.device)
    mn_all = torch.empty_like(mx_all)
    for d, mx, mn in _ladder_extrema(Z, cellsize, lookup_pixels, fast,
                                     how_fast, origin, global_shape):
        mx_all[d] = mx
        mn_all[d] = mn
    return mx_all, mn_all


def openness_reduced_torch(Z, mode, cellsize=1.0, lookup_pixels=1,
                           threshold_angle=0.0, neg_mode=True, fast=False,
                           how_fast=20):
    """K2's reduction in plain PyTorch ops, on any device: the reference
    K2 is held against on the card, and the CPU path.  Folds the
    directions in K2's order d = 0..7 and returns a tuple, as
    ``_reduced_call``: ``mode='openness'`` the positive and negative sums
    of ``pi/2 - atan`` in radians (+inf where a direction saw nothing);
    ``'svf'`` the sum of ``t/sqrt(1+t^2)``, ``t = max(mx, 0)``;
    ``'ternary'`` the base-3 code as uint16 (``neg_mode``: O = pos - neg,
    else O = pos - 90; digit 2 above ``threshold_angle``, 0 below its
    negative)."""
    _check_mode(mode)
    _check_raster(Z)
    T = _threshold_tangent(threshold_angle)
    acc0 = torch.zeros(Z.shape, dtype=torch.float32, device=Z.device)
    acc1 = torch.zeros_like(acc0)
    code = torch.zeros(Z.shape, dtype=torch.int32, device=Z.device)
    for d, mx, mn in _ladder_extrema(Z, cellsize, lookup_pixels, fast,
                                     how_fast):
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
                         f" use {name[:-len('_cuda')]}_torch on the CPU")
    if not Z.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    if Z.shape[0] > 8 * 65535:
        raise ValueError(f"{Z.shape[0]} rows exceed the kernels' grid "
                         "(524280)")


def _launch(Z, entry, cellsize, lookup_pixels, fast, how_fast, *args):
    """Launch C entry ``entry`` for raster ``Z`` with its ladder tables,
    then ``args``, on Z's device and current stream; raise on a CUDA
    error.  Does not synchronise."""
    lib = _build.load()
    ladder = _ladder(int(lookup_pixels), fast, how_fast)
    ladder_t, scales = _device_tables(float(cellsize), ladder, Z.device)
    H, W = Z.shape
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = getattr(lib, entry)(Z.data_ptr(), H, W, ladder_t.data_ptr(),
                                  scales.data_ptr(), len(ladder), ladder[-1],
                                  *args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")


def openness_counts_cuda(Z, cellsize=1.0, lookup_pixels=1,
                         threshold_angle=1.0, fast=False, how_fast=20):
    """(num_pos, num_neg) uint8 counts from K1 (``csrc/openness_counts.cu``).
    ``Z`` must be a contiguous 2-D float32 CUDA tensor; anything else
    raises.  Launches on the current stream and does not synchronise.
    ``openness_counts_cuda.launches`` counts the launches of this
    process."""
    _check_cuda(Z, "openness_counts_cuda")
    num_pos = torch.empty(Z.shape, dtype=torch.uint8, device=Z.device)
    num_neg = torch.empty_like(num_pos)
    if Z.numel() == 0:
        return num_pos, num_neg
    _launch(Z, "openness_counts_launch", cellsize, lookup_pixels, fast,
            how_fast, _threshold_tangent(threshold_angle),
            num_pos.data_ptr(), num_neg.data_ptr())
    openness_counts_cuda.launches += 1
    return num_pos, num_neg


openness_counts_cuda.launches = 0


def openness_counts_block_cuda(block_haloed, origin, global_shape,
                               lookup_pixels, cellsize=1.0,
                               threshold_angle=1.0, fast=False, how_fast=20):
    """K4 (``csrc/openness_counts_block.cu``): the core-shaped counts of
    :func:`openness_counts_block_torch`.  Same input rules, stream and
    counter (``openness_counts_block_cuda.launches``) as
    :func:`openness_counts_cuda`."""
    _check_cuda(block_haloed, "openness_counts_block_cuda")
    R, bh, bw = _block_core(block_haloed, lookup_pixels)
    num_pos = torch.empty((bh, bw), dtype=torch.uint8,
                          device=block_haloed.device)
    num_neg = torch.empty_like(num_pos)
    if num_pos.numel() == 0:
        return num_pos, num_neg
    _launch(block_haloed, "openness_counts_block_launch", cellsize, R, fast,
            how_fast, R, int(origin[0]), int(origin[1]),
            int(global_shape[0]), int(global_shape[1]),
            _threshold_tangent(threshold_angle), num_pos.data_ptr(),
            num_neg.data_ptr())
    openness_counts_block_cuda.launches += 1
    return num_pos, num_neg


openness_counts_block_cuda.launches = 0


def directional_extrema_cuda(Z, cellsize=1.0, lookup_pixels=1, fast=False,
                             how_fast=20, origin=None, global_shape=None):
    """(mx, mn), each (8, H, W) float32, from K3
    (``csrc/directional_extrema.cu``); given ``origin`` or
    ``global_shape``, from its entry for a shard block.  Same input rules,
    stream and counter (``directional_extrema_cuda.launches``, both
    entries) as :func:`openness_counts_cuda`."""
    _check_cuda(Z, "directional_extrema_cuda")
    mx = torch.empty((8, *Z.shape), dtype=torch.float32, device=Z.device)
    mn = torch.empty_like(mx)
    if Z.numel() == 0:
        return mx, mn
    if origin is None and global_shape is None:
        _launch(Z, "directional_extrema_launch", cellsize, lookup_pixels,
                fast, how_fast, mx.data_ptr(), mn.data_ptr())
    else:
        org = (0, 0) if origin is None else origin
        gshape = Z.shape if global_shape is None else global_shape
        _launch(Z, "directional_extrema_global_launch", cellsize,
                lookup_pixels, fast, how_fast, int(org[0]), int(org[1]),
                int(gshape[0]), int(gshape[1]), mx.data_ptr(), mn.data_ptr())
    directional_extrema_cuda.launches += 1
    return mx, mn


directional_extrema_cuda.launches = 0


def openness_reduced_cuda(Z, mode, cellsize=1.0, lookup_pixels=1,
                          threshold_angle=0.0, neg_mode=True, fast=False,
                          how_fast=20):
    """K2 (``csrc/openness_reduced.cu``): the same tuple as
    :func:`openness_reduced_torch`.  Same input rules, stream and counter
    (``openness_reduced_cuda.launches``) as
    :func:`openness_counts_cuda`."""
    _check_mode(mode)
    _check_cuda(Z, "openness_reduced_cuda")
    dev = Z.device
    if mode == "ternary":
        outs = (torch.empty(Z.shape, dtype=torch.uint16, device=dev),)
        ptrs = (None, None, outs[0].data_ptr())
    else:
        outs = tuple(torch.empty(Z.shape, dtype=torch.float32, device=dev)
                     for _ in range(2 if mode == "openness" else 1))
        ptrs = (outs[0].data_ptr(),
                outs[1].data_ptr() if mode == "openness" else None, None)
    if Z.numel() == 0:
        return outs
    _launch(Z, "openness_reduced_launch", cellsize, lookup_pixels, fast,
            how_fast, _MODES[mode], int(bool(neg_mode)),
            _threshold_tangent(threshold_angle), *ptrs)
    openness_reduced_cuda.launches += 1
    return outs


openness_reduced_cuda.launches = 0


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


def openness_counts(Z, cellsize=1.0, lookup_pixels=1, threshold_angle=1.0,
                    fast=False, how_fast=20, engine="auto"):
    """(num_pos, num_neg) for a float32 tensor, by ``engine``
    (see :func:`_pick`)."""
    fn = _pick(Z, engine, openness_counts_cuda, openness_counts_torch)
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
                     how_fast=20, engine="auto"):
    """K2's tuple for a float32 tensor, by ``engine``."""
    fn = _pick(Z, engine, openness_reduced_cuda, openness_reduced_torch)
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
                     fast=False, how_fast=20):
    """Geomorphon classes from K1 (counterpart of ``geomorphons_pallas``:
    no enhance pass)."""
    from .visibility import classes_from_counts
    num_pos, num_neg = openness_counts_cuda(
        Z, cellsize=cellsize, lookup_pixels=lookup_pixels,
        threshold_angle=threshold_angle, fast=fast, how_fast=how_fast)
    return classes_from_counts(num_pos, num_neg)


def openness_cuda(Z, cellsize=1.0, lookup_pixels=1, fast=False,
                  how_fast=20):
    """(positive, negative) openness in degrees from one K2 launch
    (counterpart of ``openness_pallas``)."""
    return openness_degrees(*openness_reduced_cuda(
        Z, "openness", cellsize=cellsize, lookup_pixels=lookup_pixels,
        fast=fast, how_fast=how_fast))


def skyview_cuda(Z, cellsize=1.0, lookup_pixels=1):
    """Skyview factor from one K2 launch (counterpart of
    ``skyview_pallas``)."""
    (s,) = openness_reduced_cuda(Z, "svf", cellsize=cellsize,
                                 lookup_pixels=lookup_pixels)
    return skyview_from_sum(s)


def ternary_cuda(Z, cellsize=1.0, lookup_pixels=1, threshold_angle=0.0,
                 use_negative_openness=True):
    """Base-3 ternary code (uint16) from one K2 launch (counterpart of
    ``ternary_pallas``)."""
    (code,) = openness_reduced_cuda(
        Z, "ternary", cellsize=cellsize, lookup_pixels=lookup_pixels,
        threshold_angle=threshold_angle, neg_mode=use_negative_openness)
    return code
