"""Surface derivative stencils: slope, aspect, hillshade, curvatures.

PyTorch counterpart of ``neilpy_tpu/ops/surface.py``, with the same names
and arguments plus ``device=`` last: numpy input goes to CUDA unless
``device='cpu'`` (``ops/visibility.as_raster``), a tensor stays where it
is.  Every function is plain torch ops on the tensor's device, in float32
as the JAX package computes them: element-wise algebra over a handful of
shifted copies (``core/shift.py``), each a full-raster pass in eager
PyTorch where XLA fused the graph into one.

The reference's quirks are kept verbatim: ``_fill_nan_with_center``,
``_fill_nan_wilson_gallant``'s sequential order, Wilson & Gallant's
``ashift(X, 8)`` / ``ashift(X, 9)`` (unshifted copies) and ``/ 4*H**2``,
Zevenbergen & Thorne's ``D*E**2``.  uint8 products cast through
``core/device.to_uint8`` (NaN -> 0, saturating), as JAX casts.
Convolutions with weighted kernels run ``conv2d`` with TF32 off for that
call, so an f32 product on the card keeps its 24-bit mantissa.

``binary_footprint_sum`` is the exception: on a CUDA raster it is one
launch of the hand-written kernel ``csrc/footprint_sum.cu``
(``_footprint_cuda``, equal to the plain version bit for bit), on any
other the plain torch version ``_footprint_sum_torch``.

While a ``torch.profiler`` profile is open, ``hillshade``,
``esri_curvature`` and ``evans_curvature`` are the spans
``surface.<name>`` (``profiling.span``) with their device time: roots
when the caller opened none, ``evans_curvature`` a child under
``stats.shi_landslides``.  ``binary_footprint_sum`` opens none.

Parity targets (reference neilpy/neilpy.py): esri_slope 434-449, slope
456-466, aspect 471-484, curvature 487-488, esri_curvature 520-574,
zevenbergen_and_thorne_curvature 596-667, evans_curvature 671-737,
wilson_gallant_curvature 753-806, hillshade 814-824,
multiple_illumination 830-842, pssm 846-867, z_factor 871-880,
triangle_height/vip_score 1818-1845, std 2039-2047, reduce_peaks
2056-2087, topographic_position_index 2098-2124, scaled_morphometry
2472-2510.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import _build, profiling
from ..core.codes import disk, distance_kernel
from ..core.device import to_uint8
from ..core.shift import ashift, gradient2d, pad_edge, pad_reflect
from .inpaint import _smem_optin
from .visibility import as_raster

__all__ = [
    "esri_slope", "slope", "aspect", "curvature", "esri_curvature",
    "zevenbergen_and_thorne_curvature", "evans_curvature",
    "wilson_gallant_curvature", "hillshade", "multiple_illumination",
    "pssm", "z_factor", "triangle_height", "vip_score", "std", "std2",
    "reduce_peaks", "topographic_position_index", "scaled_morphometry",
    "convolve2d_nearest", "binary_footprint_sum",
]


def _pad_footprint(X, shape, mode):
    kh, kw = shape
    ph, pw = kh // 2, kw // 2
    pad = ((ph, kh - 1 - ph), (pw, kw - 1 - pw))
    if mode == "nearest":
        return pad_edge(X, pad)
    if mode == "reflect":
        return pad_reflect(X, pad)
    raise ValueError(f"unsupported mode {mode}")


def _f32_conv(Xp, k):
    """``conv2d`` (a correlation) of one (H, W) plane with one kernel,
    TF32 off for this call only."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return torch.nn.functional.conv2d(Xp[None, None], k[None, None])[0, 0]


# ----------------------------------------------------------------------
# Convolution helper: footprint correlation with edge-replicate padding
# (scipy.ndimage.convolve mode='nearest').
# ----------------------------------------------------------------------
def convolve2d_nearest(X, kernel, mode="nearest", device=None):
    """``scipy.ndimage.convolve`` of ``X`` with ``kernel`` (flipped, then
    correlated by ``conv2d`` on the padded raster)."""
    X = as_raster(X, device)
    k = np.asarray(kernel, dtype=np.float32)
    Xp = _pad_footprint(X, k.shape, mode)
    kflip = torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1])).to(X.device)
    return _f32_conv(Xp, kflip)


def _runs(fp):
    """Horizontal runs of a boolean footprint: [(row, col0, width), ...]."""
    runs = []
    kh, kw = fp.shape
    for dr in range(kh):
        row = fp[dr]
        c = 0
        while c < kw:
            if not row[c]:
                c += 1
                continue
            c0 = c
            while c < kw and row[c]:
                c += 1
            runs.append((dr, c0, c - c0))
    return runs


def binary_footprint_sum(X, footprint, mode="nearest", device=None):
    """Neighbourhood sum over a BINARY footprint with edge-replicate (or
    reflect) padding: ``generic_filter``-style correlation (no kernel
    flip; footprints are taken as positioned).  On a CUDA raster the
    kernel (:func:`_footprint_cuda`), on any other the plain version
    (:func:`_footprint_sum_torch`); both give the same bits."""
    X = as_raster(X, device)
    fp = np.asarray(footprint) != 0
    if X.is_cuda:
        return _footprint_cuda(X, fp, mode)
    return _footprint_sum_torch(X, fp, mode)


def _footprint_sum_torch(X, fp, mode="nearest"):
    """The plain version of :func:`binary_footprint_sum` on a float32
    raster ``X`` and a boolean footprint ``fp``, in torch ops on any
    device.  The footprint decomposes into horizontal runs per row, and
    each run's sliding sum is built from power-of-2 column partials of the
    padded raster, shared by every run: the JAX package's decomposition
    with its order of adds, so the sums agree with it to the last bit on
    the CPU."""
    H, W = X.shape
    Xp = _pad_footprint(X, fp.shape, mode)
    runs = _runs(fp)
    if not runs:
        return torch.zeros((H, W), dtype=torch.float32, device=X.device)

    wmax = max(w for _, _, w in runs)
    partial = {1: Xp}
    k = 1
    while k * 2 <= wmax:
        a = partial[k]
        n = a.shape[1]
        partial[2 * k] = a[:, :n - k] + a[:, k:]
        k *= 2

    out = torch.zeros((H, W), dtype=torch.float32, device=X.device)
    for dr, c0, wlen in runs:
        off = c0
        k = 1 << (wlen.bit_length() - 1)
        acc = None
        while k >= 1:
            if wlen & k:
                piece = partial[k][dr:dr + H, off:off + W]
                acc = piece if acc is None else acc + piece
                off += k
            k //= 2
        out = out + acc
    return out


# csrc/footprint_sum.cu's tiling: a block's output columns (one a
# thread) and rows, the footprint rows and run pieces one launch's table
# holds, the widest span of columns it takes, the guard words around its
# partials, and the input rows a shared-memory batch stages: the tile's
# whole window where it fits in _FS_SMEM_TARGET bytes, else as many as
# fit with two raw buffers, at most _FS_BATCH_ROWS
_FS_COLS = 128
_FS_ROWS = 32      # output rows a block
_FS_MAX_ROWS = 256
_FS_MAX_PIECES = 768
_FS_MAX_SPAN = 2048
_FS_GUARD = 4
_FS_BATCH_ROWS = 32
_FS_SMEM_TARGET = 224 * 1024
_FS_LAST = 1 << 31   # a piece's flag: the last of its run


def _run_pieces(c0, wlen):
    """A run's power-of-two pieces from the widest down, as
    :func:`_footprint_sum_torch` adds them: [(log2 width, offset), ...]."""
    pieces, off, k = [], c0, 1 << (wlen.bit_length() - 1)
    while k >= 1:
        if wlen & k:
            pieces.append((k.bit_length() - 1, off))
            off += k
        k //= 2
    return pieces


def _footprint_plan(fp, smem_max):
    """The kernel's table of a boolean footprint ``fp``: one band per
    launch, in order, each a dict with ``head`` (int32: the band's rows,
    the raster row its first row reads from output row 0, the column
    offset -pw, staged columns n, the column stride cs (odd), partial
    levels, rows a shared-memory batch, the band's footprint cells,
    pieces), ``start`` (uint16, row r's pieces start[r]:start[r+1]),
    ``piece`` (uint32: the piece's word offset in the column-major staged
    partials, (level * n + column offset) * cs, | _FS_LAST on a run's last
    piece) and ``smem`` (bytes).  Rows before the first run and after the
    last are left out; a band ends where another row would pass
    _FS_MAX_ROWS rows or _FS_MAX_PIECES pieces.  A footprint the kernel
    cannot take (a row of more pieces than a table holds, a span past
    _FS_MAX_SPAN columns, a launch past ``smem_max`` bytes) raises."""
    fp = np.asarray(fp, dtype=bool)
    return _plan_cached(fp.shape, fp.tobytes(), int(smem_max))


@functools.lru_cache(maxsize=64)
def _plan_cached(shape, bits, smem_max):
    fp = np.frombuffer(bits, dtype=bool).reshape(shape)
    kh, kw = shape
    rows = [[] for _ in range(kh)]   # a row's runs, each its pieces
    for dr, c0, wlen in _runs(fp):
        run = _run_pieces(c0, wlen)
        rows[dr].append([(lv, off, i == len(run) - 1)
                         for i, (lv, off) in enumerate(run)])
    used = [dr for dr in range(kh) if rows[dr]]
    bands = []   # (first footprint row, its rows, their pieces)
    for dr in range(used[0], used[-1] + 1) if used else ():
        count = sum(len(run) for run in rows[dr])
        if count > _FS_MAX_PIECES:
            raise ValueError(f"footprint row {dr} has {count} run pieces, "
                             f"above the kernel's {_FS_MAX_PIECES}")
        if (not bands or len(bands[-1][1]) == _FS_MAX_ROWS
                or bands[-1][2] + count > _FS_MAX_PIECES):
            bands.append((dr, [], 0))
        r0, band, pieces = bands[-1]
        bands[-1] = (r0, band + [rows[dr]], pieces + count)
    if not bands:
        bands.append((0, [], 0))

    plan = []
    for r0, band, _ in bands:
        pieces = [pc for row in band for run in row for pc in run]
        span = max((off + (1 << lv) for lv, off, _ in pieces), default=1)
        if span > _FS_MAX_SPAN:
            raise ValueError(f"footprint spans {span} columns, above the "
                             f"kernel's {_FS_MAX_SPAN}")
        levels = 1 + max((lv for lv, _, _ in pieces), default=0)
        n = _FS_COLS + span - 1
        nr = _FS_ROWS + len(band) - 1 if band else 1
        rb = nr
        if _fs_smem(levels, n, rb, nr) > _FS_SMEM_TARGET:
            rb = min(_FS_BATCH_ROWS, nr - 1)
            while rb > 1 and _fs_smem(levels, n, rb, nr) > _FS_SMEM_TARGET:
                rb -= 1
        smem = _fs_smem(levels, n, rb, nr)
        if smem > smem_max:
            raise ValueError(f"footprint of {kh} x {kw} needs {smem} bytes "
                             f"of shared memory, above the {smem_max} a "
                             f"block may use")
        cs = rb | 1
        start = np.cumsum([0] + [sum(len(run) for run in row)
                                 for row in band]).astype(np.uint16)
        piece = np.array([(lv * n + off) * cs | (_FS_LAST if last else 0)
                          for lv, off, last in pieces], dtype=np.uint32)
        cells = int(fp[r0:r0 + len(band)].sum()) if band else 0
        head = np.array([len(band), r0 - kh // 2, -(kw // 2), n, cs, levels,
                         rb, cells, len(pieces)], dtype=np.int32)
        plan.append({"head": head, "start": start, "piece": piece,
                     "smem": smem})
    return plan


def _fs_smem(levels, n, rb, nr):
    """Shared memory of a launch that stages ``rb`` of a tile's ``nr``
    input rows a batch: the guards, the partials (levels x n columns x an
    odd column stride, cs) and the raw rows, one buffer where the batch is
    the whole window, else two (the one in use and the next, arriving)."""
    cs = rb | 1
    return 4 * (2 * _FS_GUARD + levels * n * cs
                + (1 if rb >= nr else 2) * rb * n)


def _reflect(mode):
    """The kernel's padding flag of ``mode``: 0 'nearest', 1 'reflect'."""
    if mode not in ("nearest", "reflect"):
        raise ValueError(f"unsupported mode {mode}")
    return int(mode == "reflect")


def _cuda_raster(X, who):
    """Refuse what the footprint kernels do not take: anything but a
    contiguous 2-D float32 CUDA tensor."""
    if X.dim() != 2 or X.dtype != torch.float32:
        raise ValueError(f"{who} takes a 2-D float32 raster, not "
                         f"{X.dtype} of shape {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError(f"{who} needs a contiguous raster")
    if not X.is_cuda:
        raise ValueError(f"{who} needs a CUDA tensor, got one on "
                         f"{X.device}; the plain torch version runs others")


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _footprint_cuda(X, fp, mode="nearest"):
    """:func:`_footprint_sum_torch` as the hand-written kernel
    ``csrc/footprint_sum.cu``, equal to it bit for bit on the card: one
    launch a band of :func:`_footprint_plan` (one for a footprint of at
    most 256 rows with runs), on the current stream, with no synchronise.
    ``X`` must be a contiguous 2-D float32 CUDA tensor; anything else, or
    a footprint the kernel cannot take, raises.
    ``_footprint_cuda.launches`` counts the launches of this process; the
    first is the span ``first_use.launch``."""
    _cuda_raster(X, "_footprint_cuda")
    reflect = _reflect(mode)
    plan = _footprint_plan(fp, _smem_optin(X.device))
    out = torch.empty_like(X)
    if X.numel() == 0:
        return out
    H, W = X.shape
    lib = _build.load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for k, band in enumerate(plan):
            with profiling.first_launch("footprint_sum_launch"):
                err = lib.footprint_sum_launch(
                    X.data_ptr(), out.data_ptr(), H, W, reflect,
                    _ptr(band["head"]), _ptr(band["start"]),
                    _ptr(band["piece"]), int(k > 0), band["smem"], stream)
            if err != 0:
                raise RuntimeError(f"footprint_sum_launch failed: CUDA "
                                   f"error {err}")
            _footprint_cuda.launches += 1
    return out


_footprint_cuda.launches = 0


# ----------------------------------------------------------------------
# Slope / aspect / hillshade
# ----------------------------------------------------------------------
def slope(Z, cellsize=1, z_factor=1, return_as="degrees", device=None):
    """Gradient-based slope (neilpy.py:456-466)."""
    if return_as not in ("degrees", "radians", "percent"):
        print("return_as", return_as, "is not supported.")
        return None
    gy, gx = gradient2d(as_raster(Z, device), cellsize / z_factor)
    S = torch.sqrt(gx ** 2 + gy ** 2)
    if return_as in ("degrees", "radians"):
        S = torch.arctan(S)
        if return_as == "degrees":
            S = torch.rad2deg(S)
    return S


def esri_slope(Z, cellsize=1, z_factor=1, return_as="degrees", device=None):
    """ESRI 3x3 Horn slope (neilpy.py:434-449): eight shifted reads of the
    reflect-padded raster (generic_filter mode='reflect')."""
    Z = as_raster(Z, device)
    P = pad_reflect(Z, 1)
    n = {}
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            n[(dr, dc)] = P[1 + dr:P.shape[0] - 1 + dr,
                            1 + dc:P.shape[1] - 1 + dc]
    dz_dx = ((n[(-1, 1)] + 2 * n[(0, 1)] + n[(1, 1)])
             - (n[(-1, -1)] + 2 * n[(0, -1)] + n[(1, -1)])) / 8.0
    dz_dy = ((n[(1, -1)] + 2 * n[(1, 0)] + n[(1, 1)])
             - (n[(-1, -1)] + 2 * n[(-1, 0)] + n[(-1, 1)])) / 8.0
    S = torch.sqrt(dz_dx ** 2 + dz_dy ** 2)
    if cellsize != 1:
        S = S / cellsize
    if z_factor != 1:
        S = z_factor * S
    if return_as == "degrees":
        S = torch.rad2deg(torch.arctan(S))
    return S


def _aspect_from_gradient(gy, gx, degrees, flat_as):
    A = torch.arctan2(gy, -gx)
    A = math.pi / 2 - A
    A = torch.where(A < 0, A + 2 * math.pi, A)
    if degrees:
        A = torch.rad2deg(A)
    return torch.where((gx == 0) & (gy == 0), flat_as, A)


def aspect(Z, return_as="degrees", flat_as="nan", device=None):
    """Gradient-based compass aspect (neilpy.py:471-484)."""
    if return_as not in ("degrees", "radians"):
        print("return_as", return_as, "is not supported.")
        return None
    gy, gx = gradient2d(as_raster(Z, device))
    if flat_as == "nan":
        flat_as = float("nan")
    return _aspect_from_gradient(gy, gx, return_as == "degrees", flat_as)


def _f32(value, device):
    return torch.tensor(value, dtype=torch.float32, device=device)


def hillshade_from_gradients(gy, gx, gy_unit, gx_unit, zenith=45,
                             azimuth=315, return_uint8=True):
    """The hillshade of one raster from its gradients: ``(gy, gx)`` at
    spacing ``cellsize / z_factor`` (the slope) and ``(gy_unit,
    gx_unit)`` at spacing 1 (the aspect), as ``hillshade`` computes them.
    ``dist.sharded_hillshade`` feeds it gradients taken per block."""
    dev = gy.device
    zen = torch.deg2rad(_f32(zenith, dev))
    azi = torch.deg2rad(_f32(azimuth, dev))
    S = torch.arctan(torch.sqrt(gx ** 2 + gy ** 2))
    A = _aspect_from_gradient(gy_unit, gx_unit, False, 0.0)
    H = (torch.cos(zen) * torch.cos(S)
         + torch.sin(zen) * torch.sin(S) * torch.cos(azi - A))
    H = torch.where(H < 0, 0.0, H)
    if return_uint8:
        H = to_uint8(torch.round(255.0 * H))
    return H


def hillshade(Z, cellsize=1, z_factor=1, zenith=45, azimuth=315,
              return_uint8=True, device=None):
    """ESRI hillshade from gradient slope/aspect (neilpy.py:814-824); the
    angles convert to radians in float32, as in the JAX package."""
    with profiling.span("surface.hillshade"):
        Z = as_raster(Z, device)
        with profiling.device_time(Z.device):
            gy, gx = gradient2d(Z, cellsize / z_factor)
            gy1, gx1 = gradient2d(Z)
            return hillshade_from_gradients(gy, gx, gy1, gx1, zenith,
                                            azimuth, return_uint8)


def multiple_illumination(Z, cellsize=1, z_factor=1,
                          zeniths=np.array([45]), azimuths=4, device=None):
    """Max-combined hillshade over a zenith x azimuth grid
    (neilpy.py:830-842)."""
    if np.isscalar(azimuths):
        azimuths = np.arange(0, 360, 360 / azimuths)
    if np.isscalar(zeniths):
        step = 90 / (zeniths + 1)
        zeniths = np.arange(step, 90, step)
    Z = as_raster(Z, device)
    H = torch.zeros(Z.shape, dtype=torch.float32, device=Z.device)
    for zen in zeniths:
        for azi in azimuths:
            H1 = hillshade(Z, cellsize=cellsize, z_factor=z_factor,
                           zenith=zen, azimuth=azi)
            H = torch.maximum(H, H1.to(H.dtype))
    return to_uint8(H)


# matplotlib's ``bone`` colormap, segment data as published in
# matplotlib/_cm.py (``_bone_data``): per channel (x, y0, y1) rows
_BONE_DATA = {
    "red": ((0., 0., 0.), (0.746032, 0.652778, 0.652778), (1.0, 1.0, 1.0)),
    "green": ((0., 0., 0.), (0.365079, 0.319444, 0.319444),
              (0.746032, 0.777778, 0.777778), (1.0, 1.0, 1.0)),
    "blue": ((0., 0., 0.), (0.365079, 0.444444, 0.444444), (1.0, 1.0, 1.0)),
}


def _segment_lut(data, N=256):
    """matplotlib.colors._create_lookup_table(N, data) for segment data:
    linear interpolation between the (x, y0, y1) rows at N equispaced
    samples, clipped to [0, 1]."""
    adata = np.array(data, dtype=np.float64)
    x, y0, y1 = adata[:, 0] * (N - 1), adata[:, 1], adata[:, 2]
    xind = (N - 1) * np.linspace(0, 1, N)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def bone_table(reverse=False):
    """The (256, 4) float64 RGBA table of matplotlib's ``bone`` colormap
    (``bone_r`` when ``reverse``), built from its segment data as
    matplotlib builds it; ``bone_r`` reverses the segments as
    ``LinearSegmentedColormap.reversed`` does."""
    table = np.ones((256, 4), dtype=np.float64)
    for ch, key in enumerate(("red", "green", "blue")):
        data = _BONE_DATA[key]
        if reverse:
            data = [(1.0 - x, b, a) for x, a, b in reversed(data)]
        table[:, ch] = _segment_lut(data)
    return table


def pssm(Z, cellsize=1, ve=2.3, reverse=False, apply_colormap=True,
         device=None):
    """Perceptually Scaled Slope Map / bonemap (neilpy.py:846-867).

    Returns uint8 class values, or with ``apply_colormap`` the float64
    RGBA of matplotlib's ``bone_r`` (``bone`` when ``reverse``) gathered
    on the device from ``bone_table``."""
    Z = as_raster(Z, device)
    gy, gx = gradient2d(Z, cellsize)
    S = torch.sqrt(gx ** 2 + gy ** 2)
    P = torch.rad2deg(torch.arctan(ve * S)) / 90.0
    P = to_uint8(torch.round(255 * P))
    if apply_colormap:
        table = torch.from_numpy(bone_table(reverse=not reverse))
        return table.to(P.device)[P.long()]
    return P


def z_factor(latitude, device=None):
    """Latitude-dependent z-factor for degree-referenced DEMs
    (neilpy.py:871-880), in float32."""
    shape = tuple(np.shape(latitude))
    latitude = torch.deg2rad(as_raster(latitude, device).reshape(shape))
    a = 6378137.0
    b = 6356752.3
    numer = ((a ** 4) * torch.cos(latitude) ** 2
             + (b ** 4) * torch.sin(latitude) ** 2)
    denom = (a * torch.cos(latitude)) ** 2 + (b * torch.sin(latitude)) ** 2
    return 1.0 / (math.pi / 180 * torch.cos(latitude)
                  * torch.sqrt(numer / denom))


# ----------------------------------------------------------------------
# Curvatures.  Cell naming follows Zevenbergen & Thorne: Z1..Z9 from the
# upper-left, Z5 = center.  NaN conventions are replicated per variant.
# ----------------------------------------------------------------------
def _neighbors_zt(X):
    """Z1..Z9 (minus center) via ashift, reference direction mapping
    (neilpy.py:528-535)."""
    return dict(Z1=ashift(X, 0), Z2=ashift(X, 1), Z3=ashift(X, 2),
                Z4=ashift(X, 7), Z6=ashift(X, 3), Z7=ashift(X, 6),
                Z8=ashift(X, 5), Z9=ashift(X, 4))


def _fill_nan_with_center(n, X):
    return {k: torch.where(torch.isnan(v), X, v) for k, v in n.items()}


def _fill_nan_wilson_gallant(n, X):
    """Wilson & Gallant eq. 3.8 reflection fill in the reference's
    sequential order (neilpy.py:615-622): opposite pairs
    (Z1,Z9),(Z2,Z8),(Z3,Z7),(Z4,Z6); later fills see earlier results."""
    order = [("Z1", "Z9"), ("Z2", "Z8"), ("Z3", "Z7"), ("Z4", "Z6"),
             ("Z6", "Z4"), ("Z7", "Z3"), ("Z8", "Z2"), ("Z9", "Z1")]
    n = dict(n)
    for a, b in order:
        n[a] = torch.where(torch.isnan(n[a]), 2 * X - n[b], n[a])
    return n


def curvature(X, cellsize=1, device=None):
    """-100 x Laplacian, ESRI-equivalent general curvature
    (neilpy.py:487-488; ndi.laplace with reflect boundary)."""
    X = as_raster(X, device) / cellsize
    P = pad_reflect(X, 1)
    lap = (P[:-2, 1:-1] + P[2:, 1:-1] + P[1:-1, :-2] + P[1:-1, 2:]
           - 4.0 * X)
    return -100.0 * lap


def esri_curvature(X, cellsize=1, device=None):
    """ESRI planar curvature triple (K, K_plan, K_profile)
    (neilpy.py:520-574).  NaN neighbours take the center value."""
    with profiling.span("surface.esri_curvature"):
        X = as_raster(X, device)
        with profiling.device_time(X.device):
            return _esri_curvature(X, cellsize)


def _esri_curvature(X, L):
    n = _fill_nan_with_center(_neighbors_zt(X), X)
    Z1, Z2, Z3, Z4 = n["Z1"], n["Z2"], n["Z3"], n["Z4"]
    Z6, Z7, Z8, Z9 = n["Z6"], n["Z7"], n["Z8"], n["Z9"]
    D = ((Z4 + Z6) / 2 - X) / L ** 2
    E = ((Z2 + Z8) / 2 - X) / L ** 2
    F = (-Z1 + Z3 + Z7 - Z9) / (4 * L ** 2)
    G = (-Z4 + Z6) / (2 * L)
    H = (Z2 - Z8) / (2 * L)
    K = -200 * (D + E)
    denom = G ** 2 + H ** 2
    K_plan = 200 * (D * H ** 2 + E * G ** 2 - F * G * H) / denom
    K_plan = torch.where(torch.isnan(K_plan), 0.0, K_plan)
    K_profile = -200 * (D * G ** 2 + E * H ** 2 + F * G * H) / denom
    K_profile = torch.where(torch.isnan(K_profile), 0.0, K_profile)
    return K, K_plan, K_profile


def zevenbergen_and_thorne_curvature(X, cellsize=1, device=None):
    """Six Z&T curvatures (K, profile, plan, tan, long, cross)
    (neilpy.py:596-667)."""
    X = as_raster(X, device)
    L = cellsize
    n = _fill_nan_wilson_gallant(_neighbors_zt(X), X)
    Z1, Z2, Z3, Z4 = n["Z1"], n["Z2"], n["Z3"], n["Z4"]
    Z6, Z7, Z8, Z9 = n["Z6"], n["Z7"], n["Z8"], n["Z9"]
    D = ((Z4 + Z6) / 2 - X) / L ** 2
    E = ((Z2 + Z8) / 2 - X) / L ** 2
    F = (-Z1 + Z3 + Z7 - Z9) / (4 * L ** 2)
    G = (-Z4 + Z6) / (2 * L)
    H = (Z2 - Z8) / (2 * L)
    P = G ** 2 + H ** 2
    Q = P + 1
    K = 2 * (D + E)
    K_cross = 2 * (D * H ** 2 + E * G ** 2 - F * G * H) / P
    K_cross = torch.where(torch.isnan(K_cross), 0.0, K_cross)
    K_long = -2 * (D * G ** 2 + E * H ** 2 + F * G * H) / P
    K_long = torch.where(torch.isnan(K_long), 0.0, K_long)
    K_tan = -(D * H ** 2 - 2 * F * G * H + E * G ** 2) / (P * Q ** 0.5)
    K_profile = (D * G ** 2 + 2 * F * G * H + E * H ** 2) / (P * Q ** 1.5)
    # the reference's D*E**2 in the first term (neilpy.py:662), verbatim
    K_plan = -(D * E ** 2 - 2 * F * G * H + E * G ** 2) / (P ** 1.5)
    return K, K_profile, K_plan, K_tan, K_long, K_cross


def _evans_terms(X, z, L):
    """Wood (1991) quadratic-fit terms from a 3x3 (or scaled)
    neighbourhood dict z (keys Z1..Z9 minus center)."""
    A = ((z["Z1"] + z["Z3"] + z["Z4"] + z["Z6"] + z["Z7"] + z["Z9"])
         / (6 * L ** 2) - (z["Z2"] + X + z["Z8"]) / (3 * L ** 2))
    B = ((z["Z1"] + z["Z2"] + z["Z3"] + z["Z7"] + z["Z8"] + z["Z9"])
         / (6 * L ** 2) - (z["Z4"] + X + z["Z6"]) / (3 * L ** 2))
    C = (z["Z3"] + z["Z7"] - z["Z1"] - z["Z9"]) / (4 * L ** 2)
    D = (z["Z3"] + z["Z6"] + z["Z9"] - z["Z1"] - z["Z4"] - z["Z7"]) / (6 * L)
    E = (z["Z1"] + z["Z2"] + z["Z3"] - z["Z7"] - z["Z8"] - z["Z9"]) / (6 * L)
    return A, B, C, D, E


def evans_curvature(X, cellsize=1, device=None):
    """Evans/Wood six curvatures (neilpy.py:671-737)."""
    with profiling.span("surface.evans_curvature"):
        X = as_raster(X, device)
        with profiling.device_time(X.device):
            return _evans_curvature(X, cellsize)


def _evans_curvature(X, L):
    n = _fill_nan_wilson_gallant(_neighbors_zt(X), X)
    A, B, C, D, E = _evans_terms(X, n, L)
    K = -2 * (A + B)
    P = D ** 2 + E ** 2
    Q = P + 1
    K_profile = -(A * D ** 2 + 2 * C * D * E + B * E ** 2) / (P * Q ** 1.5)
    K_cross = -2 * (B * D ** 2 + A * E ** 2 - C * D * E) / P
    K_long = -2 * (A * D ** 2 + B * E ** 2 + C * D * E) / P
    K_tan = -(A * E ** 2 - 2 * C * D * E + B * D ** 2) / (P * Q ** 0.5)
    K_plan = -(A * E ** 2 - 2 * C * D * E + B * D ** 2) / P ** 1.5
    finite = torch.isfinite(X)

    def fix(M):
        return torch.where(torch.isnan(M) & finite, 0.0, M)

    return (K, fix(K_profile), fix(K_plan), fix(K_tan), fix(K_long),
            fix(K_cross))


def wilson_gallant_curvature(X, cellsize=1, device=None):
    """Wilson & Gallant curvatures (neilpy.py:753-806).

    The reference calls ``ashift(X, 8)`` / ``ashift(X, 9)`` for Z7/Z8,
    which fall through every branch and return an *unshifted copy*;
    ``ashift`` keeps that quirk, so the outputs match the reference's
    actual behaviour."""
    X = as_raster(X, device)
    H = cellsize
    zs = dict(Z1=ashift(X, 2), Z2=ashift(X, 3), Z3=ashift(X, 4),
              Z4=ashift(X, 5), Z5=ashift(X, 6), Z6=ashift(X, 7),
              Z7=ashift(X, 8), Z8=ashift(X, 9))  # Z7, Z8: unshifted
    Z9 = X
    pairs = [("Z1", "Z5"), ("Z2", "Z6"), ("Z3", "Z7"), ("Z4", "Z8"),
             ("Z5", "Z1"), ("Z6", "Z2"), ("Z7", "Z3"), ("Z8", "Z4")]
    for a, b in pairs:
        zs[a] = torch.where(torch.isnan(zs[a]), 2 * Z9 - zs[b], zs[a])
    Z1, Z2, Z3, Z4 = zs["Z1"], zs["Z2"], zs["Z3"], zs["Z4"]
    Z5, Z6, Z7, Z8 = zs["Z5"], zs["Z6"], zs["Z7"], zs["Z8"]
    ZX = (Z2 - Z6) / (2 * H)
    ZY = (Z8 - Z4) / (2 * H)
    ZXX = (Z2 - 2 * Z9 + Z6) / H ** 2
    ZYY = (Z8 - 2 * Z9 + Z4) / H ** 2
    # the reference's ``/ 4*H**2``, i.e. *(H**2)/4 (neilpy.py:787), verbatim
    ZXY = (-Z7 + Z1 + Z5 - Z3) / 4 * H ** 2
    P = ZX ** 2 + ZY ** 2
    Q = P + 1
    Kc = (ZXX * ZY ** 2 - 2 * ZXY * ZX * ZY + ZYY * ZX ** 2) / P ** 1.5
    Kp = (ZXX * ZX ** 2 + 2 * ZXY * ZX * ZY + ZYY * ZY ** 2) / (P * Q ** 1.5)
    Kt = (ZXX * ZX ** 2 + 2 * ZXY * ZX * ZY + ZYY * ZY ** 2) / (P * Q ** 0.5)
    K = ZXX ** 2 + 2 * ZXY ** 2 + ZYY ** 2
    return K, Kp, Kc, Kt


def scaled_morphometry(X, cellsize=1, lookup_pixels=1, device=None):
    """Evans/Wood morphometry at an arbitrary lookup distance
    (neilpy.py:2472-2510).  Returns a dict with aspect A, slope S and six
    curvatures."""
    X = as_raster(X, device)
    L = cellsize * lookup_pixels
    n = dict(Z1=ashift(X, 0, lookup_pixels), Z2=ashift(X, 1, lookup_pixels),
             Z3=ashift(X, 2, lookup_pixels), Z4=ashift(X, 7, lookup_pixels),
             Z6=ashift(X, 3, lookup_pixels), Z7=ashift(X, 6, lookup_pixels),
             Z8=ashift(X, 5, lookup_pixels), Z9=ashift(X, 4, lookup_pixels))
    A, B, C, D, E = _evans_terms(X, n, L)
    P = D ** 2 + E ** 2
    Q = P + 1
    SM = {}
    SM["A"] = torch.remainder(270 - torch.rad2deg(torch.arctan2(E, D)), 360)
    SM["S"] = torch.rad2deg(torch.arctan(torch.sqrt(P)))
    SM["K"] = -2 * (A + B)
    SM["K_profile"] = (-(A * D ** 2 + 2 * C * D * E + B * E ** 2)
                       / (P * Q ** 1.5))
    SM["K_cross"] = -2 * (B * D ** 2 + A * E ** 2 - C * D * E) / P
    SM["K_long"] = -2 * (A * D ** 2 + B * E ** 2 + C * D * E) / P
    SM["K_tan"] = -(A * E ** 2 - 2 * C * D * E + B * D ** 2) / (P * Q ** 0.5)
    SM["K_plan"] = -(A * E ** 2 - 2 * C * D * E + B * D ** 2) / P ** 1.5
    return SM


# ----------------------------------------------------------------------
# VIP, windowed std, peak reduction, TPI
# ----------------------------------------------------------------------
def triangle_height(h0, h1, x_dist=1, device=None):
    """Point-to-chord triangle height via the cross product
    (neilpy.py:1818-1830)."""
    h0 = as_raster(h0, device)
    h1 = as_raster(h1, h0.device)
    cp = torch.abs(-x_dist * h1 - x_dist * h0)
    base = torch.sqrt((2 * x_dist) ** 2 + (h1 - h0) ** 2)
    return cp / base


def vip_score(Z, cellsize=1, device=None):
    """Very-Important-Points score: mean triangle height over the four
    opposing-neighbour axes (neilpy.py:1832-1845)."""
    Z = as_raster(Z, device)
    dlist = (2.0 ** 0.5, 1.0)
    heights = torch.zeros(Z.shape, dtype=torch.float32, device=Z.device)
    for direction in range(4):
        dist = dlist[direction % 2]
        h0 = ashift(Z, direction) - Z
        h1 = ashift(Z, direction + 4) - Z
        heights = heights + triangle_height(h0, h1, dist * cellsize)
    return heights / 4.0


def _uniform_correlate(X, kernel, mode="nearest"):
    """A uniformly weighted, point-symmetric kernel (c * binary, so
    flip == identity) takes the run-decomposed sum; a weighted one the
    convolution."""
    k = np.asarray(kernel, dtype=np.float64)
    nz = k[k != 0]
    if (nz.size and np.all(nz == nz[0])
            and np.array_equal(k, k[::-1, ::-1])):
        return binary_footprint_sum(X, k != 0, mode=mode) * float(nz[0])
    return convolve2d_nearest(X, kernel, mode=mode)


def std(X, strel, device=None):
    """Convolution-based windowed standard deviation
    (neilpy.py:2039-2047)."""
    X = as_raster(X, device)
    s = np.asarray(strel, dtype=np.float32)
    ssum = float(s.sum())
    Xsum = _uniform_correlate(X, s)
    Xss = _uniform_correlate(X ** 2, s)
    Xm = Xsum / ssum
    V = (Xss - 2 * Xm * Xsum + ssum * Xm ** 2) / ssum
    V = torch.where(V < 0, 0.0, V)
    return torch.sqrt(V)


def std2(X, strel, device=None):
    """Windowed RMS deviation from the local mean: the reference's older
    std prototype (neilpy.py:2051-2053) as the JAX package made it
    runnable (Z -> X, with a return): sqrt of the windowed mean of
    (local_mean - X)^2.  Not the windowed standard deviation; prefer
    :func:`std`."""
    X = as_raster(X, device)
    s = np.asarray(strel, dtype=np.float32)
    s = s / s.sum()
    M = _uniform_correlate(X, s)
    return torch.sqrt(_uniform_correlate((M - X) ** 2, s))


def reduce_peaks(Z, radius, blend_rate=2, kernel_rate="auto", device=None):
    """Distance-kernel smoothing blended by inverse local variability
    (neilpy.py:2056-2087)."""
    from ..core.grid import normalize
    if kernel_rate == "auto":
        kernel_rate = 1 / blend_rate
    strel = distance_kernel(radius, method="distance")
    strel = 1 - (strel / np.max(strel))
    strel = strel ** kernel_rate
    Z = as_raster(Z, device)
    M = convolve2d_nearest(Z, strel / strel.sum())
    STD = std(Z - M, strel)
    V = (1 - normalize(STD)) ** blend_rate
    return (1 - V) * M + V * Z


def topographic_position_index(X, radius=1, standardize=True, device=None):
    """TPI: value minus ring-mean (neilpy.py:2098-2124)."""
    X = as_raster(X, device)
    if radius == 1:
        strel = np.ones((3, 3), dtype=np.float64)
    else:
        strel = disk(radius).astype(np.float64)
    strel[radius, radius] = 0
    strel = strel / strel.sum()
    mean = _uniform_correlate(X, strel)
    result = X - mean
    if standardize:
        # the reference's formula, verbatim (flagged as suspect by its
        # author at neilpy.py:2118-2120)
        sd = torch.sqrt(torch.mean(_uniform_correlate(X ** 2, strel))
                        - torch.mean(result) ** 2)
        result = result / sd
    return result
