"""Terrain cartography: LUT relief shading and atmospheric perspective.

PyTorch counterpart of ``neilpy_tpu/viz/shading.py``, with the same names
and arguments plus ``device=`` last on the functions that run on the
device (numpy input goes to CUDA unless ``device='cpu'``).

The look-up tables are host numpy, as in the JAX package: ``corner_lut``
reproduces the reference's ``ndi.zoom([[2x2 corners]], 128)`` cubic-spline
construction in closed form, and the two asset-backed tables,
``swiss_lut`` and ``_gray_high_contrast_lut``, decode this package's own
byte-identical copies of ``_swiss_lut_residual.bin`` and
``_gray_hc_lut.bin`` (content of the reference neilpy package's shipped
PNGs, MIT-licensed).  The shading is a hillshade, an elevation rescale to
0..255 and one gather per pixel from the (elevation x illumination) table
on the device; uint8 results cast through ``core/device.to_uint8`` (NaN ->
0, saturating), so a NaN hole shades as ``lut[0, 0]``, as in JAX.

Parity targets (reference neilpy/neilpy.py): swiss_shading 1848-1863,
colortable_shade 1870-1914, brassel_atmospheric_perspective 1993-2031.
The reference's ``colortable_shade`` reads ``lut`` before assignment for
every named spec but 'gray' (neilpy.py:1896-1900); here, as in the JAX
package, every named spec builds its own table.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from ..core.device import to_uint8
from ..ops.surface import hillshade
from ..ops.visibility import as_raster

__all__ = ["swiss_shading", "colortable_shade", "corner_lut",
           "swiss_lut", "brassel_atmospheric_perspective", "lut_shade"]


# 4-corner colour specs: rows are [top-left, top-right, bottom-left,
# bottom-right] corners of the (elevation x illumination) LUT
# (the values of neilpy.py:1884-1896).
CORNER_SPECS = {
    "bare_earth_dark": [[90, 74, 84], [95, 77, 85], [40, 38, 74],
                        [116, 102, 109]],
    "bare_earth_medium": [[189, 169, 107], [203, 179, 114], [0, 0, 10],
                          [116, 102, 109]],
    "bare_earth_light": [[189, 169, 107], [203, 179, 114], [0, 0, 10],
                         [255, 255, 255]],
    "swiss_dark": [[110, 79, 107], [190, 192, 173], [40, 38, 74],
                   [244, 244, 190]],
    "swiss": [[129, 137, 131], [190, 192, 173], [117, 124, 121],
              [244, 244, 190]],
    "swiss_green": [[118, 162, 120], [177, 232, 158], [111, 123, 115],
                    [242, 254, 186]],
    "gray": [[0, 0, 0], [119, 119, 119], [1, 1, 1], [255, 255, 255]],
}


def _cubic_zoom_weights(n_out=256):
    """Interpolation weights of ``scipy.ndimage.zoom`` on a 2-sample axis
    (order-3 B-spline, mirror boundary), in closed form.

    For two samples (a, b) the mirror-extended cubic-spline coefficients
    are c0 = 2a - b, c1 = 2b - a, and zoom samples the spline at
    x_k = k/(n_out-1) in [0, 1], so the value is a fixed linear blend
    w_a(x)·a + w_b(x)·b with

        w_a = 2(B(x) + B(x-2)) - (B(x+1) + B(x-1)),   w_b = 1 - w_a

    (B = cubic B-spline kernel)."""

    def B3(t):
        t = np.abs(t)
        return np.where(t < 1, 2 / 3 - t ** 2 + t ** 3 / 2,
                        np.where(t < 2, (2 - t) ** 3 / 6, 0.0))

    x = np.arange(n_out) / (n_out - 1)
    wa = 2 * (B3(x) + B3(x - 2)) - (B3(x + 1) + B3(x - 1))
    wb = 2 * (B3(x + 1) + B3(x - 1)) - (B3(x) + B3(x - 2))
    return np.stack([wa, wb], axis=1)          # (n_out, 2)


def corner_lut(spec):
    """A 256x256x3 uint8 LUT from four corner colours: the reference's
    ``ndi.zoom([[c00, c01], [c10, c11]], 128)`` cubic-spline construction
    (neilpy.py:1896-1900; the spline overshoots between corners), clipped
    to [0, 255]."""
    spec = np.asarray(spec, dtype=np.float64)
    w = _cubic_zoom_weights()
    lut = np.zeros((256, 256, 3), dtype=np.uint8)
    for ch in range(3):
        C = np.array([[spec[0, ch], spec[1, ch]],
                      [spec[2, ch], spec[3, ch]]])
        v = np.round(w @ C @ w.T)
        lut[:, :, ch] = np.clip(v, 0, 255).astype(np.uint8)
    return lut


def _decode_row_deltas(filename, shape):
    """Decode a zlib'd int8 row-delta table of this directory back to the
    int16 array it encodes."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        filename)
    with open(path, "rb") as f:
        deltas = np.frombuffer(zlib.decompress(f.read()),
                               dtype=np.int8).reshape(shape)
    return np.cumsum(deltas.astype(np.int16), axis=0)


_SWISS_LUT_CACHE = None


def swiss_lut():
    """The exact 256x256x3 swiss-shading LUT the reference ships as
    ``swiss_shading_lookup.png`` (neilpy.py:1848-1863): the procedural
    ``corner_lut('swiss')`` base plus the residual embedded in
    ``_swiss_lut_residual.bin``.  A read-only view of a process-wide
    cache."""
    global _SWISS_LUT_CACHE
    if _SWISS_LUT_CACHE is None:
        base = corner_lut(CORNER_SPECS["swiss"]).astype(np.int16)
        residual = _decode_row_deltas("_swiss_lut_residual.bin",
                                      (256, 256, 3))
        lut = np.clip(base + residual, 0, 255).astype(np.uint8)
        lut.flags.writeable = False
        _SWISS_LUT_CACHE = lut
    return _SWISS_LUT_CACHE.view()


_GRAY_HC_LUT_CACHE = None


def _gray_high_contrast_lut():
    """The exact 256x256 grayscale LUT the reference ships as
    ``gray_high_contrast_lookup.png`` (neilpy.py:1870-1878), from
    ``_gray_hc_lut.bin``, replicated to 3 channels as the reference
    does.  A read-only view of a process-wide cache."""
    global _GRAY_HC_LUT_CACHE
    if _GRAY_HC_LUT_CACHE is None:
        g = _decode_row_deltas("_gray_hc_lut.bin", (256, 256))
        g = np.clip(g, 0, 255).astype(np.uint8)
        lut = np.stack((g, g, g), axis=2)
        lut.flags.writeable = False
        _GRAY_HC_LUT_CACHE = lut
    return _GRAY_HC_LUT_CACHE.view()


def _read_png(name):
    """A PNG as ``round(255 * matplotlib.pyplot.imread(name))`` would give
    it: 8-bit images as stored, palette images expanded to RGBA, 16-bit
    ones scaled to 0..255."""
    from PIL import Image
    with Image.open(name) as img:
        if img.mode == "P":
            img = img.convert("RGBA")
        lut = np.asarray(img)
    if lut.dtype != np.uint8:
        lut = np.round(255 * (lut / 65535.0)).astype(np.uint8)
    return lut


def _load_lut(name):
    if isinstance(name, str):
        if name.endswith(".png"):
            lut = _read_png(name)
            if lut.ndim == 2:
                lut = np.stack((lut, lut, lut), axis=2)
            if lut.shape[2] > 3:
                lut = lut[:, :, :3]
            return lut
        if name == "swiss":
            return swiss_lut()
        if name in CORNER_SPECS:
            return corner_lut(CORNER_SPECS[name])
        raise ValueError(f"unknown colortable '{name}'")
    lut = np.asarray(name)
    if lut.ndim != 3:
        lut = np.stack((lut, lut, lut), axis=2)
    return lut


def _nan_extreme(Z, largest):
    """``jnp.nanmax`` / ``jnp.nanmin`` of ``Z``: NaN when every value is
    NaN (``amax`` of an empty selection would raise)."""
    nan = torch.isnan(Z)
    fill = -torch.inf if largest else torch.inf
    Zf = torch.where(nan, fill, Z)
    m = Zf.amax() if largest else Zf.amin()
    return torch.where(nan.all(), torch.nan, m)


def lut_shade(Z, lut, cellsize=1, device=None):
    """Index a 256x256 (elevation x hillshade) LUT: the shared core of
    swiss_shading / colortable_shade, one gather per pixel on the
    device."""
    Z = as_raster(Z, device)
    H = hillshade(Z, cellsize)
    zmin = _nan_extreme(Z, largest=False)
    zmax = _nan_extreme(Z, largest=True)
    Z_norm = to_uint8(torch.round(255 * (Z - zmin) / (zmax - zmin)))
    table = torch.tensor(np.array(lut), device=Z.device)
    flat = table.reshape((-1,) + tuple(table.shape[2:]))
    idx = Z_norm.long() * table.shape[1] + H.long()
    return flat[idx]      # (H, W, 3)


def swiss_shading(Z, cellsize=1, lut=None, device=None):
    """Jenny & Hurni Swiss-style relief shading (parity:
    neilpy.py:1848-1863).  The default LUT is ``swiss_lut()``, bit-
    identical to the reference's shipped asset; ``lut`` may override it
    with any 256x256x3 array or PNG path."""
    if lut is None:
        lut = swiss_lut()
    else:
        lut = _load_lut(lut)
    return lut_shade(Z, lut, cellsize, device=device)


def colortable_shade(Z, name="swiss", cellsize=1, device=None):
    """Generalised LUT shading (parity: neilpy.py:1870-1914, with the
    unbound-lut bug fixed by construction)."""
    if isinstance(name, str) and name == "gray_high_contrast":
        lut = _gray_high_contrast_lut()
    else:
        lut = _load_lut(name)
    return lut_shade(Z, lut, cellsize, device=device)


def brassel_atmospheric_perspective(H, Z, k, flat=180, Zmid=None,
                                    reverse=False, C2=0, device=None):
    """Brassel (1974) atmospheric-perspective contrast on hillshades
    (parity: neilpy.py:1993-2031)."""
    if k < 1:
        raise ValueError("k must be equal to or greater than one.")
    H = as_raster(H, device)
    Z = as_raster(Z, H.device)
    was_int = bool((H > 1).any())
    if was_int:
        H = H / 255.0
    if flat > 1:
        flat = flat / 255.0
    Zmin = _nan_extreme(Z, largest=False)
    Zmax = _nan_extreme(Z, largest=True)
    if Zmid is None:
        Zstar = (Z - (Zmax + Zmin) / 2) / ((Zmax - Zmin) / 2)
    else:
        from ..core.grid import normalize
        Zstar = normalize(Z, xrange=[Zmin, Zmid, Zmax], yrange=[-1, 0, 1])
    if reverse:
        Zstar = -Zstar
    log_k = torch.log(torch.tensor(k, dtype=torch.float32, device=Z.device))
    exponent = torch.exp(Zstar * log_k)
    H_new = (H - flat) * exponent + flat
    H_new = torch.clip(H_new, 0.0, 1.0)
    if C2 != 0:
        H_new = H_new + (C2 * (Zstar - 1)) / 2
    if was_int:
        H_new = to_uint8(torch.round(255 * H_new))
    return H_new
