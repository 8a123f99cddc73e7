"""Paletted PNG output for class rasters (parity: the geomorphons2
PNG+palette path, neilpy/neilpy.py:1588-1594).  A copy of
``neilpy_tpu/io/png.py``."""

from __future__ import annotations

import numpy as np

__all__ = ["write_paletted_png"]


def write_paletted_png(fn, classes, cmap):
    """Write a uint8 class raster as a paletted PNG.

    ``cmap`` is {class_value: (r, g, b)} (e.g.
    ``core.codes.geomorphon_cmap()``).
    """
    from PIL import Image
    arr = np.asarray(classes).astype(np.uint8)
    im = Image.fromarray(arr, mode="L")
    palette = [0] * 768
    for value, rgb in cmap.items():
        palette[3 * int(value):3 * int(value) + 3] = list(rgb[:3])
    im = im.convert("P")
    im.putpalette(palette)
    im.save(fn)
