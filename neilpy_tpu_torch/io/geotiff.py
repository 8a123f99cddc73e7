"""Self-contained GeoTIFF reader/writer (no rasterio/GDAL).

The PyTorch package's copy of ``neilpy_tpu/io/geotiff.py``: the host
I/O behind the README's entry (``imread`` -> ``geomorphons`` ->
``imwrite``).  Parity surface: ``imread``/``imwrite`` (reference
neilpy/neilpy.py:114-190) — array + metadata dict with ``transform``
(our Affine), ``crs``, ``nodata``, ``bounds``, ``cellsize``, ``dtype``,
``width``, ``height``, ``count``.  A file written by either package
reads back in the other with the same array and georeferencing
(``tests/test_torch_core_io.py``).

Supported on read: baseline TIFF, little/big endian, strip or tile
organisation, uncompressed / PackBits / LZW / Deflate / new-style
JPEG (PIL as the entropy decoder, JPEGTables spliced per TechNote 2) /
ZSTD (COG extension 50000, via libzstd) / LZMA, horizontal and
floating-point predictors (2 and 3), grayscale or multi-band
(contiguous or planar), uint8/16/32, int8/16/32, float32/64, IFD
pyramid chains, plus the GeoTIFF ModelPixelScale/ModelTiepoint/
ModelTransformation tags and GDAL's NODATA ascii tag.  The codecs are
``io/tiff_codec.py``.  Windowed reads decode only the strips/tiles a
pixel rectangle touches.

Written files: little-endian baseline TIFF, strip-organised by default
or ``tiled=True``, uncompressed or LZW/Deflate/ZSTD via ``compress=``,
optional overview pyramids, GeoTIFF georeferencing, optional palette
and GDAL_NODATA.  The bytes equal the JAX package's writer's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..core.affine import Affine

__all__ = ["imread", "imwrite", "read_geotiff", "write_geotiff",
           "GeoTiffSource"]

# TIFF tag ids
_TAG_WIDTH = 256
_TAG_HEIGHT = 257
_TAG_BITSPERSAMPLE = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_STRIPOFFSETS = 273
_TAG_SAMPLESPERPIXEL = 277
_TAG_ROWSPERSTRIP = 278
_TAG_STRIPBYTECOUNTS = 279
_TAG_PLANARCONFIG = 284
_TAG_PREDICTOR = 317
_TAG_COLORMAP = 320
_TAG_TILEWIDTH = 322
_TAG_TILELENGTH = 323
_TAG_TILEOFFSETS = 324
_TAG_TILEBYTECOUNTS = 325
_TAG_SAMPLEFORMAT = 339
_TAG_JPEGTABLES = 347
_TAG_MODELPIXELSCALE = 33550
_TAG_MODELTIEPOINT = 33922
_TAG_MODELTRANSFORMATION = 34264
_TAG_GEOKEYDIRECTORY = 34735
_TAG_GDAL_NODATA = 42113

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "L", 5: "LL", 6: "b", 8: "h", 9: "l",
             10: "ll", 11: "f", 12: "d", 16: "Q", 17: "q"}


def _read_ifd_entries(data, off, en, bigtiff=False):
    entries = {}
    if bigtiff:
        (count,) = struct.unpack(en + "Q", data[off:off + 8])
        off += 8
        esize = 20
    else:
        (count,) = struct.unpack(en + "H", data[off:off + 2])
        off += 2
        esize = 12
    for i in range(count):
        e = data[off + i * esize: off + (i + 1) * esize]
        if bigtiff:
            tag, typ = struct.unpack(en + "HH", e[:4])
            (n,) = struct.unpack(en + "Q", e[4:12])
            payload = e[12:20]
        else:
            tag, typ = struct.unpack(en + "HH", e[:4])
            (n,) = struct.unpack(en + "L", e[4:8])
            payload = e[8:12]
        size = _TYPE_SIZES.get(typ, 1) * n
        if size <= len(payload):
            raw = payload[:size]
        else:
            (ptr,) = struct.unpack(en + ("Q" if bigtiff else "L"),
                                   payload)
            raw = data[ptr:ptr + size]
        entries[tag] = (typ, n, raw)
    if bigtiff:
        (nxt,) = struct.unpack(en + "Q",
                               data[off + count * esize: off + count * esize + 8])
    else:
        (nxt,) = struct.unpack(en + "L",
                               data[off + count * esize: off + count * esize + 4])
    return entries, nxt


def _values(entry, en):
    typ, n, raw = entry
    if typ == 2:  # ascii
        return bytes(raw).split(b"\x00")[0].decode("latin-1")
    fmt = _TYPE_FMT.get(typ)
    if fmt is None:
        return raw
    vals = struct.unpack(en + fmt * n, raw[: struct.calcsize(en + fmt * n)])
    if typ in (5, 10):  # rationals
        vals = tuple(a / b if b else 0.0 for a, b in
                     zip(vals[::2], vals[1::2]))
    return vals


def _dtype_from(bits, sample_format, en):
    if bits % 8 or bits == 0:
        # 1-/4-bit TIFFs (fax masks, GDAL mask bands) — say so plainly
        # instead of crashing in numpy with "data type 'u0'"
        raise ValueError(f"BitsPerSample={bits} is not supported "
                         "(only 8/16/32/64-bit samples)")
    kind = {1: "u", 2: "i", 3: "f"}.get(sample_format, "u")
    return np.dtype(f"{'<' if en == '<' else '>'}{kind}{bits // 8}")


def _decompress(raw, compression, expected, predictor, width, dtype,
                samples, jpeg_tables=None):
    if compression == 1:
        out = raw
    elif compression == 5:  # LZW (native kernel or python fallback)
        from .tiff_codec import lzw_decode
        out = lzw_decode(raw, expected)
    elif compression in (8, 32946):  # Deflate / zlib
        out = zlib.decompress(raw)
    elif compression == 32773:  # PackBits (vectorised / native)
        from .tiff_codec import packbits_decode
        out = packbits_decode(raw, expected)
    elif compression == 7:  # new-style JPEG (PIL as entropy decoder)
        from .tiff_codec import jpeg_decode
        out = jpeg_decode(bytes(raw), jpeg_tables)
    elif compression == 50000:  # ZSTD (GDAL/COG extension, libzstd)
        from .tiff_codec import zstd_decode
        out = zstd_decode(raw, expected)
    elif compression == 34925:  # LZMA2 (libtiff writes xz-container frames)
        import lzma
        out = lzma.decompress(bytes(raw))
    else:
        raise ValueError(f"Unsupported TIFF compression {compression}")
    if predictor == 2:
        arr = np.frombuffer(out, dtype=dtype)[: expected // dtype.itemsize]
        arr = arr.reshape(-1, width * samples).copy()
        arr = np.cumsum(arr.reshape(arr.shape[0], width, samples),
                        axis=1, dtype=arr.dtype)
        out = arr.tobytes()
    elif predictor == 3:
        # Floating-point predictor (TIFF TechNote 3, GDAL PREDICTOR=3):
        # each row's values are split into byte planes ordered MSB→LSB,
        # then horizontally byte-differenced.  Undo: cumsum the bytes
        # across the row, then re-interleave the planes as big-endian
        # floats.
        it = dtype.itemsize
        rowbytes = width * samples * it
        arr = np.frombuffer(out, dtype=np.uint8)[: expected].copy()
        arr = arr.reshape(-1, rowbytes)
        np.cumsum(arr, axis=1, dtype=np.uint8, out=arr)
        planes = arr.reshape(-1, it, width * samples)
        be = np.ascontiguousarray(planes.transpose(0, 2, 1))
        out = be.reshape(-1).tobytes()
        be_dtype = dtype.newbyteorder(">")
        vals = np.frombuffer(out, dtype=be_dtype).astype(dtype)
        out = vals.tobytes()
    return out[:expected]


class GeoTiffSource:
    """Lazily-windowed GeoTIFF reader: parse the IFD once, then decode
    only the strips/tiles a requested window intersects (with a small
    LRU block cache for overlapping windows).

    Array-like (``shape``, ``dtype``, ``nbytes``, ``src[r0:r1, c0:c1]``,
    ``np.asarray(src)``), so ``dist.tiled_apply`` and
    ``pipelines.mosaic`` stream a (Big)TIFF from disk window by window
    without materialising it.
    """

    def __init__(self, fn, cache_bytes=64 << 20, level=0):
        # memory-map instead of slurping: multi-GB BigTIFF mosaics
        # read lazily; only touched blocks are ever paged in
        data = memoryview(np.memmap(fn, dtype=np.uint8, mode="r"))
        if data[:2] == b"II":
            en = "<"
        elif data[:2] == b"MM":
            en = ">"
        else:
            raise ValueError("Not a TIFF file")
        (magic,) = struct.unpack(en + "H", data[2:4])
        bigtiff = magic == 43
        if bigtiff:
            (first_ifd,) = struct.unpack(en + "Q", data[8:16])
        else:
            (first_ifd,) = struct.unpack(en + "L", data[4:8])

        # walk the whole IFD chain: level 0 is the full raster, later
        # IFDs are overviews/pyramids (GDAL .ovr sidecars are bare
        # TIFFs whose level 0 is already a reduced image)
        all_tags = []
        off = first_ifd
        while off:
            t, off = _read_ifd_entries(data, off, en, bigtiff)
            all_tags.append(t)
            if len(all_tags) > 64:
                raise ValueError("TIFF IFD chain too long (corrupt?)")
        self.levels = []
        for t in all_tags:
            gv = lambda tg: _values(t[tg], en)
            self.levels.append((int(gv(_TAG_HEIGHT)[0]),
                                int(gv(_TAG_WIDTH)[0])))
        if not -len(all_tags) <= level < len(all_tags):
            raise ValueError(
                f"level {level} out of range: file has "
                f"{len(all_tags)} IFD(s) {self.levels}")
        self.level = level % len(all_tags)
        tags = all_tags[self.level]

        g = lambda t, d=None: (_values(tags[t], en) if t in tags else d)
        self._data = data
        self._en = en
        self.width = int(g(_TAG_WIDTH)[0])
        self.height = int(g(_TAG_HEIGHT)[0])
        spp = int(g(_TAG_SAMPLESPERPIXEL, (1,))[0])
        bits = int(g(_TAG_BITSPERSAMPLE, (8,))[0])
        self._comp = int(g(_TAG_COMPRESSION, (1,))[0])
        sfmt = int(g(_TAG_SAMPLEFORMAT, (1,))[0])
        self._planar = int(g(_TAG_PLANARCONFIG, (1,))[0])
        self._predictor = int(g(_TAG_PREDICTOR, (1,))[0])
        jpt = tags.get(_TAG_JPEGTABLES)
        self._jpeg_tables = (bytes(_values(jpt, en))
                             if jpt is not None else None)
        self._dtype_raw = _dtype_from(bits, sfmt, en)
        self._planes = spp if self._planar == 2 else 1
        self._chans = 1 if self._planar == 2 else spp

        self._tiled = _TAG_TILEOFFSETS in tags
        if self._tiled:
            self._tw = int(g(_TAG_TILEWIDTH)[0])
            self._th = int(g(_TAG_TILELENGTH)[0])
            self._offsets = g(_TAG_TILEOFFSETS)
            self._counts = g(_TAG_TILEBYTECOUNTS)
        else:
            self._tw = self.width
            self._th = int(g(_TAG_ROWSPERSTRIP, (self.height,))[0])
            self._offsets = g(_TAG_STRIPOFFSETS)
            self._counts = g(_TAG_STRIPBYTECOUNTS)
        self._bx = (self.width + self._tw - 1) // self._tw
        self._by = (self.height + self._th - 1) // self._th

        # --- georeferencing ---
        transform = Affine.identity()
        g0 = lambda t, d=None: (_values(all_tags[0][t], en)
                                if t in all_tags[0] else d)
        # ModelTransformationTag (row-major 4x4): the only GeoTIFF
        # encoding of rotated or south-up transforms; takes precedence
        # over PixelScale+Tiepoint (GDAL convention) when both exist
        xf = g(_TAG_MODELTRANSFORMATION)
        rx = ry = 1.0
        if xf is None and self.level > 0:
            xf = g0(_TAG_MODELTRANSFORMATION)
            if xf is not None:
                h0, w0 = self.levels[0]
                rx, ry = w0 / self.width, h0 / self.height
        if xf is not None and len(xf) >= 8:
            m = [float(v) for v in xf]
            transform = Affine(m[0] * rx, m[1] * ry, m[3],
                               m[4] * rx, m[5] * ry, m[7])
            self.transform = transform
            scale = tie = None
        else:
            scale = g(_TAG_MODELPIXELSCALE)
            tie = g(_TAG_MODELTIEPOINT)
            if (not (scale and tie)) and self.level > 0:
                # overview IFDs usually carry no geo tags; GDAL
                # convention is that overviews share the full raster's
                # extent, so scale level 0's georeferencing by the
                # size ratio
                scale0 = g0(_TAG_MODELPIXELSCALE)
                tie = g0(_TAG_MODELTIEPOINT)
                if scale0:
                    h0, w0 = self.levels[0]
                    scale = (float(scale0[0]) * w0 / self.width,
                             float(scale0[1]) * h0 / self.height)
            if scale and tie and len(tie) >= 6:
                sx, sy = float(scale[0]), float(scale[1])
                i, j, _, x, y, _ = tie[:6]
                transform = Affine(sx, 0.0, x - i * sx,
                                   0.0, -sy, y + j * sy)
        self.transform = transform

        def _nodata_from(tagmap):
            if _TAG_GDAL_NODATA not in tagmap:
                return None
            nd = _values(tagmap[_TAG_GDAL_NODATA], en)
            if isinstance(nd, str):
                try:
                    return float(nd.strip())
                except ValueError:
                    return None
            return nd

        def _crs_from(tagmap):
            if _TAG_GEOKEYDIRECTORY not in tagmap:
                return None
            keys = _values(tagmap[_TAG_GEOKEYDIRECTORY], en)
            # GeoKey 3072 = ProjectedCSTypeGeoKey, 2048 = GeographicType
            for k in range(4, len(keys), 4):
                if keys[k] in (3072, 2048) and keys[k + 1] == 0:
                    return int(keys[k + 3])
            return None

        self.nodata = _nodata_from(tags)
        self.crs = _crs_from(tags)
        if self.level > 0:
            # overview IFDs usually carry no nodata/CRS tags either —
            # inherit from level 0 the same way georeferencing does,
            # so masked reads work at every pyramid level
            if self.nodata is None:
                self.nodata = _nodata_from(all_tags[0])
            if self.crs is None:
                self.crs = _crs_from(all_tags[0])

        self._cache = {}
        self._cache_order = []
        self._cache_bytes = 0
        self._cache_cap = int(cache_bytes)

    # ---- array-like surface ------------------------------------------
    @property
    def dtype(self):
        return np.dtype(self._dtype_raw.newbyteorder("="))

    @property
    def nbands(self):
        return self._planes if self._planar == 2 else self._chans

    @property
    def ndim(self):
        return 2 if self.nbands == 1 else 3

    @property
    def shape(self):
        if self.nbands == 1:
            return (self.height, self.width)
        return (self.height, self.width, self.nbands)

    @property
    def nbytes(self):
        n = self.height * self.width * self.nbands
        return n * self.dtype.itemsize

    def __len__(self):
        return self.height

    def __array__(self, dtype=None, copy=None):
        arr = self._window(0, self.height, 0, self.width)
        return arr.astype(dtype) if dtype is not None else arr

    def __getitem__(self, key):
        """int/slice indexing (step 1) of rows, columns and, for a
        multi-band raster, the band; decodes only the touched blocks."""
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > self.ndim:
            raise IndexError("too many indices for GeoTiffSource")
        sq = []
        bounds = []
        for ax, (k, n) in enumerate(zip(key, (self.height, self.width))):
            if isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step != 1:
                    raise IndexError(
                        "GeoTiffSource supports step-1 slices only")
                bounds.append((start, max(stop, start)))
            elif isinstance(k, (int, np.integer)):
                k = int(k)
                if k < 0:
                    k += n
                if not 0 <= k < n:
                    raise IndexError(f"index {k} out of range (axis {ax})")
                bounds.append((k, k + 1))
                sq.append(ax)
            else:
                raise IndexError(
                    "GeoTiffSource supports int/slice indexing only")
        while len(bounds) < 2:
            bounds.append((0, (self.height, self.width)[len(bounds)]))
        (r0, r1), (c0, c1) = bounds
        arr = self._window(r0, r1, c0, c1)
        band = key[2] if len(key) == 3 else None
        if band is not None:
            arr = arr[:, :, band]
        for ax in reversed(sq):
            arr = np.squeeze(arr, axis=ax)
        return arr

    # ---- decoding ----------------------------------------------------
    def _block(self, p, by, bx):
        """Decoded block (rows, cols, chans) for plane ``p``, block row
        ``by``, block col ``bx`` — LRU-cached."""
        key = (p, by, bx)
        blk = self._cache.get(key)
        if blk is not None:
            return blk
        idx = (p * self._by + by) * self._bx + bx
        if self._tiled:
            nrows, ncols = self._th, self._tw
        else:
            nrows = min(self._th, self.height - by * self._th)
            ncols = self.width
        expected = nrows * ncols * self._chans * self._dtype_raw.itemsize
        raw = self._data[self._offsets[idx]:
                         self._offsets[idx] + self._counts[idx]]
        buf = _decompress(raw, self._comp, expected, self._predictor,
                          ncols, self._dtype_raw, self._chans,
                          self._jpeg_tables)
        blk = np.frombuffer(buf, dtype=self._dtype_raw).reshape(
            nrows, ncols, self._chans)
        self._cache[key] = blk
        self._cache_order.append(key)
        self._cache_bytes += blk.nbytes
        while self._cache_bytes > self._cache_cap and len(self._cache) > 1:
            old = self._cache_order.pop(0)
            self._cache_bytes -= self._cache.pop(old).nbytes
        return blk

    def _window(self, r0, r1, c0, c1):
        if not (0 <= r0 <= r1 <= self.height
                and 0 <= c0 <= c1 <= self.width):
            raise ValueError(
                f"window ({r0}:{r1}, {c0}:{c1}) outside raster "
                f"{self.height}x{self.width}")
        h, w = r1 - r0, c1 - c0
        img = np.zeros((self._planes, h, w, self._chans),
                       dtype=self._dtype_raw)
        th, tw = self._th, self._tw
        for p in range(self._planes):
            for by in range(r0 // th, min(-(-r1 // th), self._by)):
                y0 = by * th
                yv = min(th, self.height - y0)  # valid rows in block
                ys0, ys1 = max(r0, y0), min(r1, y0 + yv)
                if ys1 <= ys0:
                    continue
                for bx in range(c0 // tw, min(-(-c1 // tw), self._bx)):
                    x0 = bx * tw
                    xv = min(tw, self.width - x0)
                    xs0, xs1 = max(c0, x0), min(c1, x0 + xv)
                    if xs1 <= xs0:
                        continue
                    blk = self._block(p, by, bx)
                    img[p, ys0 - r0:ys1 - r0, xs0 - c0:xs1 - c0] = \
                        blk[ys0 - y0:ys1 - y0, xs0 - x0:xs1 - x0]
        if self._planar == 2:
            arr = np.moveaxis(img[:, :, :, 0], 0, -1)
        else:
            arr = img[0]
        if arr.shape[-1] == 1:
            arr = arr[:, :, 0]
        if self._en == ">":
            arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr

    # ---- metadata ----------------------------------------------------
    def _meta(self, r0, r1, c0, c1):
        width, height = c1 - c0, r1 - r0
        # pixel (c0, r0) becomes the new origin: translate the affine
        a, b, _, d, e, _ = self.transform
        cx, fy = self.transform * (c0, r0)
        transform = Affine(a, b, cx, d, e, fy)
        meta = {
            "driver": "GTiff", "width": width, "height": height,
            "count": self.nbands, "dtype": str(self.dtype),
            "transform": transform, "crs": self.crs,
            "nodata": self.nodata,
        }
        x0, y0 = transform * (0, 0)
        x1, y1 = transform * (width, height)
        meta["bounds"] = (min(x0, x1), min(y0, y1),
                          max(x0, x1), max(y0, y1))
        cellsizes = np.abs(np.array((transform[0], transform[4])))
        # abs(): the signed diff let any xres > yres raster masquerade
        # as square pixels and take the scalar-mean cellsize
        meta["cellsize"] = (float(np.mean(cellsizes))
                            if abs(np.diff(cellsizes)[0]) < 1e-8
                            else cellsizes)
        return meta

    @property
    def meta(self):
        return self._meta(0, self.height, 0, self.width)

    def read(self, window=None, return_metadata=True):
        """Read the whole raster or a ``window`` = ((r0, r1), (c0, c1))
        pixel rectangle (also accepted: a pair of slices).  Only the
        strips/tiles the window touches are decoded.  Returns
        ``(array, metadata)`` with the window's own translated
        ``transform``/``bounds`` so a windowed read is a first-class
        georeferenced raster."""
        if window is None:
            r0, r1, c0, c1 = 0, self.height, 0, self.width
        else:
            rows, cols = window
            if isinstance(rows, slice):
                r0, r1, rstep = rows.indices(self.height)
                if rstep != 1:
                    raise ValueError("windowed reads do not support "
                                     "strided slices (step != 1); "
                                     "decimate after reading or use "
                                     "an overview level=")
            else:
                r0, r1 = int(rows[0]), int(rows[1])
            if isinstance(cols, slice):
                c0, c1, cstep = cols.indices(self.width)
                if cstep != 1:
                    raise ValueError("windowed reads do not support "
                                     "strided slices (step != 1); "
                                     "decimate after reading or use "
                                     "an overview level=")
            else:
                c0, c1 = int(cols[0]), int(cols[1])
        arr = self._window(r0, r1, c0, c1)
        if return_metadata:
            return arr, self._meta(r0, r1, c0, c1)
        return arr


def read_geotiff(fn, window=None, level=0):
    """Read a (Geo)TIFF.  Returns (array, metadata dict).

    Multi-band rasters come back as (H, W, bands) like the reference's
    ``imread`` (neilpy.py:129).  ``window=((r0, r1), (c0, c1))`` reads
    a pixel rectangle, decoding only the strips/tiles it touches (see
    :class:`GeoTiffSource`).  ``level`` selects an IFD from the
    pyramid chain (0 = full resolution; overview transforms are
    derived from level 0 when the overview IFD has no geo tags, per
    the GDAL shared-extent convention).
    """
    return GeoTiffSource(fn, level=level).read(window=window)


def _host_array(im):
    """numpy array of ``im``; a torch tensor is copied to the host."""
    if isinstance(im, torch.Tensor):
        return im.detach().cpu().numpy()
    return np.asarray(im)


def _np_to_sampleformat(dt):
    if dt.kind == "u":
        return 1
    if dt.kind == "i":
        return 2
    if dt.kind == "f":
        return 3
    raise ValueError(f"Unsupported dtype {dt}")


_COMPRESS_IDS = {"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773,
                 "zstd": 50000}


_TAG_NEWSUBFILETYPE = 254


def _overview_downsample(a, k, method, nodata=None):
    """(H, W, B) -> (ceil(H/k), ceil(W/k), B) reduced image.

    A numeric ``nodata`` is masked out of the average exactly like NaN
    (GDAL's convention), and blocks that are all-nodata get the nodata
    value back — otherwise a -9999 border would bleed into every
    overview pixel it touches.

    Streams the source in row blocks (the float64 working copy used to
    be the WHOLE raster — three 80 GB materializations for a memmapped
    100k x 100k input with overviews=(2,4,8)); with level cascading in
    ``write_geotiff`` the peak extra memory is now one block plus the
    reduced level itself."""
    if method == "nearest":
        return a[::k, ::k]
    h, w, b = a.shape
    hh, ww = -(-h // k), -(-w // k)
    out = np.empty((hh, ww, b), dtype=a.dtype)
    numeric_nodata = nodata is not None and not np.isnan(nodata)
    # compare in the RASTER's dtype: a float32 file stores
    # float32(nodata), which generally != float64(nodata) after the
    # cast below (e.g. -99999.9 -> -99999.8984375) — matching the
    # f64 literal would miss every nodata cell
    nd_cast = float(a.dtype.type(nodata)) if numeric_nodata else None
    # ~16 MB of f64 working copy per block, in multiples of k rows
    rows = max(1, (16 << 20) // max(w * b * 8, 1) // k) * k
    import warnings
    for r0 in range(0, h, rows):
        blk = np.asarray(a[r0:r0 + rows])
        bh = blk.shape[0]
        bhh = -(-bh // k)
        bp = np.pad(blk, ((0, bhh * k - bh), (0, ww * k - w), (0, 0)),
                    mode="edge").astype(np.float64)
        if numeric_nodata:
            bp[bp == nd_cast] = np.nan
        blocks = bp.reshape(bhh, k, ww, k, b)
        with warnings.catch_warnings():
            # all-NaN blocks legitimately stay NaN
            warnings.simplefilter("ignore", category=RuntimeWarning)
            red = np.nanmean(blocks, axis=(1, 3))
        if numeric_nodata:
            red = np.where(np.isnan(red), float(nodata), red)
        out[r0 // k:r0 // k + bhh] = red.astype(a.dtype)
    return out


def write_geotiff(fn, im, transform=None, crs=None, nodata=None,
                  colormap=None, bigtiff=None, compress="none",
                  tiled=False, tile_size=256, overviews=(),
                  overview_resampling=None):
    """Write a (Geo)TIFF, strip-organised by default.

    ``im`` may be (H, W) or (H, W, bands) or (bands, H, W); uint8/16/32,
    int16/32, float32/64, as a numpy array or a torch tensor on any
    device.  ``colormap`` is a {value: (r, g, b)} dict producing a
    paletted single-band file.  ``compress`` is one of
    'none' | 'deflate' | 'lzw' | 'zstd' (per-block, own encoders — the
    reference delegates compressed writes to rasterio,
    neilpy.py:165-190).

    ``tiled=True`` writes ``tile_size``² tiles instead of strips, and
    ``overviews=(2, 4, ...)`` appends reduced-resolution IFDs to the
    pyramid chain (NewSubfileType=1; block-averaged for float data,
    nearest for integer/palette data unless ``overview_resampling``
    forces 'nearest'/'average') — together these make the output
    cloud-optimized-style: ``GeoTiffSource`` window reads of a tiled
    file decode only touched tiles, and ``imread(..., level=)`` serves
    the pyramid.

    ``bigtiff=None`` auto-selects BigTIFF (version 43, 8-byte offsets)
    when the payload approaches the classic 4 GB limit — the 100k x
    100k mosaic outputs need it.  Full-resolution uncompressed blocks
    are streamed to the file, so memory-mapped mosaics are written
    without a second in-RAM copy.
    """
    im = _host_array(im)
    # (bands, H, W) convenience input: reinterpret channels-first ONLY
    # when the trailing axis cannot itself be a band count — otherwise
    # a small (H, W, bands) raster like (2, 3, 3) would be misread as
    # channels-first (found by fuzzing, tests/test_fuzz.py)
    if (im.ndim == 3 and im.shape[0] <= 4
            and im.shape[0] < min(im.shape[1:]) and im.shape[2] > 4):
        im = np.moveaxis(im, 0, -1)
    if im.ndim == 2:
        im = im[:, :, None]
    height, width, bands = im.shape
    dt = im.dtype.newbyteorder("<")
    im = im.astype(dt, copy=False)

    if compress is None:  # rasterio-convention alias for 'none'
        compress = "none"
    if compress not in ("none", "deflate", "lzw", "zstd"):
        raise ValueError(
            "compress must be None, 'none', 'deflate', 'lzw' or 'zstd'")
    tile_size = int(tile_size)
    if tiled and (tile_size % 16 or tile_size < 16):
        raise ValueError("tile_size must be a positive multiple of 16")
    ovs = sorted(int(k) for k in overviews)
    if any(k < 2 for k in ovs):
        raise ValueError("overview factors must be >= 2")
    if overview_resampling is None:
        overview_resampling = ("average" if dt.kind == "f"
                               and colormap is None else "nearest")
    if overview_resampling not in ("average", "nearest"):
        raise ValueError("overview_resampling must be "
                         "'average' or 'nearest'")

    if colormap is not None and dt != np.dtype("<u1"):
        raise ValueError("colormap requires uint8 data")

    enc = None
    if compress != "none":
        from .tiff_codec import lzw_encode, zstd_encode
        enc = {"lzw": lzw_encode,
               "zstd": zstd_encode}.get(compress,
                                        lambda b: zlib.compress(b, 6))

    # cascade levels GDAL-style (each from the previous when the
    # factors nest): level 8 of a memmapped mosaic reduces the level-4
    # array instead of re-reading the full-resolution input — for
    # 'nearest' the result is identical, for 'average' it is the same
    # mean-of-means gdaladdo computes
    levels = [im]
    prev, prev_k = im, 1
    for k in ovs:
        src, kk = ((prev, k // prev_k)
                   if (k % prev_k == 0 and k > prev_k) else (im, k))
        lv = _overview_downsample(src, kk, overview_resampling,
                                  nodata=nodata)
        levels.append(lv)
        prev, prev_k = lv, k

    # --- per-level block layout -------------------------------------
    # blocks are produced lazily (callables) so uncompressed
    # full-resolution data streams from a memmap without a second copy
    level_specs = []
    for a in levels:
        h, w = a.shape[:2]
        if tiled:
            tw = th = tile_size
            nbx, nby = -(-w // tw), -(-h // th)

            def block_bytes(a=a, tw=tw, th=th, nbx=nbx, h=h, w=w):
                for by in range(-(-h // th)):
                    for bx in range(-(-w // tw)):
                        t = a[by * th:(by + 1) * th, bx * tw:(bx + 1) * tw]
                        if t.shape[:2] != (th, tw):
                            t = np.pad(t, ((0, th - t.shape[0]),
                                           (0, tw - t.shape[1]), (0, 0)))
                        yield np.ascontiguousarray(t).tobytes()
            layout = {"tiled": True, "tw": tw, "th": th}
            n_blocks = nbx * nby
            raw_counts = [th * tw * bands * dt.itemsize] * n_blocks
        else:
            rps = max(1, min(h, (1 << 20) // max(1, w * bands
                                                 * dt.itemsize)))
            n_blocks = (h + rps - 1) // rps

            def block_bytes(a=a, rps=rps, n=n_blocks):
                for s in range(n):
                    yield np.ascontiguousarray(
                        a[s * rps:(s + 1) * rps]).tobytes()
            layout = {"tiled": False, "rps": rps}
            raw_counts = [min(rps, h - s * rps) * w * bands * dt.itemsize
                          for s in range(n_blocks)]
        if enc is None:
            counts, blobs = raw_counts, None
        else:
            blobs = [enc(b) for b in block_bytes()]
            counts = [len(b) for b in blobs]
        level_specs.append({"a": a, "layout": layout, "counts": counts,
                            "blobs": blobs, "gen": block_bytes})

    total_data = sum(sum(s["counts"]) for s in level_specs)
    if bigtiff is None:
        bigtiff = total_data > (2 ** 32 - 2 ** 26)  # 64 MB of headroom

    off_type = 16 if bigtiff else 4        # LONG8 vs LONG
    entry_size = 20 if bigtiff else 12
    inline_cap = 8 if bigtiff else 4
    first_ifd = 16 if bigtiff else 8

    def pack_vals(typ, vals):
        if typ == 2:
            return vals if isinstance(vals, bytes) else vals.encode()
        fmt = _TYPE_FMT[typ]
        return b"".join(struct.pack("<" + fmt, v) for v in vals)

    def level_tags(spec, is_overview):
        a, layout, counts = spec["a"], spec["layout"], spec["counts"]
        h, w = a.shape[:2]
        tags = [(_TAG_WIDTH, 4, [w]), (_TAG_HEIGHT, 4, [h]),
                (_TAG_BITSPERSAMPLE, 3, [dt.itemsize * 8] * bands),
                (_TAG_COMPRESSION, 3, [_COMPRESS_IDS[compress]]),
                (_TAG_SAMPLESPERPIXEL, 3, [bands]),
                (_TAG_PLANARCONFIG, 3, [1]),
                (_TAG_SAMPLEFORMAT, 3, [_np_to_sampleformat(dt)] * bands)]
        photometric = 1
        if colormap is not None:
            photometric = 3
        elif bands >= 3:
            photometric = 2
        tags.append((_TAG_PHOTOMETRIC, 3, [photometric]))
        if is_overview:
            tags.append((_TAG_NEWSUBFILETYPE, 4, [1]))
        if layout["tiled"]:
            tags += [(_TAG_TILEWIDTH, 4, [layout["tw"]]),
                     (_TAG_TILELENGTH, 4, [layout["th"]]),
                     (_TAG_TILEOFFSETS, off_type, [0] * len(counts)),
                     (_TAG_TILEBYTECOUNTS, off_type, counts)]
        else:
            tags += [(_TAG_ROWSPERSTRIP, 4, [layout["rps"]]),
                     (_TAG_STRIPOFFSETS, off_type, [0] * len(counts)),
                     (_TAG_STRIPBYTECOUNTS, off_type, counts)]
        if colormap is not None:
            # every paletted IFD needs its ColorMap — photometric=3
            # without one is invalid TIFF, and overview levels carry
            # photometric=3 too
            cm = np.zeros((3, 256), dtype="<u2")
            for value, rgb in colormap.items():
                cm[:, int(value)] = [c * 257 for c in rgb[:3]]
            tags.append((_TAG_COLORMAP, 3, list(cm.ravel())))
        if not is_overview:
            if transform is not None:
                t = transform
                if t[1] != 0 or t[3] != 0 or t[4] > 0 or t[0] < 0:
                    # rotated, south-up, or mirrored: PixelScale +
                    # Tiepoint cannot represent these (the old code
                    # silently wrote abs/-sy and corrupted the
                    # georeferencing on round-trip) — emit the full
                    # ModelTransformationTag instead
                    tags.append((_TAG_MODELTRANSFORMATION, 12,
                                 [t[0], t[1], 0.0, t[2],
                                  t[3], t[4], 0.0, t[5],
                                  0.0, 0.0, 0.0, 0.0,
                                  0.0, 0.0, 0.0, 1.0]))
                else:
                    tags.append((_TAG_MODELPIXELSCALE, 12,
                                 [abs(t[0]), abs(t[4]), 0.0]))
                    tags.append((_TAG_MODELTIEPOINT, 12,
                                 [0.0, 0.0, 0.0, t[2], t[5], 0.0]))
            if crs is not None:
                epsg = int(crs)
                model, key = ((1, 3072) if epsg not in range(4000, 5000)
                              else (2, 2048))
                tags.append((_TAG_GEOKEYDIRECTORY, 3,
                             [1, 1, 0, 3,
                              1024, 0, 1, model,
                              1025, 0, 1, 1,
                              key, 0, 1, epsg]))
            if nodata is not None:
                nd = (f"{nodata:.18g}" if isinstance(nodata, float)
                      else str(nodata)) + "\x00"
                tags.append((_TAG_GDAL_NODATA, 2, nd.encode()))
        tags.sort(key=lambda x: x[0])
        return tags

    # --- serialize the chain: [IFDi + ext values][level-i data] ... --
    offsets_tag = {True: _TAG_TILEOFFSETS, False: _TAG_STRIPOFFSETS}
    pos = first_ifd
    serialized = []
    for li, spec in enumerate(level_specs):
        tags = level_tags(spec, li > 0)
        n_entries = len(tags)
        ifd_size = ((8 + n_entries * entry_size + 8) if bigtiff
                    else (2 + n_entries * entry_size + 4))
        ext_size = 0
        for tid, typ, vals in tags:
            raw = pack_vals(typ, vals)
            if len(raw) > inline_cap:
                ext_size += len(raw) + (len(raw) % 2)
        data_start = pos + ifd_size + ext_size
        offs, p = [], data_start
        for c in spec["counts"]:
            offs.append(p)
            p += c
        next_ifd = p if li + 1 < len(level_specs) else 0

        entries, ext_blobs = [], []
        ext_off = pos + ifd_size
        for tid, typ, vals in tags:
            if tid == offsets_tag[spec["layout"]["tiled"]]:
                vals = offs
            raw = pack_vals(typ, vals)
            n = len(raw) if typ == 2 else len(vals)
            if len(raw) <= inline_cap:
                payload = raw.ljust(inline_cap, b"\x00")
            else:
                payload = struct.pack("<Q" if bigtiff else "<L", ext_off)
                ext_blobs.append(raw if len(raw) % 2 == 0
                                 else raw + b"\x00")
                ext_off += len(raw) + (len(raw) % 2)
            if bigtiff:
                entries.append(struct.pack("<HHQ", tid, typ, n) + payload)
            else:
                entries.append(struct.pack("<HHL", tid, typ, n) + payload)

        head = bytearray()
        if bigtiff:
            head += struct.pack("<Q", n_entries)
        else:
            head += struct.pack("<H", n_entries)
        for e in entries:
            head += e
        head += struct.pack("<Q" if bigtiff else "<L", next_ifd)
        for blob in ext_blobs:
            head += blob
        assert pos + len(head) == data_start, (pos, len(head), data_start)
        serialized.append(head)
        pos = p

    with open(fn, "wb") as f:
        if bigtiff:
            f.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, first_ifd))
        else:
            f.write(b"II" + struct.pack("<HL", 42, first_ifd))
        for spec, head in zip(level_specs, serialized):
            f.write(bytes(head))
            if spec["blobs"] is not None:
                for b in spec["blobs"]:
                    f.write(b)
            else:
                for b in spec["gen"]():
                    f.write(b)


# ----------------------------------------------------------------------
# Reference-parity wrappers
# ----------------------------------------------------------------------
def imread(fn, return_metadata=True, fix_nodata=False, force_float=False,
           window=None, level=0):
    """GeoTIFF (or PNG via PIL fallback) read with metadata
    (parity: neilpy.py:114-158).  ``window=((r0, r1), (c0, c1))``
    reads a pixel rectangle of a TIFF, decoding only the strips/tiles
    it touches — the metadata's transform/bounds describe the window
    itself.  ``level`` selects a pyramid/overview IFD (works on GDAL
    ``.ovr`` sidecars too — they are bare TIFF pyramids)."""
    if str(fn).lower().endswith((".tif", ".tiff", ".ovr")):
        X, metadata = read_geotiff(fn, window=window, level=level)
    elif window is not None or level != 0:
        raise ValueError("window=/level= are only supported for TIFF "
                         "reads")
    else:
        from PIL import Image
        X = np.asarray(Image.open(fn))
        metadata = {"width": X.shape[1], "height": X.shape[0],
                    "count": 1 if X.ndim == 2 else X.shape[2],
                    "dtype": str(X.dtype), "transform": Affine.identity(),
                    "crs": None, "nodata": None, "cellsize": 1.0,
                    "bounds": (0, 0, X.shape[1], X.shape[0])}
    if force_float and metadata["dtype"] not in ("float32", "float64"):
        X = X.astype(np.float32)
        metadata["dtype"] = "float32"
    if fix_nodata:
        if metadata["dtype"] in ("float32", "float64"):
            if metadata.get("nodata") is not None:
                X = X.copy()
                X[X == metadata["nodata"]] = np.nan
        else:
            print("Warning: fix_nodata requested, but " +
                  str(metadata["dtype"]) + " cannot be converted to np.nan.")
    if return_metadata:
        return X, metadata
    return X


def imwrite(fn, im, metadata=None, colormap=None, overwrite_metadata=True,
            compress="none"):
    """GeoTIFF / image write (parity: neilpy.py:165-190).

    Non-TIFF extensions take the reference's plain-image fallback
    (imageio there, PIL here): georeferencing is NOT embedded — a
    warning says so when metadata was supplied, mirroring the
    reference's print at neilpy.py:189.  ``compress`` passes through to
    :func:`write_geotiff` ('none' | 'deflate' | 'lzw' | 'zstd').  ``im``
    may be a torch tensor on any device; it is copied to the host."""
    im = _host_array(im)
    if not str(fn).lower().endswith((".tif", ".tiff")):
        if metadata is not None:
            import warnings
            warnings.warn("Writing image only; metadata will not be "
                          "written. Use a .tif extension (or "
                          "write_worldfile) to keep georeferencing.")
        if colormap is not None and im.ndim == 2 and im.dtype == np.uint8:
            from .png import write_paletted_png
            write_paletted_png(fn, im, colormap)
            return
        from PIL import Image
        Image.fromarray(im).save(fn)
        return
    if metadata is None:
        write_geotiff(fn, im, colormap=colormap, compress=compress)
        return
    write_geotiff(fn, im, transform=metadata.get("transform"),
                  crs=metadata.get("crs"), nodata=metadata.get("nodata"),
                  colormap=colormap, compress=compress)
