"""TIFF codecs for the GeoTIFF reader and writer.

PyTorch package's copy of ``neilpy_tpu/io/tiff_codec.py``, with the
same names and results.  LZW and PackBits decode in the native C++
kernels of ``native/tiffcodec.cpp`` (built at first use by
``_host_build``); the pure Python/numpy decoders below stand in when the
library cannot be built, as in the JAX package.  PackBits is decoded
with a run-table + ``np.repeat`` scheme (one cheap Python iteration per
control byte, all byte movement in numpy), LZW with a bytes-table
decoder.  ``lzw_encode`` is pure Python (a few MB/s), JPEG decodes
through PIL, and ZSTD (TIFF compression 50000) binds libzstd with
ctypes.

Parity target: the reference's ``imread`` reads whatever rasterio/GDAL
reads (reference neilpy/neilpy.py:114-158) — LZW being the single most
common compressed-DEM flavour in the wild.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _host_build

__all__ = ["lzw_decode", "lzw_encode", "packbits_decode",
           "jpeg_decode", "zstd_decode", "zstd_encode",
           "zstd_available", "codec_native_available"]


def _declare(lib):
    for sym in ("lzw_decode", "packbits_decode"):
        fn = getattr(lib, sym)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                       ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]


def _load():
    return _host_build.load("tiffcodec", _declare)


def codec_native_available():
    return _load() is not None


def _native_call(sym, raw, expected):
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(raw, dtype=np.uint8)
    dst = np.empty(expected, dtype=np.uint8)
    n = getattr(lib, sym)(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), expected)
    if n < 0:
        raise ValueError(f"malformed {sym.split('_')[0]} stream")
    return dst[:n].tobytes()


# ----------------------------------------------------------------------
# PackBits
# ----------------------------------------------------------------------
def _packbits_decode_py(raw, expected):
    """Numpy-vectorised PackBits: a light Python pass over control bytes
    builds literal-gather and replicate-repeat index tables; all byte
    movement happens in two numpy ops."""
    src = np.frombuffer(raw, dtype=np.uint8)
    n_src = src.size
    # (is_literal, src_start, count, dst_start) per run
    lit_src, lit_cnt, lit_dst = [], [], []
    rep_src, rep_cnt, rep_dst = [], [], []
    i = 0
    out_len = 0
    while i < n_src and out_len < expected:
        n = int(src[i])
        i += 1
        if n < 128:
            cnt = min(n + 1, n_src - i, expected - out_len)
            lit_src.append(i)
            lit_cnt.append(cnt)
            lit_dst.append(out_len)
            i += n + 1
            out_len += cnt
        elif n > 128:
            if i >= n_src:
                break
            cnt = min(257 - n, expected - out_len)
            rep_src.append(i)
            rep_cnt.append(cnt)
            rep_dst.append(out_len)
            i += 1
            out_len += cnt
        # n == 128: no-op
    out = np.zeros(out_len, dtype=np.uint8)
    if lit_src:
        cnt = np.asarray(lit_cnt)
        # gather indices: src_start[k] + 0..cnt[k]-1  ->  dst ranges
        s = np.repeat(np.asarray(lit_src), cnt)
        ar = np.arange(int(cnt.sum()))
        off = ar - np.repeat(np.cumsum(cnt) - cnt, cnt)
        d = np.repeat(np.asarray(lit_dst), cnt) + off
        out[d] = src[s + off]
    if rep_src:
        cnt = np.asarray(rep_cnt)
        vals = np.repeat(src[np.asarray(rep_src)], cnt)
        ar = np.arange(int(cnt.sum()))
        off = ar - np.repeat(np.cumsum(cnt) - cnt, cnt)
        d = np.repeat(np.asarray(rep_dst), cnt) + off
        out[d] = vals
    return out.tobytes()


def packbits_decode(raw, expected):
    """PackBits (TIFF 6.0 §9) decode to exactly <= ``expected`` bytes."""
    raw = bytes(raw)
    out = _native_call("packbits_decode", raw, expected)
    if out is None:
        out = _packbits_decode_py(raw, expected)
    return out


# ----------------------------------------------------------------------
# LZW
# ----------------------------------------------------------------------
def _lzw_decode_py(raw, expected):
    """TIFF-flavour LZW (TIFF 6.0 §13): MSB-first codes, Clear=256,
    EOI=257, 9->12 bit widths with the TIFF early-change convention.
    The bit buffer keeps only its unread bits, so the decode is linear
    in the stream's length."""
    src = bytes(raw)
    n_src = len(src)
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(base)
    width = 9
    bitbuf = 0
    bits = 0
    si = 0
    prev = None
    chunks = []
    out_len = 0
    while out_len < expected:
        while bits < width:
            if si >= n_src:
                return b"".join(chunks)[:expected]
            bitbuf = (bitbuf << 8) | src[si]
            si += 1
            bits += 8
        bits -= width
        code = (bitbuf >> bits) & ((1 << width) - 1)
        bitbuf &= (1 << bits) - 1
        if code == 257:  # EOI
            break
        if code == 256:  # Clear
            table = list(base)
            width = 9
            prev = None
            continue
        if prev is None:
            if code >= 256:
                raise ValueError("malformed LZW stream")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("malformed LZW stream")
        chunks.append(entry)
        out_len += len(entry)
        prev = entry
        if len(table) == (1 << width) - 1 and width < 12:
            width += 1
    return b"".join(chunks)[:expected]


def lzw_decode(raw, expected):
    """TIFF LZW decode to at most ``expected`` bytes."""
    raw = bytes(raw)
    out = _native_call("lzw_decode", raw, expected)
    if out is None:
        out = _lzw_decode_py(raw, expected)
    return out


class _BitWriter:
    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, code, width):
        self._acc = (self._acc << width) | code
        self._nbits += width
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1  # keep the unwritten bits only

    def getvalue(self):
        if self._nbits:
            return bytes(self._buf) + bytes(
                [(self._acc << (8 - self._nbits)) & 0xFF])
        return bytes(self._buf)


def lzw_encode(data):
    """TIFF-flavour LZW encoder (write-path / fixture counterpart of
    ``lzw_decode``; same early-change + Clear/EOI conventions)."""
    data = bytes(data)
    CLEAR, EOI = 256, 257
    out = _BitWriter()

    def fresh():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, width = fresh()
    out.write(CLEAR, width)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        out.write(table[w], width)
        table[wc] = nxt
        nxt += 1
        # the decoder's table lags the encoder's by one entry, so the
        # encoder bumps at 1<<width where the decoder bumps at
        # (1<<width)-1 — cross-checked against PIL's libtiff decoder
        if nxt == (1 << width):
            if width < 12:
                width += 1
            else:
                out.write(CLEAR, width)
                table, nxt, width = fresh()
        w = bytes([ch])
    if w:
        out.write(table[w], width)
        # the decoder registers one more entry for this final code and
        # applies the early-change bump BEFORE reading the next code,
        # so when the count lands exactly on a width boundary the EOI
        # must be written at the wider width (caught by a decoder that
        # reads through to EOI; fuzzed against both of our decoders
        # and PIL in tests)
        if nxt == (1 << width) - 1 and width < 12:
            width += 1
    out.write(EOI, width)
    return out.getvalue()


# ----------------------------------------------------------------------
# ZSTD (TIFF compression 50000 — the GDAL/COG extension code)
#
# The runtime image ships no python zstandard module, but libzstd is a
# base-system library; bind the one-shot simple API directly.  Strips
# and tiles are independent frames, so ZSTD_decompress covers the TIFF
# case completely (no streaming state spans blocks).

_ZSTD = None
_ZSTD_FAILED = False


def _load_zstd():
    global _ZSTD, _ZSTD_FAILED
    if _ZSTD is not None or _ZSTD_FAILED:
        return _ZSTD
    import ctypes.util
    name = ctypes.util.find_library("zstd")
    try:
        lib = ctypes.CDLL(name or "libzstd.so.1")
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                      ctypes.c_void_p, ctypes.c_size_t,
                                      ctypes.c_int]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    except (OSError, AttributeError):
        _ZSTD_FAILED = True
        return None
    _ZSTD = lib
    return _ZSTD


def zstd_available():
    """True when libzstd is loadable (it is a base library on linux)."""
    return _load_zstd() is not None


def zstd_decode(raw, expected):
    """Decompress one ZSTD frame (a TIFF strip/tile) to ``expected`` bytes."""
    lib = _load_zstd()
    if lib is None:
        raise ValueError(
            "ZSTD-compressed TIFF but libzstd is not available on this "
            "system — re-save the file with LZW/deflate or install zstd")
    src = np.frombuffer(raw, dtype=np.uint8)
    dst = np.empty(expected, dtype=np.uint8)
    n = lib.ZSTD_decompress(dst.ctypes.data, dst.size,
                            src.ctypes.data, src.size)
    if lib.ZSTD_isError(n):
        raise ValueError("malformed ZSTD stream in TIFF strip/tile")
    return dst[:n].tobytes()


def zstd_encode(data, level=9):
    """Compress one strip/tile as a single ZSTD frame (GDAL default level 9)."""
    lib = _load_zstd()
    if lib is None:
        raise ValueError("libzstd not available — cannot write ZSTD TIFFs")
    src = np.frombuffer(data, dtype=np.uint8)
    bound = lib.ZSTD_compressBound(src.size)
    dst = np.empty(bound, dtype=np.uint8)
    n = lib.ZSTD_compress(dst.ctypes.data, dst.size,
                          src.ctypes.data, src.size, level)
    if lib.ZSTD_isError(n):
        raise ValueError("ZSTD compression failed")
    return dst[:n].tobytes()


def jpeg_decode(stream, tables=None):
    """Decode one new-style-JPEG (TIFF compression 7) strip/tile.

    ``tables`` is the IFD's JPEGTables payload (tag 347): an
    abbreviated JPEG stream (SOI .. tables .. EOI) holding the shared
    quantisation/Huffman tables.  Per TIFF TechNote 2 the segment data
    between the tables' SOI and EOI is spliced after the strip's SOI;
    a strip that carries its own tables (no tag 347) decodes as-is.
    PIL is the entropy decoder; YCbCr photometric streams come back
    converted to RGB (libjpeg's default), grayscale stays single-band.
    """
    from io import BytesIO
    from PIL import Image

    stream = bytes(stream)
    if tables:
        # TechNote 2 permits pad bytes before SOI and after EOI in the
        # tables stream: locate the markers instead of assuming exact
        # prefix/suffix positions
        t = bytes(tables)
        soi = t.find(b"\xff\xd8")
        if soi >= 0:
            body = t[soi + 2:]
            eoi = body.rfind(b"\xff\xd9")
            if eoi >= 0:
                body = body[:eoi]
            s_soi = stream.find(b"\xff\xd8")
            if s_soi >= 0:
                stream = (b"\xff\xd8" + body
                          + stream[s_soi + 2:])
    arr = np.asarray(Image.open(BytesIO(stream)))
    return arr.tobytes()
