"""The PyTorch port's TIFF codecs (``neilpy_tpu_torch/io/tiff_codec.py``
and their use in ``io/geotiff.py``) held against the JAX package's on
the CPU, bit for bit: every decoded array equals the JAX reader's (and
PIL's where PIL reads the file), every written file equals the JAX
writer's byte for byte, the native LZW / PackBits kernels equal the
Python fallbacks, and an unloadable codec library falls back to them.

The JAX package's codec library is never loaded here (its loader can
run ``make -C native clean``, which would race the other workers): its
``_load`` is patched to None, so the JAX references decode through its
Python fallbacks, which are what the port's native kernels must equal.
"""

import io
import warnings
import zlib

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st
from PIL import Image, TiffImagePlugin

import neilpy_tpu as nt
import neilpy_tpu.io.geotiff as jgt
import neilpy_tpu.io.tiff_codec as jtc
import neilpy_tpu_torch as ntt
import neilpy_tpu_torch.io.geotiff as tgt
import neilpy_tpu_torch.io.tiff_codec as ttc
from neilpy_tpu_torch import _host_build

from .test_io import _build_strip_tiff, _build_tiled_tiff

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_codecs_in_python(monkeypatch):
    monkeypatch.setattr(jtc, "_load", lambda: None)


def _rng(seed):
    return np.random.default_rng(seed)


def _same_read(fn, **kw):
    """The port's and the JAX package's reads of ``fn``: arrays equal
    bit for bit, metadata equal; returns the array."""
    got, meta = ntt.imread(fn, **kw)
    want, meta_j = nt.imread(fn, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for key in ("width", "height", "count", "dtype", "nodata", "crs"):
        assert meta[key] == meta_j[key], key
    return got


def _dem(seed, shape=(70, 53), dtype=np.float32):
    return (_rng(seed).normal(size=shape).cumsum(0) * 10).astype(dtype)


def test_the_native_codec_library_builds():
    assert ttc.codec_native_available()
    assert ttc.zstd_available() == jtc.zstd_available()


# ----------------------------------------------------------------------
# decode: PIL-written and JAX-written files
# ----------------------------------------------------------------------
@pytest.mark.parametrize("comp,mode", [
    (comp, mode) for comp in ("packbits", "tiff_lzw", "tiff_adobe_deflate")
    for mode in ("gray8", "rgb8", "float32")
    if not (comp == "packbits" and mode == "float32")])  # 8-bit only
def test_read_pil_written(tmp_path, comp, mode):
    rng = _rng(1)
    if mode == "gray8":
        a = (rng.random((45, 62)) * 250).astype(np.uint8)
    elif mode == "rgb8":
        a = rng.integers(0, 255, (37, 41, 3)).astype(np.uint8)
    else:
        a = rng.normal(size=(200, 120)).astype(np.float32).cumsum(0)
    fn = str(tmp_path / "pil.tif")
    TiffImagePlugin.STRIP_SIZE = 8192  # several strips: state per strip
    try:
        Image.fromarray(a).save(fn, compression=comp)
    finally:
        TiffImagePlugin.STRIP_SIZE = 65536
    got = _same_read(fn)
    np.testing.assert_array_equal(got, a)


def test_read_pil_zstd(tmp_path):
    a = _rng(2).integers(0, 65535, (91, 133)).astype(np.uint16)
    fn = str(tmp_path / "pz.tif")
    Image.fromarray(a).save(fn, compression="tiff_zstd")
    np.testing.assert_array_equal(_same_read(fn), a)


@pytest.mark.parametrize("case", ["rgb_single_strip", "gray_multi_strip"])
def test_read_pil_jpeg(tmp_path, case):
    """New-style JPEG (compression 7) with the JPEGTables splice: the
    port's decode equals PIL's own decode of the file and the JAX
    reader's."""
    rng = _rng(3)
    fn = str(tmp_path / "j.tif")
    if case == "rgb_single_strip":
        a = rng.integers(0, 255, (96, 120, 3)).astype(np.uint8)
        Image.fromarray(a).save(fn, compression="jpeg", quality=95)
    else:
        a = rng.integers(0, 255, (200, 310)).astype(np.uint8)
        Image.fromarray(a).save(fn, compression="jpeg", quality=90,
                                tiffinfo={278: 64})
    got = _same_read(fn)
    np.testing.assert_array_equal(got, np.asarray(Image.open(fn)))
    src = ntt.GeoTiffSource(fn)
    assert src._jpeg_tables is not None
    np.testing.assert_array_equal(src[7:150, 11:90], got[7:150, 11:90])


def test_read_tiled_jpeg(tmp_path):
    """JPEG tiles without a JPEGTables tag (tests/test_io.py:682's
    fixture): each tile equals PIL's decode of its stream."""
    rng = _rng(4)
    H = W = 64
    TS = 32
    a = (rng.random((H, W)) * 250).astype(np.uint8)
    tiles, decoded = [], []
    for ty in range(H // TS):
        for tx in range(W // TS):
            buf = io.BytesIO()
            Image.fromarray(a[ty*TS:(ty+1)*TS, tx*TS:(tx+1)*TS]).save(
                buf, format="JPEG", quality=92)
            tiles.append(buf.getvalue())
            decoded.append(np.asarray(Image.open(io.BytesIO(tiles[-1]))))
    fn = str(tmp_path / "jtiled.tif")
    with open(fn, "wb") as f:
        f.write(_build_tiled_tiff(a, tiles, TS, comp=7))
    got = _same_read(fn)
    i = 0
    for ty in range(H // TS):
        for tx in range(W // TS):
            np.testing.assert_array_equal(
                got[ty*TS:(ty+1)*TS, tx*TS:(tx+1)*TS], decoded[i])
            i += 1


@pytest.mark.parametrize("comp", [5, 32773, 50000])
def test_read_hand_built_tiles_and_predictor2_strips(tmp_path, comp):
    """Tile-organised files of each codec, and LZW / ZSTD strips under
    the horizontal predictor, built around blocks encoded here."""
    rng = _rng(5)
    enc = {5: ttc.lzw_encode, 50000: ttc.zstd_encode,
           32773: _packbits_encode}[comp]
    H, W, TS = 48, 48, 16
    a = (rng.random((H, W)) * 250).astype(np.uint8)
    a[:, ::5] = 7  # runs, for PackBits' replicate regime
    tiles = [enc(a[ty*TS:(ty+1)*TS, tx*TS:(tx+1)*TS].tobytes())
             for ty in range(H // TS) for tx in range(W // TS)]
    fn = str(tmp_path / "tiled.tif")
    with open(fn, "wb") as f:
        f.write(_build_tiled_tiff(a, tiles, TS, comp=comp))
    np.testing.assert_array_equal(_same_read(fn), a)
    if comp == 32773:
        return
    RPS = 16
    strips = []
    for r0 in range(0, H, RPS):
        block = a[r0:r0 + RPS]
        diff = block.copy()
        diff[:, 1:] = block[:, 1:] - block[:, :-1]  # wraps mod 256
        strips.append(enc(diff.tobytes()))
    fn = str(tmp_path / "pred2.tif")
    with open(fn, "wb") as f:
        f.write(_build_strip_tiff(a, strips, RPS, comp=comp, predictor=2))
    np.testing.assert_array_equal(_same_read(fn), a)


def _packbits_encode(data):
    """PackBits as literal runs of at most 128 bytes and replicate runs
    of 2-128 (TIFF 6.0 section 9)."""
    data = bytes(data)
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while (j + 1 < len(data) and j - i < 127
               and data[j + 1] != data[j]):
            j += 1
        out += bytes([j - i]) + data[i:j + 1]
        i = j + 1
    return bytes(out)


@pytest.mark.parametrize("comp", [5, 8, 50000])
@pytest.mark.parametrize("predictor,dtype,samples", [
    (2, "<u2", 1), (2, "<i4", 3), (2, "<u1", 4), (3, "<f4", 1),
    (3, "<f8", 2)])
def test_decompress_predictors(comp, predictor, dtype, samples):
    """Every codec under the horizontal (2) and floating-point (3)
    predictors, multi-sample: the port's ``_decompress`` equals the JAX
    package's on the same encoded block."""
    rng = _rng(6)
    w, h = 29, 6
    dt = np.dtype(dtype)
    raw = rng.integers(0, 256, h * w * samples * dt.itemsize,
                       dtype=np.uint8).tobytes()
    enc = {5: ttc.lzw_encode, 8: lambda b: zlib.compress(b, 6),
           50000: ttc.zstd_encode}[comp](raw)
    args = (enc, comp, len(raw), predictor, w, dt, samples)
    got = tgt._decompress(*args)
    assert got == jgt._decompress(*args) and len(got) == len(raw)


@pytest.mark.parametrize("compress", ["lzw", "zstd", "deflate"])
def test_windows_of_compressed_files(tmp_path, compress):
    """Multi-band, tiled and stripped, with overviews: full reads, the
    pyramid level and windows through ``imread`` and ``GeoTiffSource``
    equal the JAX package's."""
    rng = _rng(7)
    a = rng.integers(0, 60000, (130, 97, 3)).astype(np.uint16)
    Z = _dem(8, (130, 97))
    for i, (im, tiled) in enumerate(((a, True), (Z, False), (Z, True))):
        fn = str(tmp_path / f"w{i}.tif")
        nt.write_geotiff(fn, im, compress=compress, tiled=tiled,
                         tile_size=32, overviews=(2,))
        np.testing.assert_array_equal(_same_read(fn), im)
        _same_read(fn, level=1)
        for win in (((3, 77), (5, 60)), ((0, 130), (90, 97))):
            _same_read(fn, window=win)
        src, src_j = ntt.GeoTiffSource(fn), nt.GeoTiffSource(fn)
        np.testing.assert_array_equal(src[17:101, 9:88], src_j[17:101, 9:88])


# ----------------------------------------------------------------------
# write: bytes equal to the JAX writer's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compress", ["none", "deflate", "lzw", "zstd"])
@pytest.mark.parametrize("tiled", [False, True])
def test_writer_bytes_equal_the_jax_writer(tmp_path, compress, tiled):
    rng = _rng(9)
    cases = [
        (_dem(10, (70, 53)), {}),
        (_dem(11, (64, 64)).astype(np.float64), {"nodata": -9999.0}),
        (rng.integers(1, 11, (41, 77)).astype(np.uint8),
         {"colormap": nt.geomorphon_cmap()}),
        (rng.integers(-3000, 3000, (33, 90)).astype(np.int16),
         {"overviews": (2, 4)}),
        (rng.integers(0, 255, (40, 50, 3)).astype(np.uint8), {}),
    ]
    t = nt.from_origin(500000.0, 4200000.0, 2.0, 2.0)
    for i, (im, kw) in enumerate(cases):
        kw = dict(kw, compress=compress, tiled=tiled, tile_size=32)
        if im.ndim == 2:
            kw.update(transform=t, crs=32633)
        a, b = tmp_path / f"t{i}.tif", tmp_path / f"j{i}.tif"
        ntt.write_geotiff(str(a), torch.from_numpy(im), **kw)
        nt.write_geotiff(str(b), im, **kw)
        assert a.read_bytes() == b.read_bytes(), (i, kw)
        np.testing.assert_array_equal(ntt.imread(str(a))[0], im)
    meta = {"transform": t, "crs": 32633, "nodata": None}
    a, b = tmp_path / "ti.tif", tmp_path / "ji.tif"
    ntt.imwrite(str(a), cases[0][0], meta, compress=compress)
    nt.imwrite(str(b), cases[0][0], meta, compress=compress)
    assert a.read_bytes() == b.read_bytes()


# ----------------------------------------------------------------------
# the native kernels against the Python fallbacks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["random", "runs", "text", "boundary"])
def test_lzw_native_python_and_jax_agree(kind):
    rng = _rng(12)
    if kind == "random":
        # incompressible: crosses every width bump and the 12-bit Clear
        data = rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()
    elif kind == "runs":
        data = np.repeat(rng.integers(0, 256, 4000, dtype=np.uint8),
                         rng.integers(1, 30, 4000)).tobytes()
    elif kind == "text":
        data = b"to be or not to be, that is the question " * 500
    else:  # tests/test_io.py's EOI-at-a-width-boundary seed
        r = np.random.default_rng(742)
        data = r.integers(0, 256, int(r.integers(500, 1100))).astype(
            np.uint8).tobytes()
    enc = ttc.lzw_encode(data)
    assert enc == jtc.lzw_encode(data)
    assert ttc._native_call("lzw_decode", enc, len(data)) == data
    assert ttc._lzw_decode_py(enc, len(data)) == data
    assert ttc.lzw_decode(enc, len(data)) == jtc.lzw_decode(enc, len(data))
    # trailing garbage after a full output is tolerated by both
    assert ttc.lzw_decode(enc + b"\x55\xaa", len(data)) == data


def test_packbits_native_python_and_jax_agree():
    rng = _rng(13)
    chunks, expect = [], []
    for _ in range(300):
        if rng.random() < 0.5:
            n = int(rng.integers(1, 120))
            lit = rng.integers(0, 256, n, dtype=np.uint8)
            chunks.append(bytes([n - 1]) + lit.tobytes())
            expect.append(lit.tobytes())
        else:
            n = int(rng.integers(2, 120))
            v = int(rng.integers(0, 256))
            chunks.append(bytes([257 - n, v]))
            expect.append(bytes([v]) * n)
        if rng.random() < 0.05:
            chunks.append(bytes([128]))  # the no-op control byte
    raw, want = b"".join(chunks), b"".join(expect)
    assert ttc._native_call("packbits_decode", raw, len(want)) == want
    assert ttc._packbits_decode_py(raw, len(want)) == want
    assert jtc.packbits_decode(raw, len(want)) == want
    # a short output buffer truncates in all three
    k = len(want) // 3
    assert (ttc.packbits_decode(raw, k) == ttc._packbits_decode_py(raw, k)
            == jtc.packbits_decode(raw, k) == want[:k])


def test_malformed_streams_raise():
    with pytest.raises(ValueError, match="malformed"):
        ttc.lzw_decode(b"\xff\xff\xff\xff", 100)
    with pytest.raises(ValueError, match="malformed"):
        ttc._lzw_decode_py(b"\xff\xff\xff\xff", 100)
    with pytest.raises(ValueError, match="ZSTD"):
        ttc.zstd_decode(b"not a zstd frame", 10)


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.binary(min_size=0, max_size=3000), st.integers(0, 2 ** 31))
def test_codec_roundtrip_property(payload, seed):
    """Any payload: LZW round-trips through the native and the Python
    decoder, equal to the JAX encoder's stream; ZSTD round-trips; a
    PackBits encoding decodes identically native and in Python."""
    enc = ttc.lzw_encode(payload)
    assert enc == jtc.lzw_encode(payload)
    n = len(payload)
    assert ttc.lzw_decode(enc, n) == ttc._lzw_decode_py(enc, n) == payload
    assert ttc.zstd_decode(ttc.zstd_encode(payload), n) == payload
    runs = np.repeat(np.frombuffer(payload, np.uint8),
                     np.random.default_rng(seed).integers(1, 4, n)).tobytes()
    pb = _packbits_encode(runs)
    m = len(runs)
    assert (ttc.packbits_decode(pb, m) == ttc._packbits_decode_py(pb, m)
            == runs)


# ----------------------------------------------------------------------
# an unloadable codec library
# ----------------------------------------------------------------------
def test_unloadable_codec_library_falls_back(tmp_path, monkeypatch):
    """A library that will not load is reported once with a warning and
    the Python decoders stand in: the same arrays come out."""
    bad = tmp_path / "libtiffcodec_bad.so"
    bad.write_bytes(b"not an ELF file")
    monkeypatch.setattr(_host_build, "_LOADED", {})
    monkeypatch.setattr(_host_build, "build", lambda name: bad)
    Z = _dem(14, (60, 45))
    a = (_rng(15).random((45, 62)) * 250).astype(np.uint8)
    fn, fn2 = str(tmp_path / "l.tif"), str(tmp_path / "p.tif")
    nt.write_geotiff(fn, Z, compress="lzw", tiled=True, tile_size=16)
    Image.fromarray(a).save(fn2, compression="packbits")
    with pytest.warns(RuntimeWarning, match="tiffcodec"):
        assert not ttc.codec_native_available()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # reported once, not per call
        np.testing.assert_array_equal(ntt.imread(fn)[0], Z)
        np.testing.assert_array_equal(ntt.imread(fn2)[0], a)
        assert ttc._native_call("lzw_decode", b"", 0) is None
