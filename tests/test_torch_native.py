"""The PyTorch port's native host libraries held against the JAX package
and plain numpy on the CPU, bit for bit unless noted: the LAS decoder
(``io/las_native.py``) against both packages' ``read_las``, the binning
kernel (``ops/binning_native.py``) against numpy and the float64
formula it computes, the streamed ``create_dem_from_las`` and
``smrf_las`` against their one-shot and in-memory forms, and the host
build (``_host_build.py``), which writes only under ``build/``.

The JAX package's native libraries are never loaded here (their loader
can run ``make -C native clean``, which would race the other workers):
its three ``_load`` functions are patched to None, so the JAX references
are its numpy branches, and a reference that needs its native semantics
is built from functions that need no build (``create_dem`` on the
decoded points with ``edges`` from the header).
"""

import subprocess

import numpy as np
import pytest
import torch

import neilpy_tpu as nt
import neilpy_tpu.io.las_native as jln
import neilpy_tpu.io.tiff_codec as jtc
import neilpy_tpu.ops.binning_native as jbn
import neilpy_tpu_torch as ntt
import neilpy_tpu_torch.io.las as tlas
import neilpy_tpu_torch.io.las_native as tln
import neilpy_tpu_torch.ops.binning_native as tbn
import neilpy_tpu_torch.ops.pointgrid as tpg
from neilpy_tpu.ops import pointgrid as jpg
from neilpy_tpu_torch import _host_build

from .test_io import _write_synthetic_las

torch.set_num_threads(1)
CPU = "cpu"
FIELDS = ("x", "y", "z", "intensity", "class", "return_number",
          "return_max")


@pytest.fixture(autouse=True)
def _jax_natives_off(monkeypatch):
    for mod in (jln, jbn, jtc):
        monkeypatch.setattr(mod, "_load", lambda: None)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_grid(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)  # NaN where NaN


def _cloud_file(tmp_path, n=20000, seed=5, pdrf=0, name="cloud.las"):
    """A LAS file whose header min/max block is its decoded points'
    extent (coordinates on the 1 mm lattice, so ``write_las``'s header,
    taken from the inputs, is truthful)."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(500000, 500300, n), 3)
    y = np.round(rng.uniform(4200000, 4200250, n), 3)
    z = np.round(100 + 0.05 * (x - 500000) + rng.normal(0, 2, n), 3)
    cls = rng.integers(1, 7, n).astype(np.uint8)
    fn = str(tmp_path / name)
    ntt.write_las(fn, x, y, z, classification=cls, pdrf=pdrf)
    return fn


def _header_edges(hdr, cellsize, bbox=None):
    """``edges`` of the frame the header's min/max block (MaxX, MinX,
    MaxY, MinY) spans, intersected with ``bbox``, as ``_grid_frame``
    snaps a point extent."""
    xmax, xmin, ymax, ymin = hdr["minmax"][:4]
    if bbox is not None:
        xmin, xmax = max(xmin, bbox[0]), min(xmax, bbox[1])
        ymin, ymax = max(ymin, bbox[2]), min(ymax, bbox[3])
    cs = float(cellsize)
    xe = np.arange(cs * np.floor(xmin / cs) - .5 * cs,
                   cs * np.ceil(xmax / cs) + 1.5 * cs, cs)
    ye = np.arange(cs * np.ceil(ymax / cs) + .5 * cs,
                   cs * np.floor(ymin / cs) - 1.5 * cs, -cs)
    return xe, ye


# ----------------------------------------------------------------------
# the host build
# ----------------------------------------------------------------------
def test_host_build_writes_only_under_build(tmp_path, monkeypatch):
    """A fresh build of the three libraries runs g++ only (never
    ``make``), each output under the build directory, keyed by source,
    flags and CPU signature; nothing under ``neilpy_tpu/`` or
    ``native/`` changes."""
    repo = _host_build._PKG_DIR.parent

    def tree(root):
        return {p: p.stat().st_mtime_ns for p in root.rglob("*")
                if p.is_file() and "__pycache__" not in p.parts
                and "_native" not in p.parts}

    before = {**tree(repo / "neilpy_tpu"), **tree(repo / "native")}
    calls = []
    real_run = subprocess.run

    def run(cmd, *a, **kw):
        calls.append(list(cmd))
        return real_run(cmd, *a, **kw)

    out = tmp_path / "host"
    monkeypatch.setattr(_host_build, "BUILD_DIR", out)
    monkeypatch.setattr(_host_build, "_LOADED", {})
    monkeypatch.setattr(_host_build.subprocess, "run", run)
    libs = [_host_build.build(name) for name in _host_build.NAMES]
    assert all(p.parent == out and p.is_file() for p in libs)
    assert sorted(p.name for p in out.glob("*.so")) == sorted(
        p.name for p in libs)
    assert _host_build.build("binning") == libs[2]  # reused, not rebuilt
    assert calls and all("make" not in c[0] for c in calls)
    for c in calls:
        if "-o" in c:
            assert c[c.index("-o") + 1].startswith(str(out))
    assert {**tree(repo / "neilpy_tpu"), **tree(repo / "native")} == before
    sig = _host_build.cpu_signature()
    assert len(sig) == 2 and len(sig[1]) == 32
    assert tbn.native_available() and tln.native_available()


def test_unbuildable_library_warns_once_and_falls_back(monkeypatch):
    """No compiler: each library is reported once and the callers fall
    back where the JAX package does (numpy binning, the read_las
    branch), or refuse where it refuses."""
    monkeypatch.setattr(_host_build, "_LOADED", {})
    monkeypatch.setattr(_host_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.warns(RuntimeWarning, match="g\\+\\+ not found"):
        assert not tbn.native_available()
    assert tbn.origin_shift_native(np.zeros(3), np.zeros(3), 0, 0) is None
    with pytest.raises(RuntimeError, match="libbinning"):
        ntt.bin_points(np.arange(3.0), np.arange(3.0), native=True)
    x = np.random.default_rng(1).uniform(0, 50, 500)
    for a, b in zip(ntt.bin_points(x, x[::-1]),
                    jpg.bin_points(x, x[::-1], native=False)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
    with pytest.warns(RuntimeWarning, match="las_decoder"):
        assert not tln.native_available()
    with pytest.raises(RuntimeError, match="read_las"):
        tln.read_las_arrays("any.las")


# ----------------------------------------------------------------------
# the LAS decoder
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pdrf", [0, 3, 6, 7, 8, 9, 10])
def test_read_las_arrays_equals_read_las(tmp_path, pdrf):
    fn = str(tmp_path / f"p{pdrf}.las")
    _write_synthetic_las(fn, pdrf=pdrf, n=5000, seed=pdrf)
    out = tln.read_las_arrays(fn)
    hdr, df = ntt.read_las(fn)
    hdr_j, df_j = nt.read_las(fn)
    for key in FIELDS:
        col = np.asarray(df[key])
        assert out[key].dtype == col.dtype or key in "xyz", key
        np.testing.assert_array_equal(out[key], col, err_msg=key)
        np.testing.assert_array_equal(col, np.asarray(df_j[key]))
    h = tln.read_header(fn)
    for key in ("num_point_records", "point_data_offset",
                "point_data_record_length", "point_data_format_id"):
        assert h[key] == hdr[key] == hdr_j[key], key
    assert h["scale"] == tuple(hdr["scale"])


def test_bbox_stride_and_chunks(tmp_path):
    fn = _cloud_file(tmp_path, n=20000, pdrf=3)
    _, df = nt.read_las(fn)
    bbox = (500050.0, 500200.0, 4200060.0, 4200180.0)
    for stride in (1, 7):
        sub = df.iloc[::stride]
        keep = ((sub.x >= bbox[0]) & (sub.x <= bbox[1])
                & (sub.y >= bbox[2]) & (sub.y <= bbox[3]))
        got = tln.read_las_arrays(fn, stride=stride, bbox=bbox, n_threads=3)
        for key in FIELDS:
            np.testing.assert_array_equal(got[key],
                                          np.asarray(sub[keep][key]))
        for chunk in (4096, 7001, 5):
            parts = list(tln.read_las_chunks(fn, chunk_points=chunk,
                                             stride=stride, bbox=bbox))
            assert len(parts) == -(-20000 // max(stride, chunk // stride
                                                 * stride))
            for key in FIELDS:
                np.testing.assert_array_equal(
                    np.concatenate([p[key] for p in parts]), got[key])
    with pytest.raises(ValueError, match="chunk_points"):
        next(tln.read_las_chunks(fn, chunk_points=0))


def test_laz_and_garbage_refused(tmp_path):
    fn = str(tmp_path / "t.las")
    _write_synthetic_las(fn, pdrf=3)
    data = bytearray(open(fn, "rb").read())
    data[104] = 131
    open(fn, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="LAZ"):
        tln.read_header(fn)
    with pytest.raises(ValueError, match="LAZ"):
        tln.read_las_arrays(fn)
    bad = tmp_path / "bad.las"
    bad.write_bytes(b"not a las file" * 20)
    with pytest.raises(ValueError, match="code"):
        tln.read_header(str(bad))


# ----------------------------------------------------------------------
# binning
# ----------------------------------------------------------------------
def _f64_bins(x, y, t, ny, nx):
    """``binning.cpp``'s arithmetic: floor((x - x0) * (1 / cs)) and
    floor((y0 - y) * (1 / cs)), out-of-grid points clipped and invalid."""
    inv = 1.0 / t.a
    c = np.floor((x - t.c) * inv)
    r = np.floor((t.f - y) * inv)
    ok = (c >= 0) & (c < nx) & (r >= 0) & (r < ny)
    flat = (np.clip(r, 0, ny - 1).astype(np.int64) * nx
            + np.clip(c, 0, nx - 1).astype(np.int64))
    return flat, ok


def test_bin_points_native_numpy_and_formula():
    """cellsize 0.3, with points placed exactly on cell edges: the native
    bins equal the f64 formula everywhere and numpy (the JAX package's
    ``native=False`` too) everywhere but on an edge hit; edges given or
    derived."""
    rng = np.random.default_rng(7)
    cs = 0.3
    x = rng.uniform(500000, 500060, 6000)
    y = rng.uniform(4200000, 4200045, 6000)
    _, _, t, _, _ = tpg._grid_frame(x, y, cs)
    k = rng.integers(2, 150, 2000)
    x[:2000] = t.c + k * cs          # on (or an ulp beside) an x edge
    y[2000:4000] = t.f - k * cs
    for edges in (None, (t.c + cs * np.arange(220),
                         t.f - cs * np.arange(170))):
        fn, vn, (ny, nx), tn = ntt.bin_points(x, y, cs, edges)
        assert fn.dtype == np.int32
        f0, v0, shape0, t0 = ntt.bin_points(x, y, cs, edges, native=False)
        fj, vj, shapej, tj = jpg.bin_points(x, y, cs, edges, native=False)
        np.testing.assert_array_equal(f0, fj)
        np.testing.assert_array_equal(v0, vj)
        assert shape0 == shapej == (ny, nx)
        assert tuple(t0) == tuple(tj) == tuple(tn)
        flat, ok = _f64_bins(x, y, tn, ny, nx)
        np.testing.assert_array_equal(fn, flat)
        np.testing.assert_array_equal(vn, ok)
        differ = (fn != f0) | (vn != v0)
        assert not differ[4000:].any()  # off the edges: identical
        np.testing.assert_array_equal(
            ntt.bin_points(x, y, cs, edges, native=True)[0], fn)


def test_bin_points_int32_limit():
    x = np.array([0.0, 60000.0])
    with pytest.raises(ValueError, match="int32"):
        tbn.bin_points_native(x, x, 1)
    with pytest.raises(ValueError, match="int32"):
        ntt.bin_points(x, x, 1, native=True)
    flat, valid, shape, _ = ntt.bin_points(x, x, 1)  # auto: numpy
    assert flat.dtype == np.int64 and shape[0] * shape[1] >= 2 ** 31
    np.testing.assert_array_equal(
        flat, jpg.bin_points(x, x, 1, native=False)[0])


def test_origin_shift_native_bit_for_bit():
    rng = np.random.default_rng(8)
    x = rng.uniform(5e5, 5e5 + 3000, 250_001)  # > 100k: threaded
    y = rng.uniform(4.2e6, 4.2e6 + 3000, 250_001)
    xr, yr = tbn.origin_shift_native(x, y, 499999.5, 4203001.5)
    np.testing.assert_array_equal(xr, (x - 499999.5).astype(np.float32))
    np.testing.assert_array_equal(yr, (4203001.5 - y).astype(np.float32))
    xr2, yr2, shape, t = tpg.bin_points_device(x, y, 0.5)
    jx, jy, jshape, jt = jpg.bin_points_device(x, y, 0.5)
    np.testing.assert_array_equal(xr2, jx)
    np.testing.assert_array_equal(yr2, jy)
    assert shape == jshape and tuple(t) == tuple(jt)


def test_create_dem_chunks_take_the_native_shift():
    rng = np.random.default_rng(9)
    x = rng.uniform(5e5, 5e5 + 200, 30000)
    y = rng.uniform(4.2e6, 4.2e6 + 150, 30000)
    z = rng.normal(300, 10, 30000)
    a, ta = ntt.create_dem(x, y, z, device_bin=True, chunks=7, device=CPU)
    b, tb = nt.create_dem(x, y, z, device_bin=True, chunks=7)
    assert tuple(ta) == tuple(tb)
    _same_grid(a, b)


# ----------------------------------------------------------------------
# create_dem_from_las, streamed
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, {"bin_type": "min", "stride": 3},
                                {"classes": (2, 5)}])
def test_create_dem_from_las_streamed(tmp_path, kw):
    """Streamed (chunks of 997 records) equals one-shot bit for bit, and
    both equal the JAX ``create_dem`` on the decoded, filtered points
    in the header's frame, and the JAX ``read_las`` branch (whose
    point frame is the header's here: ``write_las`` wrote it)."""
    fn = _cloud_file(tmp_path)
    got, t = ntt.create_dem_from_las(fn, cellsize=2, chunk_points=997,
                                     device=CPU, **kw)
    one, t1 = ntt.create_dem_from_las(fn, cellsize=2, device=CPU, **kw)
    assert tuple(t) == tuple(t1)
    _same_grid(got, one)
    d = tln.read_las_arrays(fn, stride=kw.get("stride", 1))
    keep = (np.isin(d["class"], kw["classes"]) if "classes" in kw
            else np.ones(d["x"].size, bool))
    want, tj = nt.create_dem(d["x"][keep], d["y"][keep], d["z"][keep],
                             cellsize=2, bin_type=kw.get("bin_type", "max"),
                             edges=_header_edges(tln.read_header(fn), 2),
                             device_bin=True)
    assert tuple(t) == tuple(tj)
    _same_grid(got, want)
    want2, tj2 = nt.create_dem_from_las(fn, cellsize=2, **kw)
    assert tuple(t) == tuple(tj2)
    _same_grid(got, want2)


def test_create_dem_from_las_bbox_intersects_the_header(tmp_path):
    """With ``bbox`` the frame is the header extent (MaxX, MinX, MaxY,
    MinY) intersected with the bbox: the JAX ``create_dem`` on the
    decoded bbox points with those edges.  The JAX native branch reads
    the block as (xmin, xmax, ymin, ymax) and so intersects swapped
    values (neilpy_tpu/ops/pointgrid.py:387-394): max(MaxX, b0) and
    min(MinX, b1) give back the whole file's frame, which the port does
    not copy."""
    fn = _cloud_file(tmp_path)
    bbox = (500050.0, 500200.0, 4200060.0, 4200180.0)
    got, t = ntt.create_dem_from_las(fn, cellsize=1, bbox=bbox,
                                     chunk_points=3001, device=CPU)
    d = tln.read_las_arrays(fn, bbox=bbox)
    hdr = tln.read_header(fn)
    want, tj = nt.create_dem(d["x"], d["y"], d["z"], cellsize=1,
                             edges=_header_edges(hdr, 1, bbox),
                             device_bin=True)
    assert tuple(t) == tuple(tj) and got.shape == (121, 151)
    _same_grid(got, want)
    m = hdr["minmax"]  # the JAX native branch's frame, as its code has it
    jny, jnx, jt, _, _ = jpg._grid_frame(
        np.array([max(m[0], bbox[0]), min(m[1], bbox[1])]),
        np.array([max(m[2], bbox[2]), min(m[3], bbox[3])]), 1)
    whole, tw = ntt.create_dem_from_las(fn, cellsize=1, device=CPU)
    assert (jny, jnx) == whole.shape and tuple(jt) == tuple(tw)
    assert tuple(jt) != tuple(t)
    assert int(torch.isfinite(got).sum()) > 4000
    with pytest.raises(ValueError, match="overlap"):
        ntt.create_dem_from_las(fn, bbox=(0, 1, 0, 1), device=CPU)


def test_create_dem_from_las_takes_the_header_frame(tmp_path):
    """A header min/max block wider than its points: the native branch
    grids in the header's frame, as the JAX native branch does, where the
    ``read_las`` fallback grids in the points' own frame."""
    fn = _cloud_file(tmp_path, n=5000)
    data = bytearray(open(fn, "rb").read())
    m = np.frombuffer(bytes(data[179:227]), "<f8").copy()
    m[:4] += (11.0, -7.0, 5.0, -9.0)  # MaxX, MinX, MaxY, MinY
    data[179:227] = m.tobytes()
    open(fn, "wb").write(bytes(data))
    got, t = ntt.create_dem_from_las(fn, cellsize=2, device=CPU)
    d = tln.read_las_arrays(fn)
    want, tj = nt.create_dem(d["x"], d["y"], d["z"], cellsize=2,
                             edges=_header_edges(tln.read_header(fn), 2),
                             device_bin=True)
    assert tuple(t) == tuple(tj)
    _same_grid(got, want)
    fall, tf = nt.create_dem_from_las(fn, cellsize=2)  # read_las branch
    assert tuple(tf) != tuple(t) and fall.shape[0] < got.shape[0]
    assert fall.shape[1] < got.shape[1]


def test_smrf_las_streams_both_passes(tmp_path, monkeypatch):
    """``smrf_las`` with ``chunk_points=2500`` reads the file only
    through the decoder's chunks (both passes), never whole, and its
    classes equal the in-memory ``smrf`` on the decoded points; the
    ``read_las`` fallback writes the same file."""
    rng = np.random.default_rng(11)
    n = 9000
    x = np.round(rng.uniform(500000, 500090, n), 3)
    y = np.round(rng.uniform(4200000, 4200070, n), 3)
    z = np.round(100 + 0.1 * (x - 500000) + rng.normal(0, .05, n), 3)
    box = (np.abs(x - 500040) < 8) & (np.abs(y - 4200030) < 6)
    z[box] += 6.0
    fn, out = str(tmp_path / "in.las"), str(tmp_path / "out.las")
    ntt.write_las(fn, x, y, z)
    calls = []
    real = tln.read_las_chunks

    def counted(*a, **kw):
        for chunk in real(*a, **kw):
            calls.append(chunk["x"].size)
            yield chunk

    def no_whole_read(*a, **kw):
        raise AssertionError("smrf_las read the whole file")

    monkeypatch.setattr(tln, "read_las_chunks", counted)
    monkeypatch.setattr(tlas, "read_las", no_whole_read)
    kw = dict(cellsize=1, windows=5, device=CPU)
    _, t, _, stats = ntt.smrf_las(fn, out, chunk_points=2500, **kw)
    monkeypatch.undo()
    assert calls == [2500, 2500, 2500, 1500] * 2
    d = tln.read_las_arrays(fn)
    _, t2, _, is_obj = ntt.smrf(d["x"], d["y"], d["z"], **kw)
    assert t == t2
    want = np.where(_np(is_obj), 1, 2)
    got = np.asarray(ntt.read_las(out)[1]["class"]) & 0x1F
    np.testing.assert_array_equal(got, want)
    assert stats == {"n_points": n, "n_object": int((want == 1).sum()),
                     "n_ground": int((want == 2).sum())}
    assert 0 < stats["n_object"] < n
    out2 = str(tmp_path / "out2.las")
    monkeypatch.setattr(_host_build, "_LOADED", {"las_decoder": None})
    ntt.smrf_las(fn, out2, chunk_points=2500, **kw)
    assert open(out, "rb").read() == open(out2, "rb").read()
