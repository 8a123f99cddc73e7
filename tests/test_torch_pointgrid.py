"""The PyTorch port's SMRF building blocks (``neilpy_tpu_torch``: core/grid,
io/text, io/las, ops/pointgrid, ops/morphology, ops/inpaint, ops/spline)
held against the JAX package on the CPU, from the same seeded inputs.

Tolerances: gridding, morphology, LAS frames and bytes, and the host
grid helpers exactly; ``normalize`` within 1e-6; the spring fill in
float32 within 1e-3 of JAX and 5e-3 of the f64 direct solve
(``np_spring_inpaint``), in float64 at tol=1e-12 within 1e-8 of it, the
multigrid iteration count within one of JAX's; spline moments within
1e-5 relative in float32 and 1e-12 in float64, the interpolant within
2e-3 of scipy's ``RectBivariateSpline``.
"""

import warnings

import jax
import numpy as np
import pandas as pd
import pytest
import scipy.ndimage as ndi
import torch

import neilpy_tpu as nt
import neilpy_tpu_torch as ntt
from neilpy_tpu.core.codes import disk
from neilpy_tpu.ops import inpaint as jinp
from neilpy_tpu.ops import pointgrid as jpg
from neilpy_tpu.ops import spline as jspl
from neilpy_tpu_torch.ops import inpaint as tinp
from neilpy_tpu_torch.ops import pointgrid as tpg
from neilpy_tpu_torch.ops import spline as tspl

from .reference_impls import np_spring_inpaint

torch.set_num_threads(1)
CPU = "cpu"


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same_grid(a, b):
    """Equal element for element, NaN at the same cells."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a, nan=0.0),
                                  np.nan_to_num(b, nan=0.0))


def _cloud(seed, n=20000, x0=512000.0, y0=5403000.0, w=100.0, h=80.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(x0, x0 + w, n), rng.uniform(y0, y0 + h, n),
            rng.normal(300, 10, n))


# ----------------------------------------------------------------------
# core/grid
# ----------------------------------------------------------------------
def test_raster_properties_match():
    Z = np.random.default_rng(1).normal(size=(32, 48)).astype(np.float32)
    t = ntt.from_origin(500000.0, 4200032.0, 1.0, 1.0)
    R = ntt.Raster(torch.from_numpy(Z), transform=t, crs=32617)
    J = nt.Raster(Z, transform=nt.from_origin(500000.0, 4200032.0, 1.0, 1.0),
                  crs=32617)
    assert R.shape == tuple(J.shape) and R.cellsize == J.cellsize
    assert R.bounds == J.bounds
    R2 = R.with_data(R.data * 2)
    assert R2.crs == 32617 and R2.transform == t
    np.testing.assert_array_equal(R2.data.numpy(), Z * 2)


def test_host_grid_helpers_match():
    rng = np.random.default_rng(2)
    df = pd.DataFrame({"x": rng.uniform(0, 10, 200),
                       "y": rng.uniform(0, 10, 200),
                       "z": rng.uniform(0, 10, 200)})
    for kw in ({"x": (1, 8)}, {"x": (2, 9), "y": (0, 5), "z": (3, 7)}, {}):
        pd.testing.assert_frame_equal(ntt.keep_xyz(df, **kw),
                                      nt.keep_xyz(df, **kw))
    img = np.zeros((6, 9))
    t = nt.from_origin(10.0, 20.0, 0.5, 0.5)
    for a, b in zip(ntt.edges_from_IT(torch.from_numpy(img), t),
                    nt.edges_from_IT(img, t)):
        np.testing.assert_array_equal(a, b)
    rows = rng.integers(0, 3, size=(50, 3))
    np.testing.assert_array_equal(ntt.unique_rows(rows),
                                  nt.unique_rows(rows))
    Z = rng.normal(size=(48, 56))
    for tt, tj in zip(ntt.cutter(torch.from_numpy(Z), 4, 7),
                      nt.cutter(Z, 4, 7)):
        for a, b in zip(tt, tj):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("xrange,yrange", [
    (("min", "max"), (0, 1)), (("mean", "max"), (-1, 1)),
    (("min", "median", "max"), (0, 0.5, 1)), ((-2.0, 3.0), (-1, 2))])
@pytest.mark.parametrize("n_cols", [55, 56])
def test_normalize_matches(xrange, yrange, n_cols):
    """Odd and even counts (the median of an even count averages the two
    middle values), NaN cells and values beyond the range."""
    Z = np.random.default_rng(3).normal(size=(48, n_cols)).cumsum(axis=0)
    Z = Z.astype(np.float32)
    Z[5:8, 3:9] = np.nan
    got = ntt.normalize(Z, xrange, yrange, device=CPU)
    want = np.asarray(nt.normalize(Z, xrange, yrange))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# ----------------------------------------------------------------------
# io/text, io/las
# ----------------------------------------------------------------------
def test_text_readers_match(tmp_path):
    rng = np.random.default_rng(4)
    pts = np.column_stack([rng.uniform(0, 100, 50), rng.uniform(0, 100, 50),
                           rng.uniform(0, 10, 50), rng.integers(0, 2, 50)])
    isprs = tmp_path / "samp.txt"
    np.savetxt(isprs, pts, delimiter="\t", fmt="%.2f")
    pd.testing.assert_frame_equal(ntt.read_isprs(str(isprs)),
                                  nt.read_isprs(str(isprs)))
    xyz = tmp_path / "p.xyz"
    np.savetxt(xyz, pts[:, :3], fmt="%.3f")
    pd.testing.assert_frame_equal(ntt.read_xyz(str(xyz)),
                                  nt.read_xyz(str(xyz)))
    csv = tmp_path / "p.csv"
    np.savetxt(csv, pts[:, :3], fmt="%.3f", delimiter=",")
    pd.testing.assert_frame_equal(ntt.read_xyz(str(csv), delimiter=","),
                                  nt.read_xyz(str(csv), delimiter=","))


def _las_columns(rng, n, pdrf):
    kw = dict(intensity=rng.integers(0, 65535, n).astype(np.uint16),
              classification=rng.integers(0, 32, n).astype(np.uint8),
              return_number=rng.integers(1, 4, n),
              num_returns=np.full(n, 3), pdrf=pdrf,
              point_source_id=rng.integers(0, 100, n))
    if pdrf in (1, 3, 6, 7, 8):
        kw["gpstime"] = np.sort(rng.random(n) * 1e5)
    if pdrf in (2, 3, 7, 8):
        kw["rgb"] = tuple(rng.integers(0, 65535, n).astype(np.uint16)
                          for _ in range(3))
    if pdrf >= 6:
        kw["wkt"] = 'PROJCS["x"]'
    return kw


@pytest.mark.parametrize("pdrf", [0, 1, 2, 3, 6, 7, 8])
def test_las_write_bytes_and_read_frames_match(tmp_path, pdrf):
    rng = np.random.default_rng(5 + pdrf)
    n = 500
    x = np.round(rng.uniform(500000, 500100, n), 3)
    y = np.round(rng.uniform(4200000, 4200080, n), 3)
    z = np.round(rng.uniform(200, 260, n), 3)
    kw = _las_columns(rng, n, pdrf)
    ft, fj = str(tmp_path / "t.las"), str(tmp_path / "j.las")
    ntt.write_las(ft, x, y, z, **kw)
    nt.write_las(fj, x, y, z, **kw)
    assert open(ft, "rb").read() == open(fj, "rb").read()
    ht, dt = ntt.read_las(fj)
    hj, dj = nt.read_las(fj)
    assert ht == hj
    pd.testing.assert_frame_equal(dt, dj)
    assert ntt.write_las.__module__.startswith("neilpy_tpu_torch")


# ----------------------------------------------------------------------
# ops/pointgrid
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bin_type", ["min", "max"])
@pytest.mark.parametrize("method", ["scatter", "sort"])
def test_create_dem_host_binning_matches(bin_type, method):
    x, y, z = _cloud(6)
    got, tt = ntt.create_dem(x, y, z, cellsize=1, bin_type=bin_type,
                             method=method, device=CPU)
    want, tj = nt.create_dem(x, y, z, cellsize=1, bin_type=bin_type,
                             method=method)
    assert tuple(tt) == tuple(tj)
    assert_same_grid(got, want)


@pytest.mark.parametrize("bin_type,chunks", [("min", 1), ("max", 1),
                                             ("min", 3), ("max", 4),
                                             ("min", 7)])
def test_create_dem_device_bin_matches(bin_type, chunks):
    """The device floor path, one batch and streamed (7 leaves a short
    tail batch), equals the JAX fused and streamed grids."""
    x, y, z = _cloud(7, n=50000, x0=500000.0, y0=4200000.0, w=200, h=150)
    got, tt = ntt.create_dem(x, y, z, cellsize=1, bin_type=bin_type,
                             device_bin=True, chunks=chunks, device=CPU)
    want, tj = nt.create_dem(x, y, z, cellsize=1, bin_type=bin_type,
                             device_bin=True, chunks=chunks)
    assert tuple(tt) == tuple(tj)
    assert_same_grid(got, want)


def test_create_dem_device_bin_sort_and_inpaint_match():
    x, y, z = _cloud(8, n=8000, w=60, h=70)
    got, _ = ntt.create_dem(x, y, z, cellsize=2, bin_type="min",
                            device_bin=True, method="sort", device=CPU)
    want, _ = nt.create_dem(x, y, z, cellsize=2, bin_type="min",
                            device_bin=True, method="sort")
    assert_same_grid(got, want)
    filled, _ = ntt.create_dem(x, y, z, cellsize=2, bin_type="min",
                               inpaint=True, device=CPU)
    ref, _ = nt.create_dem(x, y, z, cellsize=2, bin_type="min", inpaint=True)
    assert filled.device.type == "cpu" and torch.isfinite(filled).all()
    np.testing.assert_allclose(filled.numpy(), np.asarray(ref), atol=1e-3,
                               rtol=0)


def test_create_dem_explicit_edges_match():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.uniform(0, 10, 300), [99.0, -5.0]])
    y = np.concatenate([rng.uniform(0, 10, 300), [99.0, 3.0]])
    z = rng.normal(size=x.size)
    edges = (np.arange(0, 11.0), np.arange(10.0, -1, -1))
    for device_bin in (False, True):
        got, tt = ntt.create_dem(x, y, z, bin_type="max", edges=edges,
                                 device_bin=device_bin, device=CPU)
        want, tj = nt.create_dem(x, y, z, bin_type="max", edges=edges,
                                 device_bin=device_bin)
        assert tuple(tt) == tuple(tj) and got.shape == (10, 10)
        assert_same_grid(got, want)


def test_points_exactly_on_cell_edges():
    """Lower-edge-inclusive floor binning on both paths
    (tests/test_pointgrid_inpaint.py:118-140), equal to JAX."""
    x = np.array([0.0, 0.5, 1.0, 1.5])
    y = np.array([0.0, 0.5, 1.0, 1.5])
    z = np.array([10.0, 20.0, 30.0, 40.0])
    expect = {(2, 0): 10.0, (2, 1): 20.0, (1, 1): 30.0, (1, 2): 40.0}
    for device_bin in (False, True):
        I, _ = ntt.create_dem(x, y, z, cellsize=1, bin_type="max",
                              device_bin=device_bin, device=CPU)
        assert_same_grid(I, nt.create_dem(x, y, z, cellsize=1,
                                          bin_type="max",
                                          device_bin=device_bin)[0])
        assert int(torch.isfinite(I).sum()) == 4
        for (r, c), v in expect.items():
            assert float(I[r, c]) == v


@pytest.mark.parametrize("chunks", [1, 3])
def test_inf_values_and_identity_cell_match(chunks):
    """Only the reduction identity maps to NaN: a -inf-only cell under
    max reads NaN, +inf points survive (test_pointgrid_inpaint.py:185-204);
    the sort path keeps the -inf, as JAX's does."""
    x = np.array([0.2, 1.2, 2.2, 0.2, 1.2, 2.2])
    y = np.array([0.2, 0.2, 0.2, 1.2, 1.2, 1.2])
    z = np.array([np.inf, 1.0, 2.0, -np.inf, 3.0, np.inf], dtype=np.float32)
    got, _ = ntt.create_dem(x, y, z, cellsize=1, bin_type="max",
                            device_bin=True, chunks=chunks, device=CPU)
    want, _ = nt.create_dem(x, y, z, cellsize=1, bin_type="max",
                            device_bin=True, chunks=chunks)
    assert_same_grid(got, want)
    assert int(torch.isposinf(got).sum()) == 2
    assert int(torch.isnan(got).sum()) == got.numel() - 5
    for method in ("scatter", "sort"):
        assert_same_grid(
            ntt.create_dem(x, y, z, cellsize=1, bin_type="max",
                           method=method, device=CPU)[0],
            nt.create_dem(x, y, z, cellsize=1, bin_type="max",
                          method=method)[0])


def test_scatter_reduce_forms_match():
    rng = np.random.default_rng(10)
    ny, nx, n = 37, 53, 5000
    r = rng.integers(0, ny, n)
    c = rng.integers(0, nx, n)
    z = rng.normal(size=n).astype(np.float32)
    valid = rng.random(n) > 0.1
    for bin_type in ("max", "min"):
        flat = tpg.scatter_reduce((r * nx + c).astype(np.int64), z, valid,
                                  ny * nx, bin_type=bin_type, device=CPU)
        assert_same_grid(flat, jpg.scatter_reduce(
            (r * nx + c).astype(np.int64), z, valid, ny * nx,
            bin_type=bin_type))
        rc = tpg._scatter_reduce_rc(r, c, z, valid, ny, nx, bin_type,
                                    device=CPU)
        assert_same_grid(rc, flat.reshape(ny, nx))


def test_bin_points_and_limits():
    x, y, _ = _cloud(11, n=3000)
    for a, b in zip(tpg.bin_points(x, y, cellsize=1.5),
                    jpg.bin_points(x, y, cellsize=1.5, native=False)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert tuple(a) == tuple(b)
    native = tpg.bin_points(x, y, cellsize=1.5, native=True)
    for a, b in zip(native, tpg.bin_points(x, y, cellsize=1.5)):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert tuple(a) == tuple(b)
    with pytest.raises(ValueError, match="int32"):
        tpg.scatter_reduce(np.zeros(4, np.int64), np.ones(4, np.float32),
                           np.ones(4, bool), 50000 * 50000, device=CPU)
    with pytest.raises(ValueError, match="scatter"):
        ntt.create_dem(np.array([0.0, 49999.0]), np.array([0.0, 49999.0]),
                       np.array([1.0, 2.0]), method="sort", device=CPU)
    with pytest.raises(ValueError, match="order-independent"):
        ntt.create_dem(x, y, x, device_bin=True, method="sort", chunks=2,
                       device=CPU)
    with pytest.raises(ValueError, match="not supported"):
        ntt.create_dem(x, y, x, bin_type="mean", device=CPU)


def test_numpy_input_goes_to_cuda():
    """Without ``device`` numpy input goes to CUDA: on a machine without
    a card that raises, rather than running on the host unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.array([0.0, 1.0, 2.0])
    for call in (lambda: ntt.create_dem(x, x, x),
                 lambda: ntt.opening_disk(np.zeros((8, 8)), 2),
                 lambda: ntt.inpaint_nans_by_springs(np.zeros((8, 8))),
                 lambda: ntt.interp_spline_2d(np.zeros((8, 8)), x, x),
                 lambda: ntt.smrf(x, x, x)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_create_dem_from_las_matches(tmp_path, monkeypatch):
    """The port streams through its native decoder in the header's
    frame; the JAX side is held to its ``read_las`` branch (its native
    one needs its own build), which takes the filtered points' frame.
    ``write_las`` writes a truthful header and the bbox edges snap to
    the same cells as the points inside them, so the grids agree."""
    import neilpy_tpu.io.las_native as las_native
    monkeypatch.setattr(las_native, "native_available", lambda: False)
    rng = np.random.default_rng(12)
    n = 4000
    x = np.round(rng.uniform(0, 80, n), 3)
    y = np.round(rng.uniform(0, 60, n), 3)
    z = np.round(rng.uniform(0, 10, n), 3)
    cls = rng.integers(1, 3, n).astype(np.uint8)
    fn = str(tmp_path / "in.las")
    nt.write_las(fn, x, y, z, classification=cls)
    for kw in ({}, {"classes": (2,), "stride": 2},
               {"bbox": (10, 50, 5, 40), "bin_type": "min"}):
        got, tt = ntt.create_dem_from_las(fn, cellsize=2, device=CPU, **kw)
        want, tj = nt.create_dem_from_las(fn, cellsize=2, **kw)
        assert tuple(tt) == tuple(tj)
        assert_same_grid(got, want)


# ----------------------------------------------------------------------
# ops/morphology
# ----------------------------------------------------------------------
@pytest.mark.parametrize("radius", [1, 2, 5, 11, 18])
def test_disk_morphology_matches(radius):
    Z = np.random.default_rng(13).normal(size=(60, 73)).cumsum(axis=0)
    Z = Z.astype(np.float32)
    Z[20, 30] = np.nan
    for tfn, jfn in ((ntt.grey_erosion_disk, nt.grey_erosion_disk),
                     (ntt.grey_dilation_disk, nt.grey_dilation_disk),
                     (ntt.opening_disk, nt.opening_disk)):
        assert_same_grid(tfn(Z, radius, device=CPU), jfn(Z, radius))


@pytest.mark.parametrize("radius", [1, 6])
def test_disk_opening_float64_matches_scipy(radius):
    """float64 stays float64 (the exact SMRF path) and equals scipy."""
    Z = np.random.default_rng(14).normal(size=(40, 55)).cumsum(axis=1)
    got = ntt.opening_disk(torch.from_numpy(Z), radius)
    assert got.dtype == torch.float64
    ref = ndi.grey_dilation(ndi.grey_erosion(Z, footprint=disk(radius)),
                            footprint=disk(radius))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("footprint", [
    np.ones((3, 3), np.uint8),
    np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8),
    np.array([[1, 1, 0, 0], [0, 1, 1, 1]], np.uint8)])
def test_generic_footprint_matches(footprint):
    Z = np.random.default_rng(15).normal(size=(30, 31)).astype(np.float32)
    for tfn, jfn in ((ntt.erosion, nt.erosion), (ntt.dilation, nt.dilation),
                     (ntt.opening, nt.opening)):
        assert_same_grid(tfn(Z, footprint, device=CPU), jfn(Z, footprint))


# ----------------------------------------------------------------------
# ops/inpaint
# ----------------------------------------------------------------------
def _holey(seed, shape, holes):
    A = np.random.default_rng(seed).normal(size=shape).cumsum(
        axis=0).cumsum(axis=1)
    for sl in holes:
        A[sl] = np.nan
    return A


SMALL = _holey(16, (40, 50), [np.s_[10:18, 12:22], np.s_[30, 40],
                              np.s_[0, :5]])
LARGE = _holey(17, (96, 128), [np.s_[20:60, 30:90], np.s_[70:75, 5:9]])


@pytest.mark.parametrize("A", [SMALL, LARGE], ids=["jacobi", "multigrid"])
def test_springs_float32_matches(A):
    A32 = A.astype(np.float32)
    got, info = ntt.inpaint_nans_by_springs(A32, return_info=True,
                                            device=CPU)
    want, jinfo = nt.inpaint_nans_by_springs(A32, return_info=True)
    assert got.dtype == torch.float32 and info["converged"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np_spring_inpaint(A), atol=5e-3,
                               rtol=0)
    assert abs(info["iterations"] - jinfo["iterations"]) <= 1
    known = np.isfinite(A32)
    np.testing.assert_array_equal(got.numpy()[known], A32[known])
    assert 1 <= info["host_syncs"] <= info["iterations"] + 1


@pytest.mark.parametrize("A", [SMALL, LARGE], ids=["jacobi", "multigrid"])
def test_springs_float64_at_tol_1e12_matches_direct_solve(A):
    got = ntt.inpaint_nans_by_springs(torch.from_numpy(A), tol=1e-12,
                                      maxiter=100_000)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np_spring_inpaint(A), atol=1e-8,
                               rtol=0)


def test_cg_stop_test_on_device_freezes_the_iterate():
    """Reading the stop flag every k iterations gives the same bits as
    reading it every iteration: the iterate is frozen once the device's
    test holds; the host syncs once per k."""
    A = torch.from_numpy(SMALL.astype(np.float32))
    nan = torch.isnan(A)
    u = nan.float()
    deg = tinp._degree(A.shape)
    b = tinp._neighbor_sum(torch.where(nan, 0.0, A)) * u

    def apply_fn(x):
        x = x * u
        return (deg * x - tinp._neighbor_sum(x)) * u

    runs = [tinp._cg(apply_fn, b, u * 1.0, lambda r: r / deg * u, 1e-7, 4000,
                     False, k) for k in (1, 7, 16)]
    x1, it1, s1 = runs[0]
    assert s1 == it1
    for x, it, syncs in runs[1:]:
        assert it == it1 and torch.equal(x, x1)
    assert runs[1][2] == -(-it1 // 7) and runs[2][2] == -(-it1 // 16)


def test_springs_maxiter_warns_and_reports():
    A = _holey(18, (40, 50), [np.s_[5:35, 5:45]]).astype(np.float32)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, info = ntt.inpaint_nans_by_springs(A, maxiter=3,
                                              return_info=True, device=CPU)
    assert not info["converged"] and info["iterations"] == 3
    assert any("maxiter" in str(r.message) for r in rec)
    flat = np.full((10, 10), 7.0)
    flat[4:6, 4:6] = np.nan
    np.testing.assert_allclose(
        ntt.inpaint_nans_by_springs(flat, device=CPU).numpy(), 7.0,
        atol=1e-5)
    with pytest.raises(ValueError, match="4 neighbors"):
        ntt.inpaint_nans_by_springs(flat, neighbors=8, device=CPU)


def test_multigrid_pieces_match():
    """The Galerkin hierarchy and one K-cycle application equal the JAX
    package's on an odd-sized mask (every level pads)."""
    A = _holey(19, (70, 99), [np.s_[10:50, 20:80]]).astype(np.float32)
    unknown = np.isnan(A).astype(np.float32)
    deg = np.asarray(jinp._degree(A.shape))
    tl = tinp._build_levels(torch.from_numpy(unknown), torch.from_numpy(deg))
    jl = jinp._build_levels(unknown, deg)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    r = np.random.default_rng(20).normal(size=A.shape).astype(np.float32)
    r *= unknown
    got = tinp._kcycle(torch.from_numpy(r), tl, 0).numpy()
    want = np.asarray(jax.jit(lambda v: jinp._kcycle(v, jl, 0))(r))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


def test_fda_and_nearest_match():
    yy, xx = np.mgrid[0:30, 0:30]
    A = (0.1 * xx + 0.2 * yy).astype(float)
    A[10:20, 10:20] = np.nan
    got = ntt.inpaint_nans_by_fda(A, device=CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(nt.inpaint_nans_by_fda(
        A)), atol=1e-4, rtol=0)
    B = np.random.default_rng(21).normal(size=(15, 17))
    B[5:9, 5:9] = np.nan
    np.testing.assert_array_equal(ntt.inpaint_nearest(torch.from_numpy(B)),
                                  nt.inpaint_nearest(B.copy()))


def test_inpaint_nearest_device_takes_a_nearest_seed():
    """The jump-flooding fill, held to the JAX package's own criterion
    (tests/test_pointgrid_inpaint.py:334-354, whose JAX compile alone
    takes seconds): every cell filled from the finite set, >= 99.9% of
    them with an exactly-nearest seed."""
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(22)
    C = np.full((48, 64), np.nan, dtype=np.float32)
    idx = rng.random((48, 64)) < 0.04
    C[idx] = rng.normal(size=int(idx.sum())).astype(np.float32)
    out = ntt.inpaint_nearest_device(C, device=CPU).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[idx], C[idx])
    assert set(out[~idx].tolist()) <= set(C[idx].tolist())
    seeds, miss = np.argwhere(idx), np.argwhere(~idx)
    d_exact, _ = cKDTree(seeds).query(miss)
    seedpos = {v: tuple(p) for v, p in zip(C[idx], seeds)}
    chosen = np.array([seedpos[out[tuple(p)]] for p in miss])
    d_jfa = np.sqrt(((chosen - miss) ** 2).sum(1))
    assert np.mean(np.isclose(d_jfa, d_exact)) > 0.999


# ----------------------------------------------------------------------
# ops/spline
# ----------------------------------------------------------------------
def _surface(seed, shape=(50, 60)):
    return np.random.default_rng(seed).normal(size=shape).cumsum(
        axis=0).cumsum(axis=1)


@pytest.mark.parametrize("shape", [(50, 60), (4, 9), (5, 4)])
def test_spline_coefficients_float32_match(shape):
    Z = _surface(24, shape).astype(np.float32)
    got = ntt.ops.spline.spline_coefficients_2d(Z, device=CPU)
    want = jspl.spline_coefficients_2d(Z)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_spline_coefficients_float64_match():
    Z = _surface(25)
    got = tspl.spline_coefficients_2d(torch.from_numpy(Z))
    with jax.enable_x64():
        want = [np.asarray(b) for b in jspl.spline_coefficients_2d(Z)]
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and b.dtype == np.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * np.abs(b).max())


def test_interp_spline_matches_scipy_and_jax():
    from scipy.interpolate import RectBivariateSpline
    rng = np.random.default_rng(26)
    Z = _surface(27)
    f = RectBivariateSpline(np.arange(0.5, 50.5), np.arange(0.5, 60.5), Z)
    qr = rng.uniform(-0.5, 50.5, 5000)
    qc = rng.uniform(-0.5, 60.5, 5000)
    got = ntt.interp_spline_2d(Z.astype(np.float32), qr, qc, device=CPU)
    np.testing.assert_allclose(got.numpy(), f.ev(qr, qc), atol=2e-3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(nt.interp_spline_2d(Z.astype(np.float32),
                                                    qr, qc)),
        atol=1e-5 * np.abs(Z).max(), rtol=0)
    got64 = ntt.interp_spline_2d(torch.from_numpy(Z), qr, qc)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), f.ev(qr, qc),
                               atol=1e-9 * np.abs(Z).max(), rtol=0)
