"""The PyTorch port's SMRF pipeline (``neilpy_tpu_torch``:
``progressive_filter``, ``smrf`` fast and exact, ``smrf_las``) held
against the JAX package and the f64 scipy oracle on the CPU, from the
same seeded clouds.

Tolerances: ``progressive_filter`` exactly; ``smrf`` fast labels and
object cells equal to JAX fast on >= 99.9%, the chunk-streamed point
stage bit-identical to the one-shot call; ``smrf`` exact bit-identical
to ``np_smrf`` and to JAX exact on the synthetic building scene of
``tests/test_smrf.py:140-156``; ``smrf_las`` classes equal to the
in-memory ``smrf`` on the same frame, every other byte unchanged.
JAX's exact path runs once in this file (repeated x64 compiles in one
process have crashed XLA:CPU, ``tests/test_smrf.py:175-180``).
"""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import neilpy_tpu as nt
import neilpy_tpu_torch as ntt

from .reference_impls import np_progressive_filter, np_smrf

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from chip_smoke import lidar_tile  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
KW = dict(slope_threshold=.15, elevation_threshold=.5, elevation_scaler=1.25)


def building_scene(seed=12345, n=4000):
    """tests/test_smrf.py:140-156's scene: 50 x 40 m, a 6 m box."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 50, n)
    y = rng.uniform(0, 40, n)
    z = rng.normal(0, 0.1, n) + 0.02 * x
    obj = (x > 15) & (x < 25) & (y > 10) & (y < 25)
    return x, y, z + 6.0 * obj, obj


def rolling_tile(seed, n, side):
    """``chip_smoke.py``'s synthetic lidar tile (rolling ground, box
    buildings 10-24 m wide, scattered canopy) at a small size: (x, y, z,
    building)."""
    x, y, z, building, _ = lidar_tile(seed, n, side)
    return x, y, z, building


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ----------------------------------------------------------------------
# progressive_filter
# ----------------------------------------------------------------------
@pytest.mark.parametrize("windows,cellsize", [(np.arange(1, 6), 1),
                                              (np.array([1, 3, 7]), 2.5)])
def test_progressive_filter_matches(windows, cellsize):
    Z = np.random.default_rng(30).normal(size=(50, 60)).cumsum(axis=0)
    Z = Z.astype(np.float32)
    got, drop = ntt.progressive_filter(Z, windows, cellsize=cellsize,
                                       return_when_dropped=True, device=CPU)
    want, jdrop = nt.progressive_filter(Z, windows, cellsize=cellsize,
                                        return_when_dropped=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(drop.numpy(), np.asarray(jdrop))
    assert drop.dtype == torch.uint8
    np.testing.assert_array_equal(
        ntt.progressive_filter(Z, windows, cellsize=cellsize,
                               device=CPU).numpy(), np.asarray(want))
    if cellsize == 1:
        ref = np_progressive_filter(Z.astype(np.float64), windows)
        assert (got.numpy() == ref).mean() > 0.999


# ----------------------------------------------------------------------
# smrf fast
# ----------------------------------------------------------------------
SCENES = {
    # tests/test_smrf.py's return_extras scene: a Jacobi-sized grid
    "box_cell2": (lambda: building_scene(7, 3000), dict(cellsize=2,
                                                        windows=4)),
    "building": (building_scene, dict(cellsize=1, windows=6)),
    # >= 64 cells a side: the springs fills take the multigrid branch
    "rolling": (lambda: rolling_tile(31, 25000, 130.0),
                dict(cellsize=1, windows=12)),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_smrf_fast_matches_jax(scene):
    make, kw = SCENES[scene]
    x, y, z, obj = make()
    Zp, t, cells, pts = ntt.smrf(x, y, z, **kw, **KW, device=CPU)
    jZp, jt, jcells, jpts = nt.smrf(x, y, z, **kw, **KW)
    assert tuple(t) == tuple(jt)
    assert Zp.dtype == torch.float32 and pts.dtype == torch.bool
    assert (pts.numpy() == np.asarray(jpts)).mean() >= 0.999
    assert (cells.numpy() == np.asarray(jcells)).mean() >= 0.999
    np.testing.assert_allclose(Zp.numpy(), np.asarray(jZp), atol=1e-3,
                               rtol=0)
    assert pts.numpy()[obj].mean() > 0.9 and pts.numpy()[~obj].mean() < 0.2


def test_smrf_streamed_points_bit_identical():
    """Streaming the point stage across a non-multiple chunk boundary
    gives the one-shot call's labels and heights bit for bit."""
    x, y, z, _ = rolling_tile(32, 5000, 80.0)
    kw = dict(cellsize=2, windows=4, return_extras=True, device=CPU)
    one = ntt.smrf(x, y, z, **kw)
    two = ntt.smrf(x, y, z, chunk_points=1999, **kw)
    for a, b in zip(one[:4], two[:4]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert torch.equal(one[4]["above_ground_height"],
                       two[4]["above_ground_height"])
    np.testing.assert_array_equal(one[4]["when_dropped"],
                                  two[4]["when_dropped"])


def test_smrf_extras_match_jax():
    x, y, z, _ = building_scene(8, 3000)
    kw = dict(cellsize=2, windows=4, return_extras=True, low_outlier_fill=True)
    *_, ex = ntt.smrf(x, y, z, **kw, device=CPU)
    *_, jex = nt.smrf(x, y, z, **kw)
    assert set(ex) == set(jex)
    np.testing.assert_allclose(ex["above_ground_height"].numpy(),
                               np.asarray(jex["above_ground_height"]),
                               atol=1e-3, rtol=0)
    assert (ex["drop_raster"].numpy()
            == np.asarray(jex["drop_raster"])).mean() >= 0.999
    assert (ex["when_dropped"] == np.asarray(jex["when_dropped"])).mean() \
        >= 0.999
    with pytest.raises(ValueError, match="precision"):
        ntt.smrf(x, y, z, precision="double", device=CPU)


# ----------------------------------------------------------------------
# smrf exact
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def exact_building():
    x, y, z, _ = building_scene()
    ref_pts, ref_obj = np_smrf(x, y, z, 1, 6, .15, .5, 1.25)
    _, _, j_obj, j_pts = nt.smrf(x, y, z, 1, 6, .15, .5, 1.25,
                                 precision="exact")
    return (x, y, z), (ref_pts, ref_obj), (np.asarray(j_pts),
                                           np.asarray(j_obj))


def test_smrf_exact_bit_identical_to_oracle_and_jax(exact_building):
    (x, y, z), (ref_pts, ref_obj), (j_pts, j_obj) = exact_building
    Zp, t, cells, pts = ntt.smrf(x, y, z, 1, 6, .15, .5, 1.25,
                                 precision="exact", device=CPU)
    assert Zp.dtype == torch.float64
    np.testing.assert_array_equal(pts.numpy(), ref_pts)
    np.testing.assert_array_equal(cells.numpy(), ref_obj)
    np.testing.assert_array_equal(pts.numpy(), j_pts)
    np.testing.assert_array_equal(cells.numpy(), j_obj)


def test_smrf_exact_extras_are_float64(exact_building):
    (x, y, z), (ref_pts, _), _ = exact_building
    *_, pts, ex = ntt.smrf(x, y, z, 1, 6, .15, .5, 1.25, precision="exact",
                           return_extras=True, device=CPU)
    assert ex["above_ground_height"].dtype == torch.float64
    np.testing.assert_array_equal(pts.numpy(), ref_pts)
    fast = ntt.smrf(x, y, z, 1, 6, .15, .5, 1.25, device=CPU)[3]
    assert (fast.numpy() == pts.numpy()).mean() >= 0.999


# ----------------------------------------------------------------------
# smrf_las
# ----------------------------------------------------------------------
def las_cloud(seed, n=6000):
    """Coordinates pre-rounded to the LAS 1 mm scale so the in-memory
    cloud and the file's decoded points are the same numbers."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(0, 80, n), 3)
    y = np.round(rng.uniform(0, 60, n), 3)
    ground = 3 * np.sin(x / 15) + 2 * np.cos(y / 10)
    objects = (rng.random(n) < 0.15) * rng.uniform(2, 8, n)
    return x, y, np.round(ground + objects, 3)


LAS_KW = dict(cellsize=1, windows=np.array([1, 2]), **KW)


@pytest.mark.parametrize("pdrf", [0, 6])
def test_smrf_las_matches_in_memory_smrf(tmp_path, pdrf):
    x, y, z = las_cloud(40 + pdrf)
    fn, out = str(tmp_path / "in.las"), str(tmp_path / "out.las")
    ntt.write_las(fn, x, y, z, pdrf=pdrf)
    Zpro, t, cells, stats = ntt.smrf_las(fn, out, chunk_points=2500,
                                         device=CPU, **LAS_KW)
    _, df = ntt.read_las(fn)
    _, t2, cells2, is_obj = ntt.smrf(df.x, df.y, df.z, device=CPU, **LAS_KW)
    assert t == t2 and torch.equal(cells, cells2)
    _, dfo = ntt.read_las(out)
    want = np.where(is_obj.numpy(), 1, 2)
    np.testing.assert_array_equal(np.asarray(dfo["class"]), want)
    assert stats == {"n_points": x.size, "n_object": int(is_obj.sum()),
                     "n_ground": x.size - int(is_obj.sum())}
    # and the JAX package's smrf_las on the same file, labels >= 99.9%
    jout = str(tmp_path / "jax.las")
    nt.smrf_las(fn, jout, **LAS_KW)
    _, dfj = nt.read_las(jout)
    assert (np.asarray(dfj["class"]) == want).mean() >= 0.999


def test_smrf_las_preserves_everything_but_classification(tmp_path):
    rng = np.random.default_rng(42)
    x, y, z = las_cloud(43, n=3000)
    n = x.size
    flags = (rng.integers(0, 8, n).astype(np.uint8) << 5)
    fn, out = str(tmp_path / "in.las"), str(tmp_path / "out.las")
    ntt.write_las(fn, x, y, z, pdrf=3,
                  intensity=rng.integers(0, 65535, n).astype(np.uint16),
                  gpstime=np.sort(rng.random(n) * 1e5),
                  rgb=tuple(rng.integers(0, 65535, n).astype(np.uint16)
                            for _ in range(3)),
                  classification=flags | 5)
    ntt.smrf_las(fn, out, cellsize=1, windows=np.array([1]), device=CPU)
    raw_in = np.frombuffer(open(fn, "rb").read(), np.uint8)
    raw_out = np.frombuffer(open(out, "rb").read(), np.uint8)
    assert raw_in.size == raw_out.size
    reclen = ntt.io.las.las_point_dtype(3).itemsize
    off0 = raw_in.size - n * reclen
    recs_in = raw_in[off0:].reshape(n, reclen)
    recs_out = raw_out[off0:].reshape(n, reclen)
    np.testing.assert_array_equal(raw_in[:off0], raw_out[:off0])
    keep = np.ones(reclen, bool)
    keep[15] = False
    np.testing.assert_array_equal(recs_in[:, keep], recs_out[:, keep])
    assert (recs_out[:, 15] & 0xE0 == flags).all()
    assert np.isin(recs_out[:, 15] & 0x1F, (1, 2)).all()


def test_smrf_las_refusals(tmp_path):
    with pytest.raises(ValueError, match="differ"):
        ntt.smrf_las(str(tmp_path / "a.las"), str(tmp_path / "a.las"),
                     device=CPU)
    x, y, z = las_cloud(44, n=2000)
    fn0, fn6 = str(tmp_path / "p0.las"), str(tmp_path / "p6.las")
    ntt.write_las(fn0, x, y, z, pdrf=0)
    ntt.write_las(fn6, x, y, z, pdrf=6)
    kw = dict(cellsize=1, windows=np.array([1]), device=CPU)
    with pytest.raises(ValueError, match="5-bit"):
        ntt.smrf_las(fn0, str(tmp_path / "o0.las"), ground_class=64, **kw)
    with pytest.raises(ValueError, match="uint8"):
        ntt.smrf_las(fn6, str(tmp_path / "o6.las"), ground_class=256, **kw)
    out6 = str(tmp_path / "o6.las")
    ntt.smrf_las(fn6, out6, ground_class=64, object_class=65, **kw)
    _, dfo = ntt.read_las(out6)
    assert np.isin(np.asarray(dfo["class"]), (64, 65)).all()


# ----------------------------------------------------------------------
# public surface
# ----------------------------------------------------------------------
SLICE_NAMES = ("Raster", "keep_xyz", "edges_from_IT", "unique_rows", "cutter",
               "normalize", "read_las", "write_las", "read_isprs", "read_xyz",
               "create_dem", "create_dem_from_las", "bin_points",
               "inpaint_nans_by_springs", "inpaint_nans_by_fda",
               "inpaint_nearest", "inpaint_nearest_device",
               "grey_erosion_disk", "grey_dilation_disk", "opening_disk",
               "opening", "erosion", "dilation", "interp_spline_2d", "smrf",
               "smrf_las", "progressive_filter")
# host-only functions: they take and return host numpy or files
HOST_ONLY = {"Raster", "keep_xyz", "edges_from_IT", "unique_rows", "cutter",
             "read_las", "write_las", "read_isprs", "read_xyz", "bin_points",
             "inpaint_nearest"}


@pytest.mark.parametrize("name", SLICE_NAMES)
def test_slice_names_match_the_jax_package(name):
    """Every name of the slice that ``neilpy_tpu/__init__.py`` exports is
    exported by the port with the JAX arguments and defaults, in order;
    every device function adds ``device=None`` at the end."""
    ours = inspect.signature(getattr(ntt, name)).parameters
    theirs = inspect.signature(getattr(nt, name)).parameters
    assert list(ours)[:len(theirs)] == list(theirs)
    for p in theirs:
        assert ours[p].default == theirs[p].default, p
    extra = list(ours)[len(theirs):]
    assert extra == ([] if name in HOST_ONLY else ["device"])
    if extra:
        assert ours["device"].default is None


# ----------------------------------------------------------------------
# on the card only
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["building", "rolling"])
def test_smrf_fast_on_card_matches_cpu(cuda_device, scene):
    make, kw = SCENES[scene]
    x, y, z, _ = make()
    Zp, t, cells, pts = ntt.smrf(x, y, z, **kw, **KW, device=cuda_device)
    cZp, ct, ccells, cpts = ntt.smrf(x, y, z, **kw, **KW, device=CPU)
    assert pts.is_cuda and tuple(t) == tuple(ct)
    assert (pts.cpu() == cpts).float().mean() >= 0.999
    assert (cells.cpu() == ccells).float().mean() >= 0.999
    torch.testing.assert_close(Zp.cpu(), cZp, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_smrf_exact_on_card_matches_oracle(cuda_device, exact_building):
    (x, y, z), (ref_pts, ref_obj), _ = exact_building
    _, _, cells, pts = ntt.smrf(x, y, z, 1, 6, .15, .5, 1.25,
                                precision="exact", device=cuda_device)
    assert pts.is_cuda
    np.testing.assert_array_equal(pts.cpu().numpy(), ref_pts)
    np.testing.assert_array_equal(cells.cpu().numpy(), ref_obj)
