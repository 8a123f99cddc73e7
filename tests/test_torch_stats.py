"""The PyTorch port's raster statistics (``neilpy_tpu_torch.ops.stats``)
and the four sharded DEM products of ``neilpy_tpu_torch.dist``
(``sharded_rastergi``, ``sharded_morans_i``, ``sharded_local_morans_i``,
``sharded_hillshade``) held against the JAX package on the CPU, from the
same seeded numpy rasters with NaN holes.

The JAX sharded references run on conftest's 8-device CPU mesh, each
under one ``jax.jit`` (eager ``shard_map`` costs seconds a call); the
port's on a mesh naming the host eight (or four) times.

Tolerances (each inside the JAX package's own test of the function,
``tests/test_stats_viz_aux.py:10-140`` and ``tests/test_dist.py:57-64``,
``:265-330``):
- Gi / Gi* z within rtol 1e-5 + atol 1e-5 (whole-map sums in another
  order), P within rtol 1e-5 + atol 1e-6 (erfc's last bits), bins equal
  except where P lies within ``P_TIE`` of a bin edge (.1, .05, .01);
- Moran's I, E[I] and z within rtol 1e-5; local Moran's I within rtol
  1e-5 + atol 1e-5; rmse within rtol 1e-6;
- exact: the neighbour counts (also against scipy), ``gi_formula``,
  ``gistar_formula``, ``score`` with the same seed (sklearn's formulas),
  ``bdr``, ``bdr_bootstrap`` and ``hungarian_algorithm``;
  ``chamfer_distance`` within rtol 1e-12 of sklearn's KD-tree;
- sharded against the JAX sharded function: the tolerances of
  ``tests/test_dist.py`` (z and P 2e-4, bins on > 99.9%, Moran's rtol
  5e-4, local 2e-4; hillshade off by one on < 0.1%); sharded against the
  port's single-device function: the tolerances above, and
  ``sharded_hillshade`` exactly, also where the mesh does not divide the
  raster (where the JAX package's sharded hillshade does not).
"""

import inspect

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
import jax

import neilpy_tpu as nt
import neilpy_tpu_torch as ntt
from neilpy_tpu.dist import api as japi
from neilpy_tpu_torch import dist as tdist

torch.set_num_threads(1)
CPU = "cpu"
CPU8 = [torch.device("cpu")] * 8
P_TIE = 1e-5
Z_RTOL = Z_ATOL = 1e-5
P_RTOL, P_ATOL = 1e-5, 1e-6
DIST_TOL = 2e-4


def walk(seed, shape, axis=None):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=shape)
    Z = Z.cumsum(axis=0).cumsum(axis=1) if axis is None else Z.cumsum(
        axis=axis)
    return Z.astype(np.float32)


def holed(Z, *cells):
    Z = Z.copy()
    for c in cells:
        Z[c] = np.nan
    return Z


RASTER = holed(walk(12345, (48, 56)), (slice(10, 13), slice(20, 24)),
               (30, 5), (0, 40))
NOISE = np.random.default_rng(8).normal(size=(40, 44)).astype(np.float32)


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(ours, ref, rtol, atol):
    ours, ref = host(ours), host(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


def bins_equal_but_ties(ours, ref, P, margin=P_TIE, share=None):
    """Significance bins equal wherever P is not within ``margin`` of a
    bin edge; with ``share``, equal on at least that share instead."""
    ours, ref, P = host(ours), host(ref), host(P)
    same = (ours == ref) | (np.isnan(ours) & np.isnan(ref))
    if share is not None:
        assert same.mean() >= share
        return
    edge = np.zeros(P.shape, bool)
    for e in (.1, .05, .01):
        edge |= np.abs(P - e) < margin
    assert (same | edge).all()


def gi_pair(X, **kw):
    return nt.rasterGi(X, **kw), ntt.rasterGi(X, **kw, device=CPU)


# ----------------------------------------------------------------------
# Getis-Ord Gi / Gi*
# ----------------------------------------------------------------------
GI_CASES = [dict(footprint=2, star=True), dict(footprint=2, star=False),
            dict(footprint=1, star=True, apply_correction=True),
            dict(footprint=3, star=False, apply_correction=True),
            dict(footprint=nt.disk(3), mode="reflect"),
            dict(footprint=np.pad(np.ones((3, 3)), 1)),
            dict(footprint=np.ones((3, 5)) - np.pad([[1]], ((1, 1), (2, 2)))),
            dict(footprint=2, star=True, global_mean=3.0, global_var=40.0,
                 global_n=5000)]


@pytest.mark.parametrize("raster", ["holes", "noise"])
@pytest.mark.parametrize("case", range(len(GI_CASES)))
def test_rastergi_matches_jax(raster, case):
    X = RASTER if raster == "holes" else NOISE
    (zj, pj, sj), (zt, pt, st) = gi_pair(X, **GI_CASES[case])
    assert zt.dtype == torch.float32 and zt.device.type == "cpu"
    close(zt, zj, Z_RTOL, Z_ATOL)
    close(pt, pj, P_RTOL, P_ATOL)
    bins_equal_but_ties(st, sj, pj)
    vals = np.unique(host(st)[np.isfinite(host(st))])
    assert set(vals) <= {-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0}


@pytest.mark.parametrize("mode", ["nearest", "reflect"])
@pytest.mark.parametrize("radius", [1, 5])
def test_rastergi_neighbour_counts_are_exact(mode, radius):
    """The footprint count of finite cells, rasterGi's w: equal to the
    JAX package's and to scipy's correlation of the finite mask."""
    from neilpy_tpu.ops.surface import binary_footprint_sum as jbfs
    from neilpy_tpu_torch.ops.surface import binary_footprint_sum as tbfs
    fin = np.isfinite(RASTER).astype(np.float32)
    fp = nt.disk(radius)
    ours = host(tbfs(fin, fp, mode=mode, device=CPU))
    np.testing.assert_array_equal(ours, np.asarray(jbfs(fin, fp, mode=mode)))
    np.testing.assert_array_equal(ours, ndi.correlate(fin, fp, mode=mode))


def test_rastergi_nan_propagation_and_generic_filter_oracle():
    """tests/test_stats_viz_aux.py's oracle: the Gi* z of a NaN-holed
    raster from generic_filter sums in float64, within its 2e-4."""
    X = RASTER
    Z, P, sig = ntt.rasterGi(X, footprint=2, star=True, device=CPU)
    assert np.isnan(host(Z))[np.isnan(X)].all()
    assert np.isnan(host(sig))[np.isnan(X)].all()
    fin = np.isfinite(X)
    fp = np.ones((5, 5), bool)
    w = ndi.generic_filter(fin.astype(float), np.sum, footprint=fp,
                           mode="nearest")
    s = ndi.generic_filter(np.where(fin, X, 0.0).astype(float), np.sum,
                           footprint=fp, mode="nearest")
    n = fin.sum()
    a = s - w * np.nanmean(X.astype(float))
    b = np.sqrt((w / (n - 1)) * (n - w) * np.nanstd(X.astype(float)) ** 2)
    np.testing.assert_allclose(host(Z), np.where(fin, a / b, np.nan),
                               atol=2e-4)


# ----------------------------------------------------------------------
# Moran's I, rmse, Shi's landslides
# ----------------------------------------------------------------------
@pytest.mark.parametrize("footprint", [1, 2, "disk3"])
@pytest.mark.parametrize("raster", ["holes", "noise"])
def test_morans_i_matches_jax(footprint, raster):
    X = RASTER if raster == "holes" else NOISE
    fp = nt.disk(3) if footprint == "disk3" else footprint
    ref = nt.morans_i(X, footprint=fp)
    ours = ntt.morans_i(X, footprint=fp, device=CPU)
    for o, r in zip(ours, ref):
        assert o.shape == () and o.dtype == torch.float32
        np.testing.assert_allclose(float(o), float(r), rtol=1e-5)
    if raster == "noise":
        assert abs(float(ours[0])) < 0.1
    else:
        assert float(ours[0]) > 0.5 and float(ours[2]) > 3


@pytest.mark.parametrize("kw", [dict(footprint=2), dict(footprint=nt.disk(2)),
                                dict(footprint=1, mean=2.0, s2=30.0),
                                dict(footprint=2, mode="reflect")])
def test_local_morans_i_matches_jax(kw):
    close(ntt.local_morans_i(RASTER, **kw, device=CPU),
          nt.local_morans_i(RASTER, **kw), 1e-5, 1e-5)


def test_rmse_matches_jax():
    X = np.array([[3.0, 4.0], [np.nan, 0.0]])
    assert float(ntt.rmse(X, device=CPU)) == pytest.approx(np.sqrt(25 / 4))
    np.testing.assert_allclose(float(ntt.rmse(RASTER, device=CPU)),
                               float(nt.rmse(RASTER)), rtol=1e-6)


def test_shi_landslides_matches_jax():
    """Equal to the JAX package except where some radius's Gi* P lies
    within ``P_TIE`` of .01 (the bin ``< -2`` reads)."""
    radii = [2, 3]
    ours = host(ntt.shi_landslides(RASTER, radii, cellsize=2, device=CPU))
    ref = np.asarray(nt.shi_landslides(RASTER, radii, cellsize=2))
    assert ours.dtype == bool and ours.shape == RASTER.shape
    ktan = nt.evans_curvature(RASTER, 2)[3]
    edge = np.zeros(RASTER.shape, bool)
    for r in radii:
        P = np.asarray(nt.rasterGi(ktan, nt.disk(r), star=True)[1])
        edge |= np.abs(P - .01) < P_TIE
    assert ((ours == ref) | edge).all()
    assert ours.any()


# ----------------------------------------------------------------------
# host analytics
# ----------------------------------------------------------------------
def test_gi_formulas_match_jax():
    x = np.array([1.0, 2.0, np.nan, 4.0])
    assert ntt.gi_formula(x, 100, 2.0, 1.5) == nt.gi_formula(x, 100, 2.0, 1.5)
    assert (ntt.gistar_formula(x, 100, 2.0, 1.5)
            == nt.gistar_formula(x, 100, 2.0, 1.5))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("labels", ["01", "12", "02", "bool", "one"])
def test_score_equals_sklearn_with_the_same_seed(seed, labels):
    rng = np.random.default_rng(17)
    a = rng.integers(0, 2, 3000)
    b = a.copy()
    flip = rng.random(3000) < 0.1
    b[flip] = 1 - b[flip]
    if labels in ("12", "02"):
        a, b = a * int(labels[1]) + int(labels[0]), b * int(labels[1]) + int(
            labels[0])
    elif labels == "bool":
        a, b = a.astype(bool), b.astype(bool)
    elif labels == "one":
        a, b = np.ones_like(a), np.ones_like(b)
    mask = rng.random(3000) < 0.8
    for kw in (dict(seed=seed), dict(k=500, mask=mask, seed=seed)):
        if labels == "02":
            with pytest.raises(ValueError, match="pos_label=1"):
                nt.score(a, b, **kw)
            with pytest.raises(ValueError, match="pos_label=1"):
                ntt.score(a, b, **kw)
            continue
        ref = nt.score(a, b, **kw)
        ours = ntt.score(a, b, **kw)
        assert set(ours) == set(ref)
        np.testing.assert_array_equal(ours["confusion_matrix"],
                                      ref["confusion_matrix"])
        for key in ("cohen_kappa_score", "f1_score", "accuracy_score"):
            assert (ours[key] == ref[key]
                    or (np.isnan(ours[key]) and np.isnan(ref[key]))), key


def test_score_refuses_multiclass_as_sklearn():
    a = np.arange(300) % 3
    with pytest.raises(ValueError, match="multiclass"):
        nt.score(a, a[::-1], seed=0)
    with pytest.raises(ValueError, match="multiclass"):
        ntt.score(a, a[::-1], seed=0)


def test_bdr_and_bootstrap_equal_jax():
    rng = np.random.default_rng(21)
    XY = rng.normal(size=(60, 2))
    th = np.deg2rad(30)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    AB = 2.0 * XY @ R.T + np.array([5.0, -3.0]) + rng.normal(
        scale=0.05, size=XY.shape)
    ours, ref = ntt.bdr(XY, AB), nt.bdr(XY, AB)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert ntt.bdr(XY, XY)["rsquare"] == pytest.approx(1.0)
    XYs, ABs = rng.normal(size=(10, 2)), rng.normal(size=(15, 2))
    for o, r in zip(ntt.bdr_bootstrap(XYs, ABs, k=5, seed=0),
                    nt.bdr_bootstrap(XYs, ABs, k=5, seed=0)):
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("metric", ["l2", "euclidean", "l1", "manhattan",
                                    "chebyshev", "infinity"])
@pytest.mark.parametrize("direction", ["bi", "x_to_y", "y_to_x"])
def test_chamfer_distance_matches_sklearn(metric, direction):
    rng = np.random.default_rng(9)
    x, y = rng.normal(size=(50, 2)), rng.normal(size=(70, 2))
    np.testing.assert_allclose(
        ntt.chamfer_distance(x, y, metric=metric, direction=direction),
        nt.chamfer_distance(x, y, metric=metric, direction=direction),
        rtol=1e-12)
    assert ntt.chamfer_distance(x, x) == 0.0


def test_chamfer_distance_refuses_what_it_cannot_compute():
    x = np.zeros((3, 2))
    with pytest.raises(ValueError, match="not supported"):
        ntt.chamfer_distance(x, x, metric="cosine")
    with pytest.raises(ValueError, match="Invalid direction"):
        ntt.chamfer_distance(x, x, direction="both")


def test_hungarian_algorithm_equals_jax():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(40, 2))
    y = x[::-1] + rng.normal(scale=1e-3, size=x.shape)
    for o, r in zip(ntt.hungarian_algorithm(x, y),
                    nt.hungarian_algorithm(x, y)):
        np.testing.assert_array_equal(o, r)


# ----------------------------------------------------------------------
# the sharded forms
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest should force 8 CPU devices"
    return japi.make_mesh()  # 2 x 4


@pytest.fixture(scope="module")
def tmesh():
    return tdist.make_mesh(CPU8)  # 2 x 4


def jitted(fn):
    """A JAX sharded reference, run once under ``jax.jit`` (its inputs
    are closed over: the JAX functions pad them with numpy)."""
    return jax.jit(fn)()


SHARD_RASTER = holed(walk(4, (45, 67), axis=1), (slice(10, 13),
                                                 slice(20, 25)))


@pytest.mark.parametrize("star", [False, True])
@pytest.mark.parametrize("corr", [False, True])
def test_sharded_rastergi_matches_jax_and_single(jmesh, tmesh, star, corr):
    Z = SHARD_RASTER
    kw = dict(footprint=3, star=star, apply_correction=corr)
    zj, pj, sj = (np.asarray(v) for v in jitted(
        lambda: japi.sharded_rastergi(Z, mesh=jmesh, **kw)))
    zt, pt, st = tdist.sharded_rastergi(Z, mesh=tmesh, **kw)
    np.testing.assert_array_equal(np.isnan(host(zt)), np.isnan(zj))
    np.testing.assert_allclose(host(zt), zj, rtol=DIST_TOL, atol=DIST_TOL)
    np.testing.assert_allclose(host(pt), pj, atol=DIST_TOL)
    bins_equal_but_ties(st, sj, pj, share=0.999)
    z1, p1, s1 = ntt.rasterGi(Z, device=CPU, **kw)
    close(zt, z1, Z_RTOL, Z_ATOL)
    close(pt, p1, P_RTOL, P_ATOL)
    bins_equal_but_ties(st, s1, p1)


def test_sharded_rastergi_footprint_array_sets_star(tmesh):
    """An explicit footprint is a mask whose centre decides Gi*, and a
    2 x 2 mesh of a raster it does not divide."""
    Z = SHARD_RASTER
    mesh = tdist.make_mesh(CPU8[:4])
    for fp in (np.ones((5, 5)), np.pad(np.ones((1, 3)), ((1, 1), (0, 0)))):
        zt, pt, st = tdist.sharded_rastergi(Z, footprint=fp, mesh=mesh)
        z1, p1, s1 = ntt.rasterGi(Z, footprint=fp, device=CPU)
        close(zt, z1, Z_RTOL, Z_ATOL)
        bins_equal_but_ties(st, s1, p1)


@pytest.mark.parametrize("footprint", [2, "disk2"])
def test_sharded_morans_i_matches_jax_and_single(jmesh, tmesh, footprint):
    Z = holed(walk(6, (45, 67), axis=1), (slice(12, 15), slice(30, 36)))
    fp = nt.disk(2) if footprint == "disk2" else footprint
    ref = [float(v) for v in jitted(
        lambda: japi.sharded_morans_i(Z, footprint=fp, mesh=jmesh))]
    ours = tdist.sharded_morans_i(Z, footprint=fp, mesh=tmesh)
    np.testing.assert_allclose([float(v) for v in ours], ref, rtol=5e-4,
                               atol=1e-6)
    single = ntt.morans_i(Z, footprint=fp, device=CPU)
    np.testing.assert_allclose([float(v) for v in ours],
                               [float(v) for v in single], rtol=1e-5)


def test_sharded_local_morans_i_matches_jax_and_single(jmesh, tmesh):
    Z = holed(walk(5, (45, 67), axis=0), (slice(5, 8), slice(5, 9)))
    ref = np.asarray(jitted(
        lambda: japi.sharded_local_morans_i(Z, footprint=2, mesh=jmesh)))
    ours = tdist.sharded_local_morans_i(Z, footprint=2, mesh=tmesh)
    np.testing.assert_array_equal(np.isnan(host(ours)), np.isnan(ref))
    np.testing.assert_allclose(host(ours), ref, rtol=DIST_TOL, atol=DIST_TOL)
    close(ours, ntt.local_morans_i(Z, footprint=2, device=CPU), 1e-5, 1e-5)


def test_sharded_hillshade_matches_jax_on_a_divided_raster(jmesh, tmesh):
    """tests/test_dist.py's case: 96 x 128 over 2 x 4, which the JAX
    sharded hillshade gets right."""
    Z = walk(3, (96, 128))
    ref = np.asarray(jitted(lambda: japi.sharded_hillshade(Z, jmesh,
                                                           cellsize=2)))
    ours = host(tdist.sharded_hillshade(Z, tmesh, cellsize=2))
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_array_equal(
        ours, host(ntt.hillshade(Z, cellsize=2, device=CPU)))


# the JAX package's sharded hillshade on 67 x 101 over 2 x 2 (seed 3):
# pixels that differ from its own hillshade, and by how many levels
JAX_FAULT_PIXELS = 86
JAX_FAULT_LEVELS = 253


def test_sharded_hillshade_equals_hillshade_where_the_mesh_does_not_divide():
    """The port's sharded hillshade equals its ``hillshade`` at every
    pixel of a 67 x 101 raster over a 2 x 2 mesh, last row and column
    included.  The JAX package's does not: it pads the mesh remainder
    with zeros (``dist/api.py:417-418``), which the radius-1 'linear'
    halo then reads as the last row's and column's neighbours."""
    Z = walk(3, (67, 101))
    ours = tdist.sharded_hillshade(Z, tdist.make_mesh(CPU8[:4]), cellsize=2)
    single = ntt.hillshade(Z, cellsize=2, device=CPU)
    assert torch.equal(ours, single)
    jmesh22 = japi.make_mesh(jax.devices()[:4], shape=(2, 2))
    ref = np.asarray(jitted(lambda: japi.sharded_hillshade(Z, jmesh22,
                                                           cellsize=2)))
    jsingle = np.asarray(nt.hillshade(Z, cellsize=2))
    bad = ref != jsingle
    rows, cols = np.nonzero(bad)
    assert ((rows == Z.shape[0] - 1) | (cols == Z.shape[1] - 1)).all()
    assert bad.sum() == JAX_FAULT_PIXELS
    assert np.abs(ref.astype(int) - jsingle).max() == JAX_FAULT_LEVELS
    np.testing.assert_array_equal(host(single), jsingle)


@pytest.mark.parametrize("shape,mesh", [((67, 101), (2, 4)),
                                        ((30, 21), (4, 2)),
                                        ((9, 13), (2, 2)),
                                        ((5, 40), (4, 1))])
def test_sharded_hillshade_is_exact_on_other_meshes(shape, mesh):
    """Blocks the raster's last row falls inside, blocks of one or two
    rows, blocks that hold only padding."""
    Z = holed(walk(11, shape), (shape[0] // 2, shape[1] // 3))
    for kw in (dict(cellsize=2), dict(cellsize=10, z_factor=3, zenith=30,
                                      azimuth=100)):
        ours = tdist.sharded_hillshade(Z, tdist.make_mesh(CPU8, shape=mesh),
                                       **kw)
        assert torch.equal(ours, ntt.hillshade(Z, **kw, device=CPU))


# ----------------------------------------------------------------------
# names
# ----------------------------------------------------------------------
STATS_NAMES = ("gi_formula", "gistar_formula", "rasterGi", "morans_i",
               "local_morans_i", "rmse", "score", "shi_landslides", "bdr",
               "chamfer_distance", "hungarian_algorithm", "bdr_bootstrap")
HOST_ONLY = {"gi_formula", "gistar_formula", "score", "bdr",
             "chamfer_distance", "hungarian_algorithm", "bdr_bootstrap"}


@pytest.mark.parametrize("name", STATS_NAMES)
def test_slice_names_match_the_jax_package(name):
    """Every statistics name of ``neilpy_tpu/__init__.py`` is exported by
    the port with the JAX arguments and defaults, in order; every device
    function adds ``device=None`` at the end."""
    ours = inspect.signature(getattr(ntt, name)).parameters
    theirs = inspect.signature(getattr(nt, name)).parameters
    assert list(ours)[:len(theirs)] == list(theirs)
    for p in theirs:
        assert ours[p].default == theirs[p].default, p
    extra = list(ours)[len(theirs):]
    assert extra == ([] if name in HOST_ONLY else ["device"])
    if extra:
        assert ours["device"].default is None


@pytest.mark.parametrize("name", ["sharded_rastergi", "sharded_morans_i",
                                  "sharded_local_morans_i",
                                  "sharded_hillshade"])
def test_sharded_names_match_the_jax_package(name):
    """The sharded functions take the JAX package's arguments exactly
    (the mesh says where they run)."""
    assert name in tdist.__all__
    ours = inspect.signature(getattr(tdist, name)).parameters
    theirs = inspect.signature(getattr(japi, name)).parameters
    assert list(ours) == list(theirs)
    for p in theirs:
        assert ours[p].default == theirs[p].default, p
