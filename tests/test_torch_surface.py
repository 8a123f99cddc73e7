"""The PyTorch port's surface stencils and relief shading
(``neilpy_tpu_torch.ops.surface``, ``neilpy_tpu_torch.viz.shading``) held
against the JAX package on the CPU, from the same seeded numpy rasters,
with and without NaN holes.

Tolerances (each far inside the JAX package's own test of the function
against its oracle, ``tests/test_surface.py`` and
``tests/test_stats_viz_aux.py``):
- float products: ``rtol`` 1e-5 plus the ``atol`` of ``FLOAT_TOL`` (the
  last bits of f32 transcendentals differ between XLA and torch; a
  convolution sums in another order), NaN at the same pixels;
- uint8 products (hillshade, multiple_illumination, pssm, swiss and
  colour-table shading, brassel): equal, except off by one grey level on
  < 0.1% of the pixels;
- exact: ``binary_footprint_sum`` (the same adds in the same order),
  ``corner_lut``, ``swiss_lut``, ``_gray_high_contrast_lut``,
  ``swiss_shading`` where the two hillshades agree, the uint8 cast on
  saturating values and on a NaN-holed DEM, the ``.bin`` copies byte for
  byte; the ``bone`` tables within 1e-12 of matplotlib's.
"""

import inspect
from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
import jax.numpy as jnp

import neilpy_tpu as nt
import neilpy_tpu_torch as ntt
from neilpy_tpu.ops import surface as jsf
from neilpy_tpu.viz import shading as jsh
from neilpy_tpu_torch.core.device import to_uint8
from neilpy_tpu_torch.ops import surface as tsf
from neilpy_tpu_torch.viz import shading as tsh

torch.set_num_threads(1)
CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent

# absolute tolerance per float function, beside rtol 1e-5
FLOAT_TOL = {
    "slope": 1e-5, "esri_slope": 1e-5, "aspect": 1e-4, "curvature": 1e-5,
    "esri_curvature": 1e-5, "zevenbergen_and_thorne_curvature": 1e-6,
    "evans_curvature": 1e-6, "wilson_gallant_curvature": 1e-5,
    "scaled_morphometry": 1e-4, "vip_score": 1e-5,
    # sum of squares minus squared sums: a weighted convolution's other
    # order of adds shows amplified (tests/test_surface.py allows 1e-2)
    "std": 1e-3, "std2": 1e-3, "reduce_peaks": 1e-4,
    "topographic_position_index": 1e-5,
    "convolve2d_nearest": 1e-4, "hillshade_float": 1e-6,
}
RTOL = 1e-5
UINT8_SHARE = 1e-3


def rasters():
    """Two seeded walks (the conftest ``terrain`` recipe in float32), one
    with NaN holes: a block, a single cell, a cell on the edge."""
    rng = np.random.default_rng(12345)
    Z = rng.normal(size=(48, 56)).cumsum(axis=0).cumsum(axis=1)
    Z = Z.astype(np.float32)
    Zh = Z.copy()
    Zh[10:13, 20:24] = np.nan
    Zh[30, 5] = np.nan
    Zh[0, 40] = np.nan
    return {"plain": Z, "holes": Zh}


RASTERS = rasters()


def host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(ours, ref, atol, rtol=RTOL):
    ours, ref = host(ours), host(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


def uint8_close(ours, ref):
    ours, ref = host(ours), host(ref)
    assert ours.dtype == np.uint8 and ref.dtype == np.uint8
    assert ours.shape == ref.shape
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < UINT8_SHARE


# ----------------------------------------------------------------------
# float products
# ----------------------------------------------------------------------
FLOAT_CASES = [
    ("slope", dict(cellsize=2.0)),
    ("slope", dict(cellsize=2.0, z_factor=3, return_as="radians")),
    ("slope", dict(return_as="percent")),
    ("esri_slope", dict(cellsize=2.0)),
    ("esri_slope", dict(cellsize=3, z_factor=2, return_as="percent")),
    ("aspect", {}),
    ("aspect", dict(return_as="radians", flat_as=0)),
    ("curvature", dict(cellsize=2.0)),
    ("vip_score", dict(cellsize=2.0)),
    ("topographic_position_index", dict(radius=1)),
    ("topographic_position_index", dict(radius=3)),
    ("topographic_position_index", dict(radius=3, standardize=False)),
    ("reduce_peaks", dict(radius=4)),
    ("reduce_peaks", dict(radius=3, blend_rate=3, kernel_rate=1)),
]


@pytest.mark.parametrize("raster", sorted(RASTERS))
@pytest.mark.parametrize("name,kw", FLOAT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(FLOAT_CASES)])
def test_float_products_match_jax(raster, name, kw):
    Z = RASTERS[raster]
    ref = getattr(nt, name)(Z, **kw)
    ours = getattr(ntt, name)(Z, **kw, device=CPU)
    assert ours.device.type == "cpu" and ours.dtype == torch.float32
    close(ours, ref, FLOAT_TOL[name])


def test_unsupported_return_as_prints_and_returns_none(capsys):
    assert ntt.slope(RASTERS["plain"], return_as="grads", device=CPU) is None
    assert ntt.aspect(RASTERS["plain"], return_as="percent",
                      device=CPU) is None
    assert "is not supported" in capsys.readouterr().out


@pytest.mark.parametrize("raster", sorted(RASTERS))
@pytest.mark.parametrize("name", ["esri_curvature",
                                  "zevenbergen_and_thorne_curvature",
                                  "evans_curvature",
                                  "wilson_gallant_curvature"])
def test_curvature_families_match_jax(raster, name):
    """Every output of each family, with the reference's NaN fills and
    verbatim formulas (W&G's unshifted Z7/Z8 and ``/ 4*H**2``, Z&T's
    ``D*E**2``)."""
    Z = RASTERS[raster]
    for L in (1, 2.5):
        ref = getattr(nt, name)(Z, cellsize=L)
        ours = getattr(ntt, name)(Z, cellsize=L, device=CPU)
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            close(o, r, FLOAT_TOL[name])


def test_curvature_smoke_value():
    """tests/test_surface.py's oracle: K_tan ~ .86 at the centre."""
    X = np.array([[2.0, 4, 6], [3, 6, 9], [1, 2, 4]])
    K_tan = ntt.zevenbergen_and_thorne_curvature(X, device=CPU)[3]
    assert abs(float(K_tan[1, 1]) - 0.86) < 0.005


@pytest.mark.parametrize("raster", sorted(RASTERS))
@pytest.mark.parametrize("lookup", [1, 3, 7])
def test_scaled_morphometry_matches_jax(raster, lookup):
    Z = RASTERS[raster]
    ref = nt.scaled_morphometry(Z, cellsize=2, lookup_pixels=lookup)
    ours = ntt.scaled_morphometry(Z, cellsize=2, lookup_pixels=lookup,
                                  device=CPU)
    assert set(ours) == set(ref)
    for k in ref:
        close(ours[k], ref[k], FLOAT_TOL["scaled_morphometry"])


@pytest.mark.parametrize("raster", sorted(RASTERS))
@pytest.mark.parametrize("strel", ["box", "disk", "weighted"])
def test_std_and_std2_match_jax(raster, strel):
    """Uniform footprints take the run-decomposed sum, a weighted one
    the TF32-free convolution."""
    s = {"box": np.ones((5, 5)), "disk": nt.disk(3).astype(float),
         "weighted": nt.distance_kernel(3, method="distance") + 1.0}[strel]
    Z = RASTERS[raster]
    close(ntt.std(Z, s, device=CPU), nt.std(Z, s), FLOAT_TOL["std"])
    close(ntt.std2(Z, s, device=CPU), nt.std2(Z, s), FLOAT_TOL["std2"])


@pytest.mark.parametrize("mode", ["nearest", "reflect"])
def test_convolve2d_nearest_matches_jax_and_scipy(mode):
    Z = RASTERS["plain"]
    k = np.random.default_rng(2).normal(size=(5, 7))
    ours = tsf.convolve2d_nearest(Z, k, mode=mode, device=CPU)
    close(ours, jsf.convolve2d_nearest(Z, k, mode=mode),
          FLOAT_TOL["convolve2d_nearest"])
    ref = ndi.convolve(Z.astype(np.float64), k, mode=mode)
    np.testing.assert_allclose(host(ours), ref, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="unsupported mode"):
        tsf.convolve2d_nearest(Z, k, mode="wrap", device=CPU)


def test_triangle_height_and_z_factor_match_jax():
    rng = np.random.default_rng(7)
    h0, h1 = rng.normal(size=(2, 9, 11)).astype(np.float32)
    close(ntt.triangle_height(h0, h1, 1.5, device=CPU),
          nt.triangle_height(h0, h1, 1.5), 1e-6)
    lat = np.array([0.0, 30.0, 45.0, 60.0])
    close(ntt.z_factor(lat, device=CPU), nt.z_factor(lat), 0)
    z0 = ntt.z_factor(30.0, device=CPU)
    assert z0.shape == () and float(z0) == float(nt.z_factor(30.0))


def test_hillshade_float_matches_jax():
    for Z in RASTERS.values():
        close(ntt.hillshade(Z, cellsize=2, return_uint8=False, device=CPU),
              nt.hillshade(Z, cellsize=2, return_uint8=False),
              FLOAT_TOL["hillshade_float"])


# ----------------------------------------------------------------------
# binary_footprint_sum: the same adds in the same order
# ----------------------------------------------------------------------
FOOTPRINTS = {"disk3": nt.disk(3), "box5x7": np.ones((5, 7)),
              "ring": np.asarray(nt.disk(4)) ^ np.pad(np.asarray(nt.disk(2)),
                                                      2),
              "asymmetric": np.array([[0, 0, 0, 1, 1], [0, 1, 0, 0, 0],
                                      [1, 0, 0, 0, 0]], bool),
              "empty": np.zeros((3, 3))}


@pytest.mark.parametrize("mode", ["nearest", "reflect"])
@pytest.mark.parametrize("fp", sorted(FOOTPRINTS))
def test_binary_footprint_sum_equals_jax(fp, mode):
    """Binary input (the rasterGi neighbour counts) and float input both
    equal the JAX package bit for bit; the counts also equal scipy's
    generic_filter sum."""
    Z = RASTERS["holes"]
    footprint = FOOTPRINTS[fp]
    finite = np.isfinite(Z).astype(np.float32)
    counts = tsf.binary_footprint_sum(finite, footprint, mode=mode,
                                      device=CPU)
    np.testing.assert_array_equal(
        host(counts), np.asarray(jsf.binary_footprint_sum(finite, footprint,
                                                          mode=mode)))
    if np.any(footprint):
        np.testing.assert_array_equal(host(counts), ndi.generic_filter(
            finite, np.sum, footprint=footprint != 0, mode=mode))
    vals = np.where(np.isfinite(Z), Z, 0.0)
    np.testing.assert_array_equal(
        host(tsf.binary_footprint_sum(vals, footprint, mode=mode,
                                      device=CPU)),
        np.asarray(jsf.binary_footprint_sum(vals, footprint, mode=mode)))


# ----------------------------------------------------------------------
# uint8 products and the cast
# ----------------------------------------------------------------------
def test_uint8_cast_saturates_as_jax():
    vals = np.array([np.nan, -3, 0.4999, 254.6, 300, np.inf, -np.inf,
                     -0.7, 255.9], np.float32)
    want = np.asarray(jnp.asarray(vals).astype(jnp.uint8))
    np.testing.assert_array_equal(host(to_uint8(torch.from_numpy(vals))),
                                  want)
    np.testing.assert_array_equal(want, [0, 0, 0, 254, 255, 255, 0, 0, 255])


UINT8_CASES = [
    ("hillshade", dict(cellsize=2.0)),
    ("hillshade", dict(cellsize=10, z_factor=3, zenith=30, azimuth=100)),
    ("multiple_illumination", {}),
    ("multiple_illumination", dict(zeniths=np.array([30, 60]), azimuths=6)),
    ("multiple_illumination", dict(zeniths=2, azimuths=3)),
    ("pssm", dict(apply_colormap=False)),
    ("pssm", dict(cellsize=3, ve=1.5, apply_colormap=False)),
    ("swiss_shading", dict(cellsize=2)),
    ("colortable_shade", dict(name="gray_high_contrast")),
    ("colortable_shade", dict(name="gray")),
    ("colortable_shade", dict(name="bare_earth_dark", cellsize=3)),
]


@pytest.mark.parametrize("raster", sorted(RASTERS))
@pytest.mark.parametrize("name,kw", UINT8_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(UINT8_CASES)])
def test_uint8_products_match_jax(raster, name, kw):
    Z = RASTERS[raster]
    uint8_close(getattr(ntt, name)(Z, **kw, device=CPU),
                getattr(nt, name)(Z, **kw))


@pytest.mark.parametrize("raster", sorted(RASTERS))
def test_brassel_matches_jax(raster):
    Z = RASTERS[raster]
    H = np.asarray(nt.hillshade(Z))
    for kw in (dict(k=2), dict(k=3, flat=120, reverse=True),
               dict(k=2, C2=0.2), dict(k=1.5, Zmid=float(np.nanmean(Z)))):
        uint8_close(ntt.brassel_atmospheric_perspective(H, Z, **kw,
                                                        device=CPU),
                    nt.brassel_atmospheric_perspective(H, Z, **kw))
    Hf = H / 255.0
    close(ntt.brassel_atmospheric_perspective(Hf, Z, 2, device=CPU),
          nt.brassel_atmospheric_perspective(Hf, Z, 2), 1e-6)
    with pytest.raises(ValueError, match="k must be"):
        ntt.brassel_atmospheric_perspective(H, Z, 0.5, device=CPU)


def f64_pre_round(Z, name):
    """The value a uint8 product rounds, in float64 (numpy), from the
    JAX package's formulas: where it lies within ``TIE`` of a .5 the two
    frameworks' last-bit differences in atan/exp may round it either
    way."""
    Z = Z.astype(np.float64)
    gy, gx = np.gradient(Z)
    S = np.arctan(np.hypot(gx, gy))
    if name == "pssm":
        return 255 * np.rad2deg(np.arctan(2.3 * np.hypot(gx, gy))) / 90
    A = np.pi / 2 - np.arctan2(gy, -gx)
    A = np.where(A < 0, A + 2 * np.pi, A)
    A = np.where((gx == 0) & (gy == 0), 0, A)
    zen, azi = np.deg2rad(45), np.deg2rad(315)
    H = np.cos(zen) * np.cos(S) + np.sin(zen) * np.sin(S) * np.cos(azi - A)
    H = 255 * np.where(H < 0, 0, H)
    if name == "hillshade":
        return H
    lo, hi = np.nanmin(Z), np.nanmax(Z)
    if name == "swiss":     # a tie of either index moves the gather
        zn = 255 * (Z - lo) / (hi - lo)
        return np.where(tie(zn), zn, H)
    Hn = np.round(H) / 255          # brassel of the hillshade, k = 2
    Zs = (Z - (hi + lo) / 2) / ((hi - lo) / 2)
    return 255 * np.clip((Hn - 180 / 255) * 2.0 ** Zs + 180 / 255, 0, 1)


TIE = 1e-3


def tie(v):
    return np.abs(v - np.floor(v) - 0.5) < TIE


def test_nan_holed_dem_reproduces_jax_exactly():
    """On a NaN-holed DEM the JAX package gives 0 for hillshade and pssm
    where the gradient reads the hole and ``swiss_lut()[0, 0]`` for swiss
    shading: the port gives the same there, and equals the JAX package's
    hillshade, pssm, swiss shading and brassel at every pixel but an f32
    rounding tie (a value within 1e-3 of .5 in float64, which an ulp of
    atan rounds either way)."""
    Z = RASTERS["holes"]
    # where a gradient reads a NaN (a lone NaN cell's own central
    # differences skip it, so its shade is finite)
    hole = np.isnan(f64_pre_round(Z, "hillshade"))
    assert hole.sum() >= np.isnan(Z[10:13, 20:24]).sum()
    Hj = np.asarray(nt.hillshade(Z))
    products = {
        "hillshade": (ntt.hillshade(Z, device=CPU), Hj),
        "pssm": (ntt.pssm(Z, apply_colormap=False, device=CPU),
                 nt.pssm(Z, apply_colormap=False)),
        "swiss": (ntt.swiss_shading(Z, device=CPU), nt.swiss_shading(Z)),
        "brassel": (ntt.brassel_atmospheric_perspective(Hj, Z, 2,
                                                        device=CPU),
                    nt.brassel_atmospheric_perspective(Hj, Z, 2)),
    }
    ties = 0
    for name, (ours, ref) in products.items():
        ours, ref = host(ours), np.asarray(ref)
        differ = ours != ref
        if differ.ndim == 3:
            differ = differ.any(axis=2)
        assert not differ[hole].any(), name
        pre = f64_pre_round(Z, name)
        assert tie(pre[differ]).all(), (name, np.argwhere(differ))
        ties += int(differ.sum())
    assert ties <= 2
    assert (host(products["hillshade"][0])[hole] == 0).all()
    assert (host(products["pssm"][0])[hole] == 0).all()
    dark = hole & np.isnan(Z)   # both indices 0
    assert dark.sum() >= 12
    assert (host(products["swiss"][0])[dark] == ntt.swiss_lut()[0, 0]).all()


def test_all_nan_raster_shades_as_jax():
    """nanmin/nanmax of an all-NaN raster are NaN, not an error."""
    Z = np.full((6, 7), np.nan, np.float32)
    np.testing.assert_array_equal(host(ntt.swiss_shading(Z, device=CPU)),
                                  np.asarray(nt.swiss_shading(Z)))


@pytest.mark.parametrize("raster", sorted(RASTERS))
def test_swiss_shading_exact_on_the_same_hillshade(raster):
    """Where the two packages' hillshades agree, swiss shading is the
    same gather of the same table: exact."""
    Z = RASTERS[raster]
    same = host(ntt.hillshade(Z, device=CPU)) == np.asarray(nt.hillshade(Z))
    assert same.mean() > 1 - UINT8_SHARE
    ours = host(ntt.swiss_shading(Z, device=CPU))
    np.testing.assert_array_equal(ours[same],
                                  np.asarray(nt.swiss_shading(Z))[same])
    lut = np.asarray(nt.corner_lut(jsh.CORNER_SPECS["swiss_green"]))
    ours = host(ntt.swiss_shading(Z, lut=lut, device=CPU))
    ref = np.asarray(nt.swiss_shading(Z, lut=lut))
    np.testing.assert_array_equal(ours[same], ref[same])


def test_lut_shade_takes_a_png_and_a_gray_table(tmp_path):
    """A PNG LUT reads as ``round(255 * plt.imread)`` (PIL here), a 2-D
    table stacks to three channels."""
    from PIL import Image
    Z = RASTERS["plain"]
    lut = ntt.corner_lut(jsh.CORNER_SPECS["swiss_dark"])
    for img, fn in ((Image.fromarray(lut), "rgb.png"),
                    (Image.fromarray(lut[:, :, 0]), "gray.png"),
                    (Image.fromarray(lut).convert("RGBA"), "rgba.png"),
                    (Image.fromarray(lut).quantize(64), "pal.png")):
        path = str(tmp_path / fn)
        img.save(path)
        np.testing.assert_array_equal(tsh._load_lut(path),
                                      jsh._load_lut(path))
        np.testing.assert_array_equal(
            host(ntt.swiss_shading(Z, lut=path, device=CPU)),
            np.asarray(nt.swiss_shading(Z, lut=path)))
    gray = lut[:, :, 1]
    np.testing.assert_array_equal(
        host(ntt.lut_shade(Z, tsh._load_lut(gray), device=CPU)),
        np.asarray(nt.lut_shade(Z, jsh._load_lut(gray))))
    with pytest.raises(ValueError, match="unknown colortable"):
        ntt.colortable_shade(Z, name="nope", device=CPU)


# ----------------------------------------------------------------------
# tables and files
# ----------------------------------------------------------------------
def test_lut_tables_equal_jax_exactly():
    for name, spec in jsh.CORNER_SPECS.items():
        np.testing.assert_array_equal(ntt.corner_lut(spec),
                                      nt.corner_lut(spec), err_msg=name)
    np.testing.assert_array_equal(tsh._cubic_zoom_weights(),
                                  jsh._cubic_zoom_weights())
    np.testing.assert_array_equal(ntt.swiss_lut(), nt.swiss_lut())
    np.testing.assert_array_equal(tsh._gray_high_contrast_lut(),
                                  jsh._gray_high_contrast_lut())
    assert tsh.CORNER_SPECS == jsh.CORNER_SPECS
    lut = ntt.swiss_lut()
    with pytest.raises(ValueError):
        lut[0, 0, 0] = 0


@pytest.mark.parametrize("name", ["_swiss_lut_residual.bin",
                                  "_gray_hc_lut.bin"])
def test_lut_files_are_byte_copies(name):
    ours = (REPO / "neilpy_tpu_torch" / "viz" / name).read_bytes()
    assert ours == (REPO / "neilpy_tpu" / "viz" / name).read_bytes()


@pytest.mark.parametrize("reverse", [False, True])
def test_bone_table_equals_matplotlib(reverse):
    mpl = pytest.importorskip("matplotlib")
    cmap = mpl.colormaps["bone_r" if reverse else "bone"]
    want = cmap(np.arange(256, dtype=np.uint8))
    np.testing.assert_allclose(tsf.bone_table(reverse), want, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("raster", sorted(RASTERS))
@pytest.mark.parametrize("reverse", [False, True])
def test_pssm_colormap_matches_jax(raster, reverse):
    Z = RASTERS[raster]
    ours = ntt.pssm(Z, reverse=reverse, device=CPU)
    ref = nt.pssm(Z, reverse=reverse)
    assert ours.dtype == torch.float64 and ours.shape == Z.shape + (4,)
    same = host(ntt.pssm(Z, reverse=reverse, apply_colormap=False,
                         device=CPU)) == np.asarray(
        nt.pssm(Z, reverse=reverse, apply_colormap=False))
    assert same.mean() > 1 - UINT8_SHARE
    np.testing.assert_allclose(host(ours)[same], ref[same], rtol=0,
                               atol=1e-12)


# ----------------------------------------------------------------------
# devices and names
# ----------------------------------------------------------------------
def test_numpy_input_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ntt.hillshade(RASTERS["plain"])
    H = ntt.hillshade(torch.from_numpy(RASTERS["plain"]))  # a CPU tensor
    assert H.device.type == "cpu" and H.dtype == torch.uint8


SURFACE_NAMES = ("esri_slope", "slope", "aspect", "curvature",
                 "esri_curvature", "zevenbergen_and_thorne_curvature",
                 "evans_curvature", "wilson_gallant_curvature", "hillshade",
                 "multiple_illumination", "pssm", "z_factor",
                 "triangle_height", "vip_score", "std", "std2",
                 "reduce_peaks", "topographic_position_index",
                 "scaled_morphometry", "swiss_shading", "colortable_shade",
                 "swiss_lut", "brassel_atmospheric_perspective",
                 "corner_lut", "lut_shade")
HOST_ONLY = {"swiss_lut", "corner_lut"}


@pytest.mark.parametrize("name", SURFACE_NAMES)
def test_slice_names_match_the_jax_package(name):
    """Every surface and visualization name of ``neilpy_tpu/__init__.py``
    is exported by the port with the JAX arguments and defaults, in
    order; every device function adds ``device=None`` at the end."""
    ours = inspect.signature(getattr(ntt, name)).parameters
    theirs = inspect.signature(getattr(nt, name)).parameters
    assert list(ours)[:len(theirs)] == list(theirs)
    for p in theirs:
        assert np.array_equal(ours[p].default, theirs[p].default), p
    extra = list(ours)[len(theirs):]
    assert extra == ([] if name in HOST_ONLY else ["device"])
    if extra:
        assert ours["device"].default is None


@pytest.mark.parametrize("name", ["convolve2d_nearest",
                                  "binary_footprint_sum"])
def test_module_helpers_match_the_jax_package(name):
    ours = inspect.signature(getattr(tsf, name)).parameters
    theirs = inspect.signature(getattr(jsf, name)).parameters
    assert list(ours) == list(theirs) + ["device"]
