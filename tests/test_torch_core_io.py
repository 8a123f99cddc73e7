"""The PyTorch port's constant tables, shift primitive and GeoTIFF I/O
(``neilpy_tpu_torch``) held equal to the JAX package's, element for
element, and GeoTIFFs written by either package read back in the other."""

import numpy as np
import pytest
import torch

import neilpy_tpu
import neilpy_tpu_torch
from neilpy_tpu.core import codes as jcodes
from neilpy_tpu.core import shift as jshift
from neilpy_tpu_torch.core import codes as tcodes
from neilpy_tpu_torch.core import shift as tshift

torch.set_num_threads(1)


def test_offsets_and_step_length():
    assert tshift.OFFSETS == jshift.OFFSETS
    assert tshift.STEP_LENGTH == jshift.STEP_LENGTH


def test_jasiewicz_stepinski_table():
    t = tcodes.jasiewicz_stepinski_table()
    j = jcodes.jasiewicz_stepinski_table()
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("percent", [10, 20, 35])
def test_progressive_window(percent):
    for R in range(1, 121):
        t = tcodes.progressive_window(1, R, percent)
        j = jcodes.progressive_window(1, R, percent)
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


def test_lowest_equivalent_table():
    np.testing.assert_array_equal(tcodes.lowest_equivalent_table(),
                                  jcodes.lowest_equivalent_table())


@pytest.mark.parametrize("method", ["loose", "strict"])
def test_terrain_code_tables(method):
    codes = np.arange(3 ** 8)
    np.testing.assert_array_equal(
        tcodes.terrain_code_to_geomorphon(codes, method),
        jcodes.terrain_code_to_geomorphon(codes, method))


def test_code_helpers_and_cmap():
    for x in (0, 1, 160, 2240, 6560):
        assert tcodes.int2base(x, 3) == jcodes.int2base(x, 3)
        assert (tcodes.get_lowest_equivalent(x)
                == jcodes.get_lowest_equivalent(x))
    assert tcodes.geomorphon_cmap() == jcodes.geomorphon_cmap()


@pytest.mark.parametrize("n", [1, 3, 50])
@pytest.mark.parametrize("direction", list(range(10)))
def test_ashift(direction, n):
    """All 8 directions plus the fall-through directions 8 and 9, which
    return the raster unchanged."""
    Z = np.random.default_rng(4).normal(size=(23, 31)).astype(np.float32)
    ours = tshift.ashift(torch.from_numpy(Z), direction, n).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jshift.ashift(Z, direction, n)))


def test_affine_matches():
    a_t = neilpy_tpu_torch.from_origin(500000.0, 4200000.0, 2.5, 2.5)
    a_j = neilpy_tpu.from_origin(500000.0, 4200000.0, 2.5, 2.5)
    assert tuple(a_t) == tuple(a_j)
    assert tuple(~a_t) == tuple(~a_j)
    assert a_t * (3, 7) == a_j * (3, 7)


def _dem(seed, dtype=np.float32):
    Z = np.random.default_rng(seed).normal(size=(37, 53)).cumsum(axis=0)
    Z = (Z * 10 + 300).astype(dtype)
    Z[5:8, 10:14] = -9999.0
    return Z


WRITERS = {"jax": neilpy_tpu.write_geotiff,
           "torch": neilpy_tpu_torch.write_geotiff}
READERS = {"jax": neilpy_tpu.imread, "torch": neilpy_tpu_torch.imread}


@pytest.mark.parametrize("compress", ["none", "deflate"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_geotiff_round_trip_between_packages(tmp_path, writer, reader,
                                             compress):
    Z = _dem(1)
    transform = neilpy_tpu.from_origin(612000.0, 4700000.0, 2.0, 2.0)
    fn = str(tmp_path / "dem.tif")
    WRITERS[writer](fn, Z, transform=transform, crs=26918, nodata=-9999.0,
                    compress=compress)
    back, meta = READERS[reader](fn)
    _, meta_ref = READERS[writer](fn)
    np.testing.assert_array_equal(back, Z)
    assert back.dtype == Z.dtype
    assert tuple(meta["transform"]) == tuple(transform)
    assert meta["cellsize"] == 2.0
    assert meta["nodata"] == -9999.0
    assert meta["crs"] == 26918
    for key in ("width", "height", "count", "dtype", "bounds", "cellsize",
                "nodata", "crs"):
        assert meta[key] == meta_ref[key], key


def test_geotiff_write_tensor_and_classes(tmp_path):
    G = torch.from_numpy(
        np.random.default_rng(2).integers(1, 11, size=(19, 27)).astype(
            np.uint8))
    fn = str(tmp_path / "classes.tif")
    neilpy_tpu_torch.imwrite(fn, G, colormap=neilpy_tpu_torch.geomorphon_cmap())
    np.testing.assert_array_equal(neilpy_tpu.imread(fn)[0], G.numpy())


def test_worldfile_matches(tmp_path):
    a = neilpy_tpu.from_origin(612000.0, 4700000.0, 2.0, 2.0)
    neilpy_tpu_torch.write_worldfile(a, str(tmp_path / "t.pgw"))
    neilpy_tpu.write_worldfile(a, str(tmp_path / "j.pgw"))
    assert ((tmp_path / "t.pgw").read_text()
            == (tmp_path / "j.pgw").read_text())


def test_gradient2d_matches_jax():
    Z = np.random.default_rng(12345).normal(size=(48, 56)).cumsum(
        axis=0).cumsum(axis=1).astype(np.float32)
    for spacing in (1.0, 2.5):
        ours = tshift.gradient2d(torch.from_numpy(Z), spacing)
        ref = jshift.gradient2d(Z, spacing)
        for a, b in zip(ours, ref):
            assert a.dtype == torch.float32 and tuple(a.shape) == Z.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("pad", [1, (2, 3), ((0, 5), (7, 1)), 9])
def test_pad_edge_and_reflect_match_jax(pad):
    Z = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    np.testing.assert_array_equal(tshift.pad_edge(torch.from_numpy(Z),
                                                  pad).numpy(),
                                  np.asarray(jshift.pad_edge(Z, pad)))
    np.testing.assert_array_equal(tshift.pad_reflect(torch.from_numpy(Z),
                                                     pad).numpy(),
                                  np.asarray(jshift.pad_reflect(Z, pad)))
