"""The PyTorch port's geomorphon path (``neilpy_tpu_torch``) held against
the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side runs as its own tests run it: the Pallas counts kernel in
interpret mode (``tile=(64, 64)``) and the XLA path.  Counts and classes
must be equal exactly: the port follows the Pallas kernel's arithmetic
step for step (``neilpy_tpu_torch/ops/cuda_scan.py``).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import neilpy_tpu
import neilpy_tpu_torch
from neilpy_tpu.ops.pallas_scan import (openness_counts_pallas,
                                        geomorphons_pallas)
from neilpy_tpu.ops.visibility import count_openness as jax_count_openness
from neilpy_tpu.ops.visibility import geomorphons as jax_geomorphons
from neilpy_tpu_torch.ops import cuda_scan
from neilpy_tpu_torch.ops.visibility import (count_openness, geomorphons,
                                             classes_from_counts)

from .reference_impls import np_geomorphons

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def Z():
    r = np.random.default_rng(7)
    return r.normal(size=(100, 140)).cumsum(axis=0).cumsum(axis=1).astype(
        np.float32)


def port_classes(Z, **kw):
    return geomorphons(Z, device="cpu", **kw).numpy()


@pytest.mark.parametrize("threshold", [0.0, 1.0, 5.0])
def test_counts_match_pallas_and_xla(Z, threshold):
    np_t, nn_t = count_openness(Z, 2.0, 7, threshold, device="cpu")
    np_p, nn_p = openness_counts_pallas(Z, cellsize=2.0, lookup_pixels=7,
                                        threshold_angle=threshold,
                                        tile=(64, 64))
    np_x, nn_x = jax_count_openness(Z, 2.0, 7, threshold)
    assert np_t.dtype == torch.uint8 and nn_t.dtype == torch.uint8
    for ours, pallas, xla in ((np_t, np_p, np_x), (nn_t, nn_p, nn_x)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(pallas))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(xla))


@pytest.mark.parametrize("lookup", [1, 5, 13])
def test_classes_match_pallas_and_xla(Z, lookup):
    G = port_classes(Z, cellsize=2.0, lookup_pixels=lookup)
    np.testing.assert_array_equal(
        G, np.asarray(geomorphons_pallas(Z, cellsize=2.0,
                                         lookup_pixels=lookup,
                                         tile=(64, 64))))
    np.testing.assert_array_equal(
        G, np.asarray(jax_geomorphons(Z, cellsize=2.0,
                                      lookup_pixels=lookup)))


def test_nan_terrain(Z):
    Zn = Z.copy()
    Zn[30:40, 50:70] = np.nan
    G = port_classes(Zn, lookup_pixels=5)
    np.testing.assert_array_equal(
        G, np.asarray(geomorphons_pallas(Zn, lookup_pixels=5,
                                         tile=(64, 64))))
    np.testing.assert_array_equal(
        G, np.asarray(jax_geomorphons(Zn, lookup_pixels=5)))


@pytest.mark.parametrize("lookup", [7, 23])
def test_fast_ladder(Z, lookup):
    """The progressive ladder ends below R (R=7 -> Rmax=6): the
    out-of-range epilogue must test Rmax, as the JAX package does."""
    G = port_classes(Z, cellsize=2.0, lookup_pixels=lookup, fast=True)
    np.testing.assert_array_equal(
        G, np.asarray(geomorphons_pallas(Z, cellsize=2.0,
                                         lookup_pixels=lookup, fast=True,
                                         tile=(64, 64))))
    np.testing.assert_array_equal(
        G, np.asarray(jax_geomorphons(Z, cellsize=2.0, lookup_pixels=lookup,
                                      fast=True, engine="xla")))


def test_nan_hole_640():
    rng = np.random.default_rng(5)
    Z = rng.normal(size=(640, 640)).cumsum(axis=0).astype(np.float32)
    Z[200:210, 300:320] = np.nan
    G = port_classes(Z, cellsize=2, lookup_pixels=2)
    np.testing.assert_array_equal(
        G, np.asarray(geomorphons_pallas(Z, cellsize=2, lookup_pixels=2,
                                         tile=(64, 128))))
    np.testing.assert_array_equal(
        G, np.asarray(jax_geomorphons(Z, cellsize=2, lookup_pixels=2,
                                      engine="xla")))


@pytest.mark.parametrize("fast", [False, True])
def test_lookup_exceeding_raster(fast):
    """lookup_pixels=100 on a 24x32 raster: every ray leaves the raster
    first, for both ladders."""
    Z = np.random.default_rng(12).normal(size=(24, 32)).astype(
        np.float32).cumsum(axis=0)
    G = port_classes(Z, cellsize=1, lookup_pixels=100, threshold_angle=1,
                     fast=fast)
    np.testing.assert_array_equal(
        G, np.asarray(geomorphons_pallas(Z, cellsize=1, lookup_pixels=100,
                                         threshold_angle=1, fast=fast)))
    np.testing.assert_array_equal(
        G, np.asarray(jax_geomorphons(Z, cellsize=1, lookup_pixels=100,
                                      threshold_angle=1, engine="xla",
                                      fast=fast)))
    ref = np_geomorphons(Z.astype(np.float64), cellsize=1,
                         lookup_pixels=100, threshold_angle=1, fast=fast)
    np.testing.assert_array_equal(G, ref)


@pytest.mark.parametrize("Zm,code", [
    ([[1, 1, 1], [1, 2, 1], [1, 1, 1]], 2),    # peak
    ([[0, 0, 0], [2, 1, 2], [2, 2, 2]], 7),    # hollow
    ([[1, 1, 1], [1, 0, 1], [1, 1, 1]], 10),   # pit
    ([[0, 0, 0], [1, 1, 1], [2, 2, 2]], 6),    # slope
    ([[0, 1, 2], [2, 1, 0], [0, 1, 2]], 6),    # complex slope
    ([[1, 1, 1], [1, 1, 1], [1, 1, 1]], 1),    # flat
])
def test_micro_morphologies(Zm, code):
    Zm = np.array(Zm, dtype=float)
    G = port_classes(Zm, lookup_pixels=1)
    assert G[1, 1] == code
    np.testing.assert_array_equal(
        G, np.asarray(jax_geomorphons(Zm, lookup_pixels=1, engine="xla")))


def test_enhance_matches_xla(terrain):
    G = port_classes(terrain, lookup_pixels=20, enhance=True)
    np.testing.assert_array_equal(
        G, np.asarray(jax_geomorphons(terrain, lookup_pixels=20,
                                      enhance=True, engine="xla")))
    assert set(np.unique(G)) <= set(range(1, 11))


def test_geotiff_to_classes_slice(tmp_path):
    """The README's main path end to end: a DEM written by the JAX
    package, read by the port, classified by the port on the CPU —
    equal to the JAX package on the same file."""
    rng = np.random.default_rng(21)
    Z = (rng.normal(size=(90, 120)).cumsum(axis=0).cumsum(axis=1)
         + 500.0).astype(np.float32)
    fn = str(tmp_path / "dem.tif")
    neilpy_tpu.write_geotiff(
        fn, Z, transform=neilpy_tpu.from_origin(500000.0, 4200000.0, 10, 10),
        crs=32618, nodata=-9999.0)
    Zt, meta = neilpy_tpu_torch.imread(fn)
    G = neilpy_tpu_torch.geomorphons(Zt, cellsize=meta["cellsize"],
                                     lookup_pixels=20, device="cpu")
    Zj, meta_j = neilpy_tpu.imread(fn)
    G_j = neilpy_tpu.geomorphons(Zj, cellsize=meta_j["cellsize"],
                                 lookup_pixels=20)
    assert meta["cellsize"] == 10.0
    assert G.dtype == torch.uint8 and G.device.type == "cpu"
    np.testing.assert_array_equal(G.numpy(), np.asarray(G_j))
    out = str(tmp_path / "classes.tif")
    neilpy_tpu_torch.imwrite(out, G, meta,
                             colormap=neilpy_tpu_torch.geomorphon_cmap())
    back, meta_b = neilpy_tpu.imread(out)
    np.testing.assert_array_equal(back, G.numpy())
    assert tuple(meta_b["transform"]) == tuple(meta["transform"])


def test_engine_cuda_on_cpu_tensor_raises(Z):
    Zt = torch.from_numpy(Z)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_scan.openness_counts(Zt, lookup_pixels=3, engine="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        geomorphons(Zt, lookup_pixels=3, engine="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_scan.geomorphons_cuda(Zt, lookup_pixels=3)
    with pytest.raises(ValueError, match="engine"):
        cuda_scan.openness_counts(Zt, lookup_pixels=3, engine="xla")


def test_numpy_input_without_cuda_raises(Z, monkeypatch):
    """Numpy input defaults to the CUDA device; without one the call
    raises instead of running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        geomorphons(Z, lookup_pixels=3)


def test_cpu_path_launches_no_kernel(Z):
    before = cuda_scan.openness_counts_cuda.launches
    geomorphons(torch.from_numpy(Z), lookup_pixels=3)
    assert cuda_scan.openness_counts_cuda.launches == before


def test_ladder_and_scales():
    assert cuda_scan._ladder(7, fast=True) == (1, 2, 3, 4, 5, 6)
    assert cuda_scan._ladder(4) == (1, 2, 3, 4)
    with pytest.raises(ValueError):
        cuda_scan._ladder(0)
    s = cuda_scan._ladder_scales(2.5, (1, 3, 50))
    assert s.shape == (8, 3) and s.dtype == np.float32
    w = np.float32(1 / (2.5 * 2 ** 0.5))
    assert s[0, 1] == w / np.float32(3)


def test_classes_from_counts_is_the_table():
    from neilpy_tpu_torch.core.codes import jasiewicz_stepinski_table
    p, n = np.meshgrid(np.arange(9), np.arange(9), indexing="ij")
    G = classes_from_counts(torch.from_numpy(p.astype(np.uint8)),
                            torch.from_numpy(n.astype(np.uint8)))
    np.testing.assert_array_equal(G.numpy(), jasiewicz_stepinski_table())


def test_build_is_keyed_by_sources_and_raises_without_nvcc(tmp_path,
                                                           monkeypatch):
    from neilpy_tpu_torch import _build
    assert _build.library_path().parent == REPO / "build" / "neilpy_tpu_torch"
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "SOURCE_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path()
    src.write_text("// two\n")
    assert _build.library_path() != first
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_import_needs_no_jax():
    """The port never imports jax (the machine with the card has none);
    a subprocess, because this test process has jax loaded already."""
    code = ("import neilpy_tpu_torch, sys; "
            "from neilpy_tpu_torch import openness_pair, geomorphons2; "
            "from neilpy_tpu_torch.ops.cuda_scan import ("
            "openness_reduced, directional_extrema); "
            "assert 'jax' not in sys.modules; "
            "assert 'neilpy_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, fast):
    rng = np.random.default_rng(3)
    Z = rng.normal(size=(257, 389)).cumsum(axis=0).cumsum(axis=1).astype(
        np.float32)
    Z[100:120, 40:90] = np.nan
    Zd = torch.from_numpy(Z).to(cuda_device)
    kw = dict(cellsize=2.0, lookup_pixels=23, threshold_angle=1.0,
              fast=fast)
    k = cuda_scan.openness_counts_cuda(Zd, **kw)
    p = cuda_scan.openness_counts_torch(Zd, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
