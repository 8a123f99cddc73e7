"""The PyTorch port's last host modules held to the JAX package's:
``core.shift.ashift_fill``, the nine ``filters`` callbacks through
``scipy.ndimage.generic_filter``, ``utils`` (``voxelize``,
``write_voxel_stl`` byte for byte, ``set_print_options``) bit for bit on
seeded inputs, and ``profiling`` (``sync``, ``Throughput``, ``trace``,
``compile_report``) on CPU tensors, with the JAX package's printed
formats.  The JAX package is imported by the ``ref`` fixture, so the
``cuda`` case, which skips here from inside a fixture, runs on a card
without JAX: ``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_utils.py -m cuda``."""

import dataclasses
import glob
import json
import math
import os
import re
import sys
import time

import types

import numpy as np
import pandas as pd
import pytest
import scipy.ndimage as ndi
import torch

import neilpy_tpu_torch as ntt
import neilpy_tpu_torch.filters as tfilters
import neilpy_tpu_torch.profiling as tprofiling
import neilpy_tpu_torch.utils as tutils
from neilpy_tpu_torch import _build, _host_build
from neilpy_tpu_torch.core.shift import ashift_fill

torch.set_num_threads(1)

SHAPE = (24, 32)


def raster(seed=3):
    return np.random.default_rng(seed).normal(size=SHAPE).cumsum(
        axis=0).cumsum(axis=1)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules under test."""
    import jax
    import neilpy_tpu.filters
    import neilpy_tpu.profiling
    import neilpy_tpu.utils
    from neilpy_tpu.core.shift import ashift_fill as jax_ashift_fill
    return types.SimpleNamespace(
        jax=jax, filters=neilpy_tpu.filters, profiling=neilpy_tpu.profiling,
        utils=neilpy_tpu.utils, ashift_fill=jax_ashift_fill)


def bits(a):
    """The array's bytes as unsigned integers (NaN payloads included)."""
    a = np.ascontiguousarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


# ----------------------------------------------------------------------
# core.shift.ashift_fill
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fill", [math.nan, 0.0], ids=["nan", "zero"])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("direction", range(8))
def test_ashift_fill_matches_jax(direction, n, fill, dtype, ref):
    Z = raster(direction).astype(dtype)
    # JAX keeps float64 only with x64 on; the port keeps Z's dtype
    with ref.jax.enable_x64(dtype == np.float64):
        want = np.asarray(ref.ashift_fill(Z, direction, n, fill=fill))
    got = ashift_fill(Z, direction, n, fill=fill, device="cpu")
    assert got.dtype == torch.from_numpy(Z).dtype
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def test_ashift_fill_keeps_a_tensor_where_it_is(ref):
    Z = torch.from_numpy(raster().astype(np.float32))
    got = ashift_fill(Z, 4, 2)
    assert got.device == Z.device
    np.testing.assert_array_equal(
        bits(got.numpy()), bits(np.asarray(ref.ashift_fill(Z.numpy(), 4, 2))))


# ----------------------------------------------------------------------
# filters through generic_filter
# ----------------------------------------------------------------------
FILTER_CASES = {
    "tpi": ("topographic_position_index_filter", dict(size=5), {}),
    "tri": ("terrain_ruggedness", dict(size=3), {}),
    "slope_degrees": ("esri_planar_slope", dict(size=3),
                      dict(cellsize=10, degrees=True)),
    "slope_ratio": ("esri_planar_slope", dict(size=3),
                    dict(cellsize=2, degrees=False)),
    "skyview": ("skyview_filter", dict(size=5), dict(cellsize=10)),
    "openness": ("openness_filter", dict(size=5),
                 dict(cellsize=10, skyview=False)),
    "openness_skyview": ("openness_filter", dict(size=7),
                         dict(cellsize=10, skyview=True)),
    "curvature": ("esri_curvature", dict(size=3),
                  dict(cellsize=10, kind="curvature")),
    "plan": ("esri_curvature", dict(size=3), dict(cellsize=10, kind="plan")),
    "profile": ("esri_curvature", dict(size=3),
                dict(cellsize=10, kind="profile")),
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_filter_through_generic_filter_matches_jax(case, ref):
    name, window, kw = FILTER_CASES[case]
    Z = raster()
    Z[5, 7] = np.nan  # a hole, as a real DEM has
    outs = [ndi.generic_filter(Z, getattr(mod, name), mode="nearest",
                               extra_keywords=kw, **window)
            for mod in (ref.filters, tfilters)]
    np.testing.assert_array_equal(bits(outs[1]), bits(outs[0]))


def test_life_filter_matches_jax(ref):
    board = (np.random.default_rng(5).random(SHAPE) < 0.35).astype(float)
    for _ in range(3):
        nxt = ndi.generic_filter(board, tfilters.life_filter, size=3,
                                 mode="constant")
        want = ndi.generic_filter(board, ref.filters.life_filter, size=3,
                                  mode="constant")
        np.testing.assert_array_equal(nxt, want)
        board = nxt


@pytest.mark.parametrize("size", [3, 5, 9])
def test_grid_distance_and_fetch_values_match_jax(size, ref):
    np.testing.assert_array_equal(tfilters.grid_distance((size, size)),
                                  ref.filters.grid_distance((size, size)))
    X = np.random.default_rng(size).normal(size=(size, size))
    for d in range(8):
        np.testing.assert_array_equal(tfilters.fetch_values(X, d),
                                      ref.filters.fetch_values(X, d))


def test_esri_curvature_unknown_kind_raises_like_jax(ref):
    X = raster()[:3, :3].ravel()
    for mod in (ref.filters, tfilters):
        with pytest.raises(ValueError, match="bogus"):
            mod.esri_curvature(X, kind="bogus")


def test_filters_all_matches_jax(ref):
    assert tfilters.__all__ == ref.filters.__all__


# ----------------------------------------------------------------------
# utils: voxelize, write_voxel_stl, set_print_options
# ----------------------------------------------------------------------
def cloud(n=4000, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, n)
    y = rng.uniform(0, 10, n)
    z = 1.5 + np.sin(x) + 0.3 * rng.normal(size=n)
    return x, y, z


VOXEL_CASES = {
    "default": dict(),
    "no_bottom_fill": dict(bottom_fill=False),
    "threshold": dict(threshold=3),
    "ve": dict(ve=2),
    "pad": dict(pad=3),
}


@pytest.mark.parametrize("case", sorted(VOXEL_CASES))
def test_voxelize_matches_jax(case, ref):
    x, y, z = cloud()
    kw = dict(resolution=12, **VOXEL_CASES[case])
    got = tutils.voxelize(None, x, y, z, **kw)
    want = ref.utils.voxelize(None, x, y, z, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["voxels", "scaled", "empty"])
def test_write_voxel_stl_bytes_match_jax(case, tmp_path, ref):
    x, y, z = cloud()
    H = ref.utils.voxelize(None, x, y, z, resolution=8)
    kw = {}
    if case == "scaled":
        kw = dict(scale=0.5, origin=(100.0, -20.0, 3.0))
    elif case == "empty":
        H = np.zeros((3, 4, 5), dtype=bool)
    got, want = tmp_path / "port.stl", tmp_path / "jax.stl"
    assert tutils.write_voxel_stl(str(got), H, **kw) == \
        ref.utils.write_voxel_stl(str(want), H, **kw)
    assert got.read_bytes() == want.read_bytes()


def test_voxelize_without_voxelfuse_raises_like_jax(monkeypatch, tmp_path,
                                                   ref):
    monkeypatch.setitem(sys.modules, "voxelfuse", None)
    x, y, z = cloud(500)
    errs = []
    for mod in (ref.utils, tutils):
        with pytest.raises(ImportError) as e:
            mod.voxelize(str(tmp_path / "v.stl"), x, y, z, resolution=5)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]
    assert "voxelfuse" in errs[1][1]


@pytest.fixture
def print_options():
    """Restore numpy's, pandas' and torch's print options afterwards: the
    worker runs other files in this process."""
    saved_np = np.get_printoptions()
    saved_pd = pd.options.display.float_format
    saved_torch = dataclasses.asdict(torch._tensor_str.PRINT_OPTS)
    yield
    np.set_printoptions(**saved_np)
    pd.options.display.float_format = saved_pd
    torch.set_printoptions(**saved_torch)


@pytest.mark.parametrize("places,width", [(2, 0), (4, 10)])
def test_set_print_options_matches_jax(places, width, print_options, ref):
    a = np.array([1.0, -2.123456789, 1e-7, 12345.678])
    ref.utils.set_print_options(places, width)
    want = (np.array2string(a), pd.options.display.float_format(3.14159))
    tutils.set_print_options(places, width)
    got = (np.array2string(a), pd.options.display.float_format(3.14159))
    assert got == want
    text = repr(torch.tensor([1.0, -2.123456789, 1e-7]))
    decimals = {len(m) for m in re.findall(r"\d+\.(\d+)", text)}
    assert decimals == {places}, text
    assert "e-" not in text


# ----------------------------------------------------------------------
# profiling
# ----------------------------------------------------------------------
def test_sync_is_a_noop_on_cpu_values():
    x = torch.ones(3)
    nested = ({"a": (x, [x * 2, None])}, "text", 4)
    assert tprofiling.sync(None) is None
    assert tprofiling.sync(nested) is nested
    assert tprofiling.sync(x) is x
    assert not torch.cuda.is_initialized() or torch.cuda.is_available()


def normalised(line):
    """A Throughput line with its numbers masked."""
    return re.sub(r"[\d.,]+", "#", line)


@pytest.mark.parametrize("items", [1, 10 ** 13], ids=["K", "M"])
def test_throughput_prints_the_jax_line(items, capsys, ref):
    Z = torch.ones(64, 64)
    with ntt.Throughput("add", items=items, unit="pts") as tp:
        tp.result = {"out": (Z + 1,)}
    got = capsys.readouterr().out.strip()
    assert tp.seconds > 0 and tp.rate == items / tp.seconds
    big = tp.rate >= 1e6
    rate = (f"{tp.rate / 1e6:,.1f} Mpts/s" if big
            else f"{tp.rate / 1e3:,.1f} Kpts/s")
    assert got == (f"add: {rate} ({tp.seconds * 1e3:.1f} ms for "
                   f"{items / 1e6:.2f} Mpts)")
    import jax.numpy as jnp
    with ref.profiling.Throughput("add", items=items, unit="pts") as jtp:
        jtp.result = jnp.ones((64, 64)) + 1
    want = capsys.readouterr().out.strip()
    assert (jtp.rate >= 1e6) == big
    assert normalised(got) == normalised(want)


def test_throughput_quiet_and_failed_blocks_print_nothing(capsys):
    with ntt.Throughput("q", items=5, quiet=True) as tp:
        tp.result = torch.zeros(2)
    with pytest.raises(KeyError):
        with ntt.Throughput("f", items=5):
            raise KeyError("x")
    assert capsys.readouterr().out == ""
    assert tp.seconds > 0


def trace_events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    Z = raster().astype(np.float32)
    with ntt.trace(log_dir) as d:
        assert d == log_dir
        ntt.hillshade(Z, cellsize=10, device="cpu")
    names = {e.get("name", "") for e in trace_events(log_dir)}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    assert "aten::atan2" in names


def test_trace_lets_an_exception_through(tmp_path):
    log_dir = tmp_path / "trace"
    with pytest.raises(ZeroDivisionError):
        with ntt.trace(str(log_dir)):
            torch.ones(2).sum()
            1 / 0
    assert not glob.glob(str(log_dir / "*.json"))


def test_compile_report_keys_and_flops(capsys, ref):
    from neilpy_tpu_torch.ops.surface import convolve2d_nearest
    Z = torch.from_numpy(raster().astype(np.float32))
    rep = ntt.compile_report(convolve2d_nearest, Z, np.ones((3, 3)),
                             name="conv")
    assert rep["name"] == "conv" and rep["compile_s"] >= 0
    assert rep["lower_s"] >= 0
    assert rep["flops"] == 2 * 9 * Z.numel()
    out = capsys.readouterr().out
    assert re.fullmatch(r"compile\[conv\]: lower [\d.]+s, compile "
                        r"[\d.]+s, [\d.]+ GFLOP\n", out), out
    rep = ntt.compile_report(lambda a: (a * 2).sum(), Z)
    assert set(rep) == {"name", "lower_s", "compile_s"}
    assert rep["name"] == "<lambda>" and rep["compile_s"] == 0.0
    jrep = ref.profiling.compile_report(lambda a: (a * 2).sum(), Z.numpy())
    assert {"name", "lower_s", "compile_s"} <= set(jrep)


def test_compile_report_counts_the_build_seconds(monkeypatch):
    monkeypatch.setattr(_build, "BUILD_SECONDS", 1.0)
    monkeypatch.setattr(_host_build, "BUILD_SECONDS", 2.0)

    spent = []

    def builds(a):
        # two "builds" that take the time they report
        for mod in (_build, _host_build):
            t0 = time.perf_counter()
            time.sleep(0.01)
            spent.append(time.perf_counter() - t0)
            mod.BUILD_SECONDS += spent[-1]
        return a + 1

    rep = ntt.compile_report(builds, torch.ones(4))
    assert rep["compile_s"] == pytest.approx(sum(spent), abs=1e-9)
    assert rep["lower_s"] >= 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_throughput_and_trace_on_card(cuda_device, tmp_path):
    Z = torch.from_numpy(raster().astype(np.float32)).to(cuda_device)
    with ntt.Throughput("geomorphons", items=Z.numel(), quiet=True) as tp:
        tp.result = ntt.geomorphons(Z, cellsize=10, lookup_pixels=5)
    assert tp.seconds > 0 and tp.result.is_cuda
    with ntt.trace(str(tmp_path)):
        ntt.geomorphons(Z, cellsize=10, lookup_pixels=5, fast=True)
    kernels = {e["name"] for e in trace_events(str(tmp_path))
               if e.get("cat") == "kernel"}
    assert any("openness_counts" in k for k in kernels), kernels
