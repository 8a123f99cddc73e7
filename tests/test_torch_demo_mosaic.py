"""``tools/demo_mosaic_torch.py``, the port's config-5 run at full extent,
held against ``tools/demo_mosaic_50k.py`` and the JAX package on the CPU
(``--device cpu``: the plain version of K1 in the tile program).

The JAX script is never imported or run: its top level points JAX's
persistent compile cache into the repo and its ``main`` writes a record
there.  Its ``synth_dem`` is taken out of its source with ``ast`` and run
with numpy alone.

Tolerances: the DEM byte for byte; classes and object cells exactly
(with the uint16 upload against the JAX mosaic of the dequantized raster,
which is what the port's tile program decodes; against the JAX package's
own quantized mosaic, whose decode is one fused multiply-add, on >=
0.99999, the JAX script's floor); Moran's I within one bfloat16 step of
the JAX compact wire's, 2^-7 |M| (two roundings of nearly equal float32
values may land on neighbouring bfloat16 values), plus float16's 2^-11 |M|
with ``--moran-f16`` and 1e-5 (1e-4 against the JAX quantized mosaic,
whose inputs differ by an ulp); ``verify`` on the exact wire with a
float32 Moran plane: Moran within 1e-5; the BigTIFF byte for byte;
resumed == uninterrupted bit for bit.
"""

import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import neilpy_tpu as nt
from neilpy_tpu.pipelines import mosaic as jmosaic

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "demo_mosaic_torch.py"
N = 1500
TILE = 512
WINDOW = 256                   # verify's windows, 1024 on the card
TRIO = ("geomorphons", "objects", "moran")
BF16_STEP = 2.0 ** -7
F16_HALF_STEP = 2.0 ** -11


def load_tool():
    spec = importlib.util.spec_from_file_location("demo_mosaic_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = load_tool()


def jax_synth_dem():
    """``synth_dem`` of tools/demo_mosaic_50k.py, compiled from its source
    alone and run with numpy."""
    path = REPO / "tools" / "demo_mosaic_50k.py"
    tree = ast.parse(path.read_text(), str(path))
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef)
              and node.name == "synth_dem")
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"),
         ns)
    return ns["synth_dem"]


def run_tool(d, *extra, n=N, tile=TILE):
    rc = tool.main(["--size", str(n), "--tile", str(tile), "--dir", str(d),
                    "--device", "cpu", "--wire", "compact", *extra])
    assert rc == 0
    with open(Path(d) / "record.json") as f:
        return json.load(f)


def planes(d, n=N):
    """The run's three output planes (objects as bool, Moran as stored)."""
    size = os.path.getsize(Path(d) / "moran.out") // (n * n)
    G = np.fromfile(Path(d) / "geomorphons.out", np.uint8).reshape(n, n)
    O = np.fromfile(Path(d) / "objects.out", np.uint8).reshape(n, n)
    M = np.fromfile(Path(d) / "moran.out",
                    {2: np.float16, 4: np.float32}[size]).reshape(n, n)
    return G, O.view(bool), M


def dem(d, n=N):
    return np.fromfile(Path(d) / "dem.f32", np.float32).reshape(n, n)


def moments(d):
    with open(Path(d) / "tiles.json.moments") as f:
        return json.load(f)


def jax_trio(Z, **kw):
    out = nt.mosaic_terrain_products(
        Z, cellsize=10, lookup_pixels=50, windows=np.array((1, 2, 4)),
        gi_radius=3, tile_size=TILE, products=TRIO, wire="compact",
        use_pallas=False, **kw)
    return tuple(np.asarray(a) for a in out)


def assert_moran(got, want, rtol, atol=1e-5):
    got = np.asarray(got, dtype=np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    excess = np.abs(got[fin] - want[fin]) - (rtol * np.abs(want[fin])
                                             + atol)
    assert np.max(excess) <= 0, np.max(excess)


@pytest.fixture(scope="module")
def f32_run(tmp_path_factory):
    """The tool at N, tile 512, compact wire, f32 upload, Moran float16."""
    d = tmp_path_factory.mktemp("f32")
    return d, run_tool(d, "--moran-f16")


@pytest.fixture(scope="module")
def u16_run(tmp_path_factory):
    """The tool with the uint16 upload, Moran float32."""
    d = tmp_path_factory.mktemp("u16")
    return d, run_tool(d, "--upload-dtype", "uint16")


@pytest.mark.parametrize("n", [1500, 2100])
def test_synth_dem_is_the_jax_scripts_byte_for_byte(tmp_path, n):
    jax_synth_dem()(str(tmp_path / "jax.f32"), n)
    tool.synth_dem(str(tmp_path / "port.f32"), n)
    assert (tmp_path / "jax.f32").read_bytes() == \
        (tmp_path / "port.f32").read_bytes()


def test_f32_run_matches_the_jax_mosaic(f32_run):
    d, rec = f32_run
    G, O, M = planes(d)
    jG, jO, jM = jax_trio(dem(d))
    np.testing.assert_array_equal(G, jG)
    np.testing.assert_array_equal(O, jO)
    assert M.dtype == np.float16
    assert_moran(M, jM, BF16_STEP + F16_HALF_STEP)


def test_u16_run_matches_the_jax_mosaic(u16_run):
    d, rec = u16_run
    G, O, M = planes(d)
    assert M.dtype == np.float32
    Z = dem(d)
    mom = moments(d)
    Zdq = jmosaic._QuantizedSource(Z, mom["qlo"], mom["qhi"]).dequantized()
    dG, dO, dM = jax_trio(Zdq)
    np.testing.assert_array_equal(G, dG)
    np.testing.assert_array_equal(O, dO)
    assert_moran(M, dM, BF16_STEP)
    qG, qO, qM = jax_trio(Z, upload_dtype="uint16")
    assert np.mean(G == qG) >= tool.QUANTIZED_FLOOR
    assert np.mean(O == qO) >= tool.QUANTIZED_FLOOR
    # the fused decode moves an input by an ulp, so a Moran value near 0
    # moves by more than its bfloat16 step
    assert_moran(M, qM, BF16_STEP, atol=1e-4)


def test_record(f32_run):
    d, rec = f32_run
    assert rec["size"] == N and rec["pixels"] == N * N
    assert rec["products"] == list(TRIO) and rec["size_cut"] is None
    assert rec["tile_px"] == TILE + 2 * 50 and rec["tiles"] == 9
    assert rec["dtypes"] == {"geomorphons": "uint8", "objects": "uint8",
                             "moran": "float16"}
    assert rec["engine"] == "torch" and rec["device"] == "cpu"
    assert rec["wall_s"] > 0 and rec["mpix_s"] == N * N / 1e6 / rec["wall_s"]
    run = rec["this_run"]
    assert run["tiles"] == 9 and run["tiles_done_before"] == 0
    assert set(run["phase_stats"]) >= {"tiles", "upload", "dispatch",
                                       "store_wait", "total"}
    assert run["launches"] == dict.fromkeys(tool.KERNELS, 0)
    assert run["tile_loads"] == {}
    assert run["page_cache"] == tool.page_cache(
        run["dem_resident_share_at_start"])
    assert rec["moments_pass"]["page_cache"] == run["page_cache"]
    assert not run["moments_cached"] and run["moments_s"] >= 0
    assert rec["bigtiff_gib"] == os.path.getsize(
        d / "geomorphons.tif") / 2 ** 30
    assert rec["start"]["disk_free_bytes"] > 0
    assert rec["start"]["host_ram_gib"]["MemTotal"] > 0
    assert run["host_peak_mib"]["VmRSS"] > 0
    assert json.loads((d / "wall.json").read_text())["wall_s"] == \
        rec["wall_s"]
    assert not (d / "start.json").exists()


def test_bigtiff_bytes_equal_the_jax_writer(f32_run, tmp_path):
    d, _ = f32_run
    G, _, _ = planes(d)
    ref = tmp_path / "jax.tif"
    nt.write_geotiff(str(ref), G, transform=nt.from_origin(
        0, N * 10.0, 10.0, 10.0), crs=32633, tiled=True, tile_size=1024,
        bigtiff=True)
    data = (d / "geomorphons.tif").read_bytes()
    assert data == ref.read_bytes()
    assert data[2:4] == b"\x2b\x00"          # BigTIFF, 8-byte offsets
    src = tool.ntt.GeoTiffSource(str(d / "geomorphons.tif"))
    assert np.array_equal(src[:, :], G)


def test_resume_from_half_the_tiles_equals_uninterrupted(f32_run,
                                                         tmp_path):
    """A directory as a kill leaves it: the moments sidecar, a checkpoint
    listing 5 of the 9 tiles, those tiles' outputs stored and zeros
    elsewhere, the start marker; the rerun computes the 4 others only,
    recovers the killed run's time and gives the uninterrupted planes and
    BigTIFF bit for bit."""
    d, rec = f32_run
    G, O, M = planes(d)
    shutil.copy(d / "dem.f32", tmp_path / "dem.f32")
    shutil.copy(d / "dem.f32.done", tmp_path / "dem.f32.done")
    shutil.copy(d / "tiles.json.moments", tmp_path / "tiles.json.moments")
    done = [(0, 0), (0, 2), (1, 1), (2, 0), (2, 1)]
    outs = [np.zeros_like(a) for a in (G, O.view(np.uint8), M)]
    for ty, tx in done:
        sl = np.s_[ty * TILE:(ty + 1) * TILE, tx * TILE:(tx + 1) * TILE]
        for o, a in zip(outs, (G, O.view(np.uint8), M)):
            o[sl] = a[sl]
    for p, o in zip(TRIO, outs):
        o.tofile(tmp_path / f"{p}.out")
    ck = tmp_path / "tiles.json"
    ck.write_text(json.dumps(sorted(done)))
    t0 = time.time() - 10.0
    (tmp_path / "start.json").write_text(json.dumps({"t0": t0}))
    os.utime(ck, (t0 + 4.0, t0 + 4.0))
    got = run_tool(tmp_path, "--moran-f16")
    assert got["this_run"]["tiles"] == 4
    assert got["this_run"]["tiles_done_before"] == 5
    assert got["this_run"]["moments_cached"]
    assert got["recovered_s"] == pytest.approx(4.0)
    for a, b in zip(planes(tmp_path), (G, O, M)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (tmp_path / "geomorphons.tif").read_bytes() == \
        (d / "geomorphons.tif").read_bytes()


def test_kill_at_sigkills_and_resumes(tmp_path):
    """``--kill-at 0.5`` in a subprocess at 300^2, tile 64 (25 tiles): the
    first child is SIGKILLed with at least 13 tiles stored, the second
    computes only the others, and the planes equal an uninterrupted
    run's."""
    args = ["--size", "300", "--tile", "64", "--device", "cpu",
            "--moran-f16"]
    out = subprocess.run(
        [sys.executable, str(TOOL), *args, "--dir", str(tmp_path / "k"),
         "--kill-at", "0.5"], capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "k" / "record.json").read_text())
    killed = rec["killed_at_tiles"]
    assert 13 <= killed < 25 and rec["kill_at"] == 0.5
    assert rec["this_run"]["tiles"] == 25 - killed
    assert rec["recovered_s"] > 0
    run_tool(tmp_path / "u", *args[4:], n=300, tile=64)
    for a, b in zip(planes(tmp_path / "k", 300), planes(tmp_path / "u", 300)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_verify_passes_and_catches_a_flipped_class(f32_run, u16_run,
                                                   tmp_path):
    for d, upload in ((f32_run[0], None), (u16_run[0], "uint16")):
        assert tool.verify(tool.ensure_dem(str(d), N), str(d), N, TRIO,
                           "cpu", upload_dtype=upload, window=WINDOW) == 0
        res = json.loads((d / "verify.json").read_text())
        assert res["ok"] and len(res["windows"]) == 3
        assert all(w["classes_differ"] == 0 and w["objects_differ"] == 0
                   and w["tif_equals_memmap"] for w in res["windows"])
    d = f32_run[0]
    for name in ("dem.f32", "dem.f32.done", "tiles.json.moments",
                 "objects.out", "moran.out"):
        shutil.copy(d / name, tmp_path / name)
    G = planes(d)[0].copy()
    r, c = tool.verify_windows(N, WINDOW)[0]
    G[r + 7, c + 9] = 1 + G[r + 7, c + 9] % 10
    G.tofile(tmp_path / "geomorphons.out")
    tool.write_classes(str(tmp_path / "geomorphons.tif"), G, N)
    assert tool.verify(tool.ensure_dem(str(tmp_path), N), str(tmp_path), N,
                       TRIO, "cpu", window=WINDOW) == 1
    res = json.loads((tmp_path / "verify.json").read_text())
    assert not res["ok"]
    assert [w["classes_differ"] for w in res["windows"]][0] == 1


def test_verify_holds_the_exact_wire_to_float32(tmp_path):
    """On the exact wire with a float32 Moran plane, ``verify`` allows
    Moran no relative error (only the 1e-5 of tiled against untiled sums)
    and passes a run at 300^2, tile 128, on 64^2 windows."""
    assert tool.main(["--size", "300", "--tile", "128", "--dir",
                      str(tmp_path), "--device", "cpu", "--wire",
                      "exact"]) == 0
    assert tool.verify(tool.ensure_dem(str(tmp_path), 300), str(tmp_path),
                       300, TRIO, "cpu", wire="exact", window=64) == 0
    res = json.loads((tmp_path / "verify.json").read_text())
    assert res["ok"] and res["wire"] == "exact"
    assert res["moran_rtol"] == 0.0 and res["moran_atol"] == 1e-5
    assert all(w["moran_over_tolerance"] == 0 for w in res["windows"])


@pytest.mark.parametrize("share,state", [
    (None, None), (0.0, "cold"), (0.05, "cold"), (0.5, "warm"),
    (1.0, "warm")])
def test_page_cache_is_read_from_the_resident_share(share, state):
    assert tool.page_cache(share) == state


def test_resident_share_of_a_memmap_just_written(tmp_path):
    """mincore on a memmap whose pages were all just written: every page
    is in the page cache."""
    a = np.memmap(tmp_path / "a.f32", dtype=np.float32, mode="w+",
                  shape=(256, 1024))
    a[:] = 1.0
    assert tool.resident_share(a) == 1.0


def test_without_a_card_it_raises_and_writes_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d = tmp_path / "none"
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(["--size", "300", "--dir", str(d)])
    assert not d.exists()
    default = tool.parse_args([]).dir
    assert not Path(default).resolve().is_relative_to(REPO)


def test_a_cuda_device_gets_its_index(monkeypatch):
    """``--device cuda`` names the current card by index, as
    ``torch.cuda.set_device`` needs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tool.device_of(tool.parse_args([])) == torch.device("cuda", 0)
    assert tool.device_of(tool.parse_args(["--device", "cuda:1"])) == \
        torch.device("cuda", 1)
    assert tool.device_of(tool.parse_args(["--device", "cpu"])) == \
        torch.device("cpu")
