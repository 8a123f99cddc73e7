#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``neilpy_tpu_torch/csrc`` (nvcc,
into the git-ignored ``build/``), holds the kernel against its plain
PyTorch version on the card, runs the README's main path at the
reference scale (an 8192 x 8192 DEM written as a GeoTIFF, read back with
``imread``, classified by ``geomorphons`` at lookup 50, the classes
written with ``imwrite``), checks the classes against the plain version
and the f64 numpy oracle of ``tests/reference_impls.py``, and times the
kernel and the plain version with CUDA events.

Every phase prints one JSON line.  The lines before the last are the
card's name and power limit as nvidia-smi reports them, then the kernel
table ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero without that line; so does a machine with no CUDA device.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
MAIN_SHAPE = (8192, 8192)      # bench.py SCALE_SHAPE: ~1e8 px, Poland EU-DEM scale
MAIN_LOOKUP = 50
TIMED_RUNS = 5


def emit(**record):
    print(json.dumps(record), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_input(shape):
    """bench.py's input (``_bench_input``) at ``shape``: cumulative sums
    of seeded normals along both axes, float32."""
    Z = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    return np.cumsum(Z, axis=0) + np.cumsum(Z, axis=1)


def kernel_vs_plain(cuda_scan, dev):
    """Phase 3: kernel == plain version, exactly, on every case."""
    from neilpy_tpu_torch.ops.visibility import classes_from_counts
    r = np.random.default_rng(7)
    small = r.normal(size=(100, 140)).cumsum(0).cumsum(1).astype(np.float32)
    big = r.normal(size=(1000, 1537)).cumsum(0).cumsum(1).astype(np.float32)
    big[300:340, 500:620] = np.nan           # nodata hole
    big[700:712, :] = np.nan                 # all-NaN row band
    tiny = r.normal(size=(24, 32)).cumsum(0).astype(np.float32)
    cases = [("100x140", small, lk, t, f)
             for lk in (1, 7, 50) for t in (0.0, 1.0, 5.0)
             for f in (False, True)]
    cases += [("1000x1537+nan", big, lk, 1.0, f)
              for lk in (1, 7, 50) for f in (False, True)]
    cases += [("1000x1537+nan", big, 7, t, False) for t in (0.0, 5.0)]
    cases += [("24x32", tiny, 100, 1.0, f) for f in (False, True)]
    worst = 0
    for name, Z, lk, t, f in cases:
        Zd = torch.from_numpy(Z).to(dev)
        kw = dict(cellsize=2.0, lookup_pixels=lk, threshold_angle=t, fast=f)
        k = cuda_scan.openness_counts_cuda(Zd, **kw)
        p = cuda_scan.openness_counts_torch(Zd, **kw)
        torch.cuda.synchronize()
        err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, p))
        worst = max(worst, err)
        check(err == 0, f"kernel != plain on {name} lookup={lk} "
                        f"threshold={t} fast={f} (max |diff| {err})")
    Zd = torch.from_numpy(big).to(dev)
    G = cuda_scan.geomorphons_cuda(Zd, cellsize=2.0, lookup_pixels=50)
    plain = classes_from_counts(*cuda_scan.openness_counts_torch(
        Zd, cellsize=2.0, lookup_pixels=50))
    check(torch.equal(G, plain), "geomorphons_cuda != plain classes")
    emit(phase="kernel_vs_plain", cases=len(cases), max_abs_err=worst)
    return worst


def oracle_check(ntt, dev):
    """The repo's own oracles on the card: the J&S micro-morphologies
    and the f64 numpy geomorphon loop (classes may differ from it only
    at f32 decision ties, margin < 2e-3 deg)."""
    sys.path.insert(0, str(HERE))
    from tests.reference_impls import np_geomorphons
    micro = [([[1, 1, 1], [1, 2, 1], [1, 1, 1]], 2),
             ([[0, 0, 0], [2, 1, 2], [2, 2, 2]], 7),
             ([[1, 1, 1], [1, 0, 1], [1, 1, 1]], 10),
             ([[0, 0, 0], [1, 1, 1], [2, 2, 2]], 6),
             ([[0, 1, 2], [2, 1, 0], [0, 1, 2]], 6),
             ([[1, 1, 1], [1, 1, 1], [1, 1, 1]], 1)]
    for Zm, code in micro:
        G = ntt.geomorphons(np.array(Zm, dtype=float), lookup_pixels=1,
                            device=dev)
        check(int(G[1, 1]) == code, f"micro-morphology {Zm} -> {code}")
    Z64 = bench_input((192, 256)).astype(np.float64)
    flips = 0
    for enhance, fast in ((False, False), (True, False), (False, True)):
        ref, margin = np_geomorphons(Z64, cellsize=10, lookup_pixels=50,
                                     threshold_angle=1, enhance=enhance,
                                     fast=fast, return_margin=True)
        G = ntt.geomorphons(Z64, cellsize=10, lookup_pixels=50,
                            threshold_angle=1, enhance=enhance, fast=fast,
                            device=dev).cpu().numpy()
        diff = G != ref
        flips += int(diff.sum())
        check(not diff.any() or margin[diff].max() < 2e-3,
              f"non-tie disagreement with the f64 oracle (enhance={enhance}"
              f", fast={fast})")
    emit(phase="oracle", micro_morphologies=len(micro),
         f64_oracle_tie_flips=flips)


def main_path(ntt, cuda_scan, dev, tmp):
    """Phase 4: GeoTIFF -> imread -> geomorphons -> imwrite at 8192^2."""
    H, W = MAIN_SHAPE
    Z = bench_input(MAIN_SHAPE)
    dem = str(Path(tmp) / "dem.tif")
    out = str(Path(tmp) / "classes.tif")
    ntt.imwrite(dem, Z, {"transform": ntt.from_origin(0.0, 10.0 * H, 10, 10),
                         "crs": 32633, "nodata": None})
    torch.cuda.synchronize()

    cuda_scan.openness_counts_cuda.launches = 0
    t0 = time.perf_counter()
    Zr, meta = ntt.imread(dem)
    kw = dict(cellsize=meta["cellsize"], lookup_pixels=MAIN_LOOKUP,
              threshold_angle=1, device=dev)
    G = ntt.geomorphons(Zr, **kw)
    G_enh = ntt.geomorphons(Zr, enhance=True, **kw)
    G_fast = ntt.geomorphons(Zr, fast=True, **kw)
    ntt.imwrite(out, G, meta, colormap=ntt.geomorphon_cmap())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_scan.openness_counts_cuda.launches

    check(launches == 4, f"main path launched the kernel {launches} times, "
                         "expected 4 (exact, enhance x2, fast)")
    check(np.array_equal(Zr, Z), "GeoTIFF read-back differs from the DEM")
    check(meta["cellsize"] == 10.0, "cellsize lost in the GeoTIFF")
    Zd = torch.from_numpy(Zr).to(dev)
    for name, got, extra in (("exact", G, {}), ("enhance", G_enh,
                                               {"enhance": True}),
                             ("fast", G_fast, {"fast": True})):
        check(got.shape == MAIN_SHAPE and got.dtype == torch.uint8
              and got.is_cuda, f"{name}: classes shape/dtype/device")
        check(int(got.min()) >= 1 and int(got.max()) <= 10,
              f"{name}: classes outside 1..10")
        plain = ntt.geomorphons(Zd, engine="torch", **kw, **extra)
        check(torch.equal(got, plain), f"{name}: kernel classes != plain")
    back, _ = ntt.imread(out)
    check(np.array_equal(back, G.cpu().numpy()), "classes.tif read-back")
    hist = torch.bincount(G.flatten().long(), minlength=11)[1:].tolist()
    emit(phase="main_path", shape=list(MAIN_SHAPE), lookup=MAIN_LOOKUP,
         launches=launches, wall_s=wall, class_histogram=hist)
    return Zd, launches


def timings(cuda_scan, Zd, card):
    """Phase 5: median of CUDA-event times, kernel and plain in turns."""
    H, W = Zd.shape
    fns = {"kernel": cuda_scan.openness_counts_cuda,
           "plain": cuda_scan.openness_counts_torch}
    order = [("plain", False), ("kernel", False), ("kernel", True),
             ("plain", True)]
    times = {key: [] for key in order}
    for key in order:  # warm-up
        fns[key[0]](Zd, cellsize=10.0, lookup_pixels=MAIN_LOOKUP,
                    threshold_angle=1.0, fast=key[1])
    torch.cuda.synchronize()
    for _ in range(TIMED_RUNS):
        for key in order:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[key[0]](Zd, cellsize=10.0, lookup_pixels=MAIN_LOOKUP,
                        threshold_angle=1.0, fast=key[1])
            stop.record()
            stop.synchronize()
            times[key].append(start.elapsed_time(stop))
    res = {}
    for (impl, fast), ts in times.items():
        ms = statistics.median(ts)
        res[(impl, fast)] = ms
        emit(phase="timing", impl=impl, ladder="fast" if fast else "exact",
             shape=[H, W], lookup=MAIN_LOOKUP, runs=ts, median_ms=ms,
             mpix_per_s=H * W / ms / 1e3, card=card)
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import neilpy_tpu_torch as ntt
    from neilpy_tpu_torch import _build
    from neilpy_tpu_torch.ops import cuda_scan
    check(Path(ntt.__file__).resolve().parent == HERE / "neilpy_tpu_torch",
          f"imported {ntt.__file__}, not this checkout's package")
    check("jax" not in sys.modules and "neilpy_tpu" not in sys.modules,
          "the port must not import jax or neilpy_tpu")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = card_line()
    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), card=card)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    emit(phase="build", seconds=time.perf_counter() - t0,
         library=str(lib.relative_to(HERE)),
         ptxas=[ln for ln in lib.with_suffix(".log").read_text().splitlines()
                if "registers" in ln or "spill" in ln])

    max_err = kernel_vs_plain(cuda_scan, dev)
    oracle_check(ntt, dev)
    with tempfile.TemporaryDirectory() as tmp:
        Zd, launches = main_path(ntt, cuda_scan, dev, tmp)
    res = timings(cuda_scan, Zd, card)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "openness_counts",
        "route": "cuda",
        "source": "neilpy_tpu_torch/csrc/openness_counts.cu",
        "replaces": "neilpy_tpu/ops/pallas_scan.py:401",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": res[("kernel", False)],
        "plain_ms": res[("plain", False)],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
