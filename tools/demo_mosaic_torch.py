"""BASELINE config 5 at full extent on one card, disk to disk: the
PyTorch port's counterpart of ``tools/demo_mosaic_50k.py``.

Streams an n x n float32 DEM (a memmap on disk, 40 GB at n = 100,000)
through ``neilpy_tpu_torch.mosaic_terrain_products``: geomorphon classes,
SMRF object cells and local Moran's I, the config-5 trio, at lookup 50,
cellsize 10, windows (1, 2, 4), streamed tile by tile (config 5 is the
mosaic beyond the card's memory), into one memory-mapped output per
product; then writes the class plane as a tiled BigTIFF.  The tile
checkpoint (``<dir>/tiles.json``) makes the run SIGKILL-safe: running the
script again resumes from the last stored tile, and ``--kill-at F`` does
that exercise itself (a child run SIGKILLed once the checkpoint lists a
share F of the tiles, then a second child that resumes).  ``--verify``
recomputes three interior windows untiled and checks the stored planes
and the BigTIFF.

It imports torch, numpy and ``neilpy_tpu_torch`` only, and writes only
under ``--dir``: the DEM, the outputs, the checkpoint, ``wall.json`` and
``record.json`` (the run's numbers, also printed).

Usage (on a card; a run without one raises unless ``--device cpu``)::

    python3 tools/demo_mosaic_torch.py --size 100000,70000,50000 \\
        --tile 4096 --moran-f16 --dir /data/mosaic --kill-at 0.5
    python3 tools/demo_mosaic_torch.py --size 100000,70000,50000 \\
        --moran-f16 --dir /data/mosaic --verify

``--size`` takes the first of its sizes whose files fit on the disk of
``--dir`` (DEM 4 B/px, classes and objects 1 B/px each, Moran 2 B/px with
``--moran-f16`` or 4 without, the BigTIFF ~1 B/px: 90 GB at 100,000^2,
44 GB at 70,000^2); the record names the cut and the free bytes.
"""
import argparse
import ctypes
import json
import math
import os
import resource
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import neilpy_tpu_torch as ntt  # noqa: E402
from neilpy_tpu_torch import _build  # noqa: E402
from neilpy_tpu_torch.ops import cuda_scan  # noqa: E402
from neilpy_tpu_torch.pipelines import mosaic  # noqa: E402

LOOKUP = 50
CELLSIZE = 10.0
WINDOWS = (1, 2, 4)
GI_RADIUS = 3
SLOPE_THRESHOLD = .15
TIF_TILE = 1024
VERIFY_WINDOW = 1024
# Moran on the compact wire is rounded to bfloat16 (8 significant bits,
# |d| <= 2^-8 |M|), then stored as float16 (11 bits, 2^-11 |M|) with
# --moran-f16; the absolute term covers float16's subnormals near 0 and
# the tiled and untiled float32 sums (tests/test_torch_tiling.py)
MORAN_RTOL = {"compact": 2.0 ** -8, "exact": 0.0}
MORAN_F16_RTOL = 2.0 ** -11
MORAN_ATOL = 1e-5
QUANTIZED_FLOOR = 0.99999      # tools/demo_mosaic_50k.py:261
# a DEM with at most this share of its pages in the page cache at the
# start counts as read cold
COLD_SHARE = 0.05
# mosaic_terrain_products' settings besides the tile, wire and upload
MOSAIC_KW = dict(cellsize=CELLSIZE, lookup_pixels=LOOKUP,
                 windows=np.array(WINDOWS), gi_radius=GI_RADIUS,
                 slope_threshold=SLOPE_THRESHOLD, device_input=False)
KERNELS = {"K1": "openness_counts_cuda", "K2": "openness_reduced_cuda",
           "K3": "directional_extrema_cuda",
           "K4": "openness_counts_block_cuda",
           "K5/counts": "openness_counts_plan_cuda",
           "K5/reduced": "openness_reduced_plan_cuda"}


def synth_dem(path, n, block=1024, seed=7):
    """Blocked synthetic terrain straight into a memmap: smooth
    low-frequency relief + integrated noise, deterministic per row
    block so generation stays O(block * n) memory (the recipe of
    tools/demo_mosaic_50k.py, byte for byte)."""
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(n, n))
    xs = np.arange(n, dtype=np.float64)
    lowx = (400 * np.sin(xs / 9000) + 150 * np.sin(xs / 1300 + 1.7))
    rng = np.random.default_rng(seed)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        ys = xs[r0:r1][:, None]
        low = (300 * np.cos(ys / 11000) + 120 * np.sin(ys / 1700)
               + lowx[None, :])
        rough = rng.normal(0, 1.5, (r1 - r0, n)).cumsum(axis=1)
        rough -= rough.mean(axis=1, keepdims=True)
        mm[r0:r1] = (low + rough).astype(np.float32)
    mm.flush()
    return mm


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="50000",
                    help="raster side, or a comma list: the first that "
                    "fits on the disk of --dir")
    ap.add_argument("--tile", type=int, default=4096)
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "demo_mosaic_torch"))
    ap.add_argument("--products", default="geomorphons,objects,moran")
    ap.add_argument("--wire", default="compact",
                    choices=("compact", "exact"))
    ap.add_argument("--engine", default=None, choices=("cuda", "torch"),
                    help="the tile program's ladder: the hand-written "
                    "kernel K1 ('cuda', use_pallas=True) or its plain "
                    "PyTorch version ('torch'); default cuda on a card, "
                    "torch on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="where the tiles run; 'cpu' runs the plain "
                    "versions on the host (nothing falls back to it)")
    ap.add_argument("--upload-dtype", default=None,
                    choices=(None, "uint16"),
                    help="quantize the host->device leg to uint16 "
                    "(global-range affine, error <= range/65534)")
    ap.add_argument("--moran-f16", action="store_true",
                    help="store the Moran plane as float16 on disk (the "
                    "compact wire already rounds it to bfloat16)")
    ap.add_argument("--kill-at", type=float, default=None,
                    help="run the mosaic in a child process, SIGKILL it "
                    "once the checkpoint lists this share of the tiles, "
                    "then resume in a second child")
    ap.add_argument("--verify", action="store_true",
                    help="recompute three interior windows untiled and "
                    "compare with the stored planes and the BigTIFF")
    return ap.parse_args(argv)


def out_dtypes(products, moran_f16):
    """One memmap dtype per product (uint8 stands in for the bool objects
    plane: memmap cannot create bool)."""
    dts = {p: (np.dtype(np.uint8) if dt is bool else np.dtype(dt))
           for p, dt in mosaic._OUT_DTYPE.items()}
    if moran_f16:
        dts["moran"] = np.dtype(np.float16)
    return {p: dts[p] for p in products}


def tif_bytes(n):
    """Payload of the tiled BigTIFF of an n x n uint8 plane."""
    return (-(-n // TIF_TILE)) ** 2 * TIF_TILE ** 2


def bytes_needed(d, n, products, moran_f16):
    """Bytes the run still has to write under ``d`` at side ``n``."""
    need = tif_bytes(n)
    if not dem_ready(d, n):
        need += 4 * n * n
    for p, dt in out_dtypes(products, moran_f16).items():
        path = os.path.join(d, f"{p}.out")
        if not (os.path.exists(path)
                and os.path.getsize(path) == dt.itemsize * n * n):
            need += dt.itemsize * n * n
    tif = os.path.join(d, "geomorphons.tif")
    if os.path.exists(tif):
        need -= min(os.path.getsize(tif), tif_bytes(n))
    return need


def products_of(args):
    """``--products`` in the mosaic's own order (that of its outputs)."""
    given = args.products.split(",")
    unknown = set(given) - set(mosaic._PRODUCT_ORDER)
    if unknown:
        raise SystemExit(f"unknown products {sorted(unknown)}")
    return tuple(p for p in mosaic._PRODUCT_ORDER if p in given)


def pick_size(args, products):
    """The first size of ``--size`` that fits on the disk of ``--dir``,
    and what the disk held when it was chosen: the choice is kept in
    ``<dir>/size.json``, so a resumed run or ``--verify`` takes the same
    size whatever the disk holds by then."""
    sizes = [int(s) for s in str(args.size).split(",")]
    path = os.path.join(args.dir, "size.json")
    kept = read_json(path)
    if kept is not None and kept["size"] in sizes:
        return kept["size"], kept["cut"]
    free = shutil.disk_usage(args.dir).free
    needed = {}
    for n in sizes:
        needed[n] = bytes_needed(args.dir, n, products, args.moran_f16)
        if needed[n] < free:
            cut = {"wanted": sizes[0], "free_bytes": free,
                   "needed_bytes": needed}
            with open(path, "w") as f:
                json.dump({"size": n, "cut": cut}, f)
            return n, cut
    raise SystemExit(f"none of the sizes {sizes} fits: {free} bytes free "
                     f"at {args.dir}, {needed} needed")


def dem_ready(d, n):
    # a size check alone is no completeness check: np.memmap(w+) creates
    # the full-size sparse file at once, so a run killed during generation
    # would pass it; completion has its own marker
    path = os.path.join(d, "dem.f32")
    return (os.path.exists(path) and os.path.getsize(path) == 4 * n * n
            and os.path.exists(path + ".done"))


def ensure_dem(d, n):
    """The DEM memmap (read-only), generated first where it is missing."""
    path = os.path.join(d, "dem.f32")
    if not dem_ready(d, n):
        print(f"generating {n}x{n} synthetic DEM -> {path}", flush=True)
        t0 = time.time()
        synth_dem(path, n)
        with open(path + ".done", "w") as f:
            f.write(str(4 * n * n))
        print(f"generated in {time.time() - t0:.0f}s", flush=True)
    return np.memmap(path, dtype=np.float32, mode="r", shape=(n, n))


def open_outputs(d, n, dtypes):
    """One memmap per product, the objects plane viewed as bool."""
    outs = []
    for p, dt in dtypes.items():
        path = os.path.join(d, f"{p}.out")
        mode = "r+" if os.path.exists(path) else "w+"
        o = np.memmap(path, dtype=dt, mode=mode, shape=(n, n))
        outs.append(o.view(bool) if p == "objects" else o)
    return tuple(outs)


def read_json(path):
    """The JSON object in ``path``, or None where there is no such file."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def proc_kib(path, keys):
    """The fields ``keys`` of a /proc file of "Name: value kB" lines, in
    KiB (those the kernel reports)."""
    out = {}
    with open(path) as f:
        for line in f:
            k, v = line.split(":", 1)
            if k in keys:
                out[k] = int(v.split()[0])
    return out


def meminfo(*keys):
    """Fields of /proc/meminfo, in GiB."""
    return {k: v / 2 ** 20 for k, v in proc_kib("/proc/meminfo",
                                                  keys).items()}


def resident_share(a):
    """Share of the pages of memmap ``a`` in the page cache (mincore), or
    None where the call is refused."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        page = os.sysconf("SC_PAGE_SIZE")
        addr = a.ctypes.data
        start = addr - addr % page
        length = addr + a.nbytes - start
        vec = np.zeros(-(-length // page), dtype=np.uint8)
        rc = libc.mincore(ctypes.c_void_p(start), ctypes.c_size_t(length),
                          vec.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            return None
        return float(np.mean(vec & 1))
    except (OSError, AttributeError):
        return None


def page_cache(share):
    """The page cache state a run read its DEM in, from the share of its
    pages resident at the start: "cold", "warm", or None where mincore
    was refused."""
    if share is None:
        return None
    return "cold" if share <= COLD_SHARE else "warm"


class PeakMemory:
    """Within the block, a thread samples memory every ``period`` seconds
    and keeps, in MiB, the peak of each of this process's resident-set
    fields in /proc/self/status (VmRSS; RssAnon, where pinned host buffers
    count, and RssFile, where the memmaps' pages do, where the kernel
    reports them) and of the host's used memory (MemTotal - MemAvailable),
    cached pages and dirty pages (/proc/meminfo)."""

    STATUS = ("VmRSS", "RssAnon", "RssFile", "RssShmem")
    MEMINFO = ("MemTotal", "MemAvailable", "Cached", "Dirty", "Writeback")

    def __init__(self, period=0.5):
        self.period, self._stop = period, threading.Event()
        self.peak = {}
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _keep(self, key, mib):
        self.peak[key] = max(self.peak.get(key, 0.0), mib)

    def sample(self):
        for k, v in proc_kib("/proc/self/status", self.STATUS).items():
            self._keep(k, v / 1024)
        info = {k: v / 1024 for k, v in proc_kib("/proc/meminfo",
                                                 self.MEMINFO).items()}
        if "MemTotal" in info and "MemAvailable" in info:
            self._keep("host_used", info["MemTotal"] - info["MemAvailable"])
        for k in ("Cached", "Dirty", "Writeback"):
            if k in info:
                self._keep(f"host_{k.lower()}", info[k])

    def _sample(self):
        while not self._stop.wait(self.period):
            self.sample()

    def __enter__(self):
        self.sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.sample()


def launches():
    """Each kernel's launches in this process."""
    return {k: getattr(cuda_scan, f).launches for k, f in KERNELS.items()}


def tile_loads():
    """The tile-path launches of this process by tile shape and load path
    (``cuda_scan.tile_loads``)."""
    return {f"{h}x{w} {'tma' if load else 'cp.async'}": c
            for (h, w, load), c in sorted(cuda_scan.tile_loads.items())}


def device_of(args):
    """``--device`` as a torch device, a CUDA one with its index."""
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run "
                               "the plain versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def run(args, n, cut, dev):
    """The mosaic into the output memmaps, then the BigTIFF; returns the
    record (also written to ``<dir>/record.json``)."""
    d = args.dir
    products = products_of(args)
    engine = args.engine or ("cuda" if dev.type == "cuda" else "torch")
    start = {"disk_free_bytes": shutil.disk_usage(d).free,
             "host_ram_gib": meminfo("MemTotal", "MemAvailable")}
    Z = ensure_dem(d, n)
    dtypes = out_dtypes(products, args.moran_f16)
    outs = open_outputs(d, n, dtypes)
    ck = os.path.join(d, "tiles.json")
    done_before = len(ntt.TileCheckpoint(ck).done)

    wall_path = os.path.join(d, "wall.json")
    prior = (read_json(wall_path) or {"wall_s": 0.0})["wall_s"]
    # honest wall accounting across SIGKILL: a start marker survives the
    # kill; on restart the killed run's productive time is recovered as
    # (last checkpoint write - its start)
    start_path = os.path.join(d, "start.json")
    killed = read_json(start_path)
    recovered = 0.0
    if killed is not None and os.path.exists(ck):
        recovered = max(0.0, os.path.getmtime(ck) - killed["t0"])
        prior += recovered
        print(f"recovered {recovered:.0f}s from a killed run", flush=True)
    build_s = 0.0
    if engine == "cuda":
        # nvcc, where the kernels are not built yet, stays outside the wall
        t = time.perf_counter()
        _build.load()
        build_s = time.perf_counter() - t
    dem_resident = resident_share(Z)
    t0 = time.time()
    with open(start_path, "w") as f:
        json.dump({"t0": t0}, f)

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    quantize = args.upload_dtype == "uint16"
    moments_cached = os.path.exists(ck + ".moments")
    pass_path = os.path.join(d, "moments_pass.json")
    ps = {}
    with PeakMemory() as mem:
        t = time.perf_counter()
        if {"moran", "gi"} & set(products) or quantize:
            mosaic._global_moments(Z, ck, quantize, dev)
        moments_s = time.perf_counter() - t
        if not moments_cached:
            # kept for the record of a run that resumes after a kill
            with open(pass_path, "w") as f:
                json.dump({"seconds": moments_s, "gb_per_s":
                           Z.nbytes / 1e9 / max(moments_s, 1e-9),
                           "dem_resident_share_at_start": dem_resident,
                           "page_cache": page_cache(dem_resident)}, f)
        for f in KERNELS.values():
            getattr(cuda_scan, f).launches = 0
        cuda_scan.tile_loads.clear()
        t = time.perf_counter()
        res = ntt.mosaic_terrain_products(
            Z, tile_size=args.tile, checkpoint=ck, out=outs,
            products=products, wire=args.wire, progress=True,
            use_pallas=(engine == "cuda"), upload_dtype=args.upload_dtype,
            phase_stats=ps, device=dev, **MOSAIC_KW)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mosaic_s = time.perf_counter() - t
        counted, loads = launches(), tile_loads()
        card_memory = None
        if dev.type == "cuda":
            card_memory = {
                "device_peak_mib": torch.cuda.max_memory_allocated(dev)
                / 2 ** 20,
                "pinned_host": {k: v for k, v in
                                getattr(torch.cuda, "host_memory_stats",
                                        dict)().items()
                                if "bytes" in k}}
        for o in res:
            o.flush()
    wall = prior + (time.time() - t0)
    with open(wall_path, "w") as f:
        json.dump({"wall_s": wall}, f)
    os.remove(start_path)
    print(f"mosaic complete: cumulative wall {wall:.0f}s "
          f"({n * n / 1e6 / wall:.1f} Mpix/s)", flush=True)

    bigtiff_s = bigtiff_gib = None
    if "geomorphons" in products:
        tif = os.path.join(d, "geomorphons.tif")
        t = time.time()
        write_classes(tif, res[products.index("geomorphons")], n)
        bigtiff_s = time.time() - t
        bigtiff_gib = os.path.getsize(tif) / 2 ** 30
        print(f"BigTIFF written in {bigtiff_s:.0f}s ({bigtiff_gib:.2f} GiB)",
              flush=True)

    ts = args.tile
    ov = mosaic.required_overlap(LOOKUP, np.array(WINDOWS), GI_RADIUS,
                                 products)
    rec = {
        "metric": "mosaic_disk_to_disk", "size": n, "pixels": n * n,
        "size_cut": cut if n != cut["wanted"] else None,
        "products": list(products), "tile": ts, "overlap": ov,
        "tile_px": ts + 2 * ov, "tiles": (-(-n // ts)) ** 2,
        "lookup_pixels": LOOKUP, "cellsize": CELLSIZE,
        "windows": list(WINDOWS), "gi_radius": GI_RADIUS,
        "wire": args.wire, "upload_dtype": args.upload_dtype,
        "dtypes": {p: str(dt) for p, dt in dtypes.items()},
        "engine": engine, "device": str(dev),
        "wall_s": wall, "mpix_s": n * n / 1e6 / wall,
        "recovered_s": recovered,
        "moments_pass": read_json(pass_path),
        "this_run": {"build_s": build_s, "tiles_done_before": done_before,
                     "tiles": ps.get("tiles"), "moments_s": moments_s,
                     "moments_cached": moments_cached,
                     "mosaic_s": mosaic_s, "phase_stats": ps,
                     "launches": counted, "tile_loads": loads,
                     "dem_resident_share_at_start": dem_resident,
                     "page_cache": page_cache(dem_resident),
                     "host_peak_mib": mem.peak, "card_memory": card_memory,
                     "host_maxrss_mib": resource.getrusage(
                         resource.RUSAGE_SELF).ru_maxrss / 1024},
        "bigtiff_s": bigtiff_s, "bigtiff_gib": bigtiff_gib,
        "card": card_line() if dev.type == "cuda" else None,
        "start": start,
        "end": {"disk_free_bytes": shutil.disk_usage(d).free,
                "host_ram_gib": meminfo("MemAvailable", "Dirty",
                                        "Writeback", "Cached")},
        "torch": torch.__version__, "date": time.strftime("%Y-%m-%d"),
    }
    with open(os.path.join(d, "record.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


def write_classes(path, G, n):
    """The class plane as a tiled BigTIFF (8-byte offsets at any size),
    streamed from its memmap."""
    ntt.write_geotiff(path, G, transform=ntt.from_origin(
        0, n * CELLSIZE, CELLSIZE, CELLSIZE), crs=32633, tiled=True,
        tile_size=TIF_TILE, bigtiff=True)


def verify_windows(n, w=VERIFY_WINDOW, seed=0):
    """The (row, col) of each checked window: seeded, interior, with a
    margin of 2 x lookup."""
    rng = np.random.default_rng(seed)
    m = 2 * LOOKUP
    return [(int(rng.integers(m, n - w - m - 1)),
             int(rng.integers(m, n - w - m - 1))) for _ in range(3)]


def verify(Z, d, n, products, device, upload_dtype=None, wire="compact",
           window=VERIFY_WINDOW, seed=0):
    """Recompute each window of ``verify_windows`` untiled on ``device``
    (with enough margin that the tile seams do not matter) and hold the
    stored planes to it: classes (``geomorphons``) and object cells
    (``progressive_filter``) exactly, Moran (``local_morans_i`` on the
    run's moments) within ``wire``'s rounding (``MORAN_RTOL``) plus that
    of a float16 plane, NaN at the same cells; the BigTIFF window read
    through ``GeoTiffSource`` equal to the class memmap.  For a run with
    the uint16 upload each window is dequantized on the run's lattice
    first, and the classes must agree on >= 0.99999 of it (the device's
    decode and the host's may round a decision tie apart).  Returns 0
    when every check holds, else 1."""
    dev = torch.device(device)
    mom = read_json(os.path.join(d, "tiles.json.moments"))
    planes = {}
    for p in products:
        path = os.path.join(d, f"{p}.out")
        dt = np.uint8
        if p == "moran":
            dt = {2: np.float16, 4: np.float32}[os.path.getsize(path)
                                                // (n * n)]
        planes[p] = np.memmap(path, dtype=dt, mode="r", shape=(n, n))
    rtol = MORAN_RTOL[wire] + (MORAN_F16_RTOL if "moran" in planes
                               and planes["moran"].dtype == np.float16
                               else 0.0)
    tif = ntt.GeoTiffSource(os.path.join(d, "geomorphons.tif"))
    m = 2 * LOOKUP
    core = np.s_[m:m + window, m:m + window]
    ok = True
    results = []
    for r, c in verify_windows(n, window, seed):
        sub = np.asarray(Z[r - m:r + window + m, c - m:c + window + m])
        if upload_dtype == "uint16":
            sub = mosaic._QuantizedSource(sub, mom["qlo"],
                                          mom["qhi"]).dequantized()
        blk = torch.from_numpy(np.ascontiguousarray(sub)).to(dev)
        sl = np.s_[r:r + window, c:c + window]
        res = {"at": [r, c]}
        got = np.asarray(planes["geomorphons"][sl])
        want = ntt.geomorphons(blk, CELLSIZE, LOOKUP, 1)[core].cpu().numpy()
        res["classes_differ"] = int(np.sum(got != want))
        floor = QUANTIZED_FLOOR if upload_dtype == "uint16" else 1.0
        ok &= 1 - res["classes_differ"] / got.size >= floor
        tif_got = tif[sl]
        res["tif_equals_memmap"] = bool(np.array_equal(tif_got, got))
        ok &= res["tif_equals_memmap"]
        if "objects" in planes:
            want = ntt.progressive_filter(blk, np.array(WINDOWS), CELLSIZE,
                                          SLOPE_THRESHOLD)[core]
            res["objects_differ"] = int(np.sum(
                planes["objects"][sl].view(bool) != want.cpu().numpy()))
            ok &= res["objects_differ"] == 0
        if "moran" in planes:
            want = ntt.local_morans_i(blk, GI_RADIUS, mean=mom["mean"],
                                      s2=mom["s2"])[core].cpu().numpy()
            got = np.asarray(planes["moran"][sl], dtype=np.float32)
            nan_same = bool(np.array_equal(np.isnan(got), np.isnan(want)))
            fin = np.isfinite(want)
            excess = np.abs(got[fin] - want[fin]) - (
                rtol * np.abs(want[fin]) + MORAN_ATOL)
            res["moran_nan_same"] = nan_same
            res["moran_max_abs_diff"] = float(np.max(np.abs(
                got[fin] - want[fin]))) if fin.any() else 0.0
            res["moran_over_tolerance"] = int(np.sum(excess > 0))
            ok &= nan_same and res["moran_over_tolerance"] == 0
        print(f"window {r, c}: {res}", flush=True)
        results.append(res)
    with open(os.path.join(d, "verify.json"), "w") as f:
        json.dump({"ok": bool(ok), "window": window, "wire": wire,
                   "moran_rtol": rtol, "moran_atol": MORAN_ATOL,
                   "windows": results}, f, indent=1)
    print("VERIFY", "OK" if ok else "FAIL", flush=True)
    return 0 if ok else 1


def kill_and_resume(argv, args, n, products):
    """``--kill-at``: run this script without the flag in a child process,
    SIGKILL it once the checkpoint lists ``args.kill_at`` of the tiles,
    then run it again to resume; the record gains the kill."""
    d = args.dir
    n_tiles = (-(-n // args.tile)) ** 2
    target = max(1, math.ceil(args.kill_at * n_tiles))
    ck = os.path.join(d, "tiles.json")
    if len(ntt.TileCheckpoint(ck).done) >= target:
        raise SystemExit(f"{ck} already lists {target} tiles or more")
    ensure_dem(d, n)
    argv = list(argv)
    i = argv.index("--kill-at")
    del argv[i:i + 2]
    cmd = [sys.executable, os.path.abspath(__file__), *argv]
    child = subprocess.Popen(cmd)
    done = 0
    try:
        while child.poll() is None:
            try:
                with open(ck) as f:
                    done = len(json.load(f))
            except (FileNotFoundError, json.JSONDecodeError):
                pass
            if done >= target:
                child.send_signal(signal.SIGKILL)
                break
            time.sleep(0.02)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
    if child.returncode != -signal.SIGKILL:
        raise SystemExit(f"the run ended by itself (rc {child.returncode}) "
                         f"before {target} of {n_tiles} tiles")
    done = len(ntt.TileCheckpoint(ck).done)
    print(f"killed with {done} of {n_tiles} tiles stored", flush=True)
    rc = subprocess.run(cmd).returncode
    if rc:
        return rc
    path = os.path.join(d, "record.json")
    rec = read_json(path)
    rec["killed_at_tiles"] = done
    rec["kill_at"] = args.kill_at
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    dev = device_of(args)
    os.makedirs(args.dir, exist_ok=True)
    products = products_of(args)
    n, cut = pick_size(args, products)
    if args.verify:
        Z = ensure_dem(args.dir, n)
        return verify(Z, args.dir, n, products, dev,
                      upload_dtype=args.upload_dtype, wire=args.wire)
    if args.kill_at is not None:
        return kill_and_resume(argv, args, n, products)
    run(args, n, cut, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
