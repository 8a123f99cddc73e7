"""``mosaic_trio``: ``neilpy_tpu_torch.mosaic_terrain_products`` (the
config-5 trio: geomorphon classes, SMRF object cells, local Moran's I)
streamed tile by tile from a float32 ``np.memmap`` into host arrays.

Set-up makes the DEM on the device (``inputs.synth_dem``), writes it to a
file under the temporary directory (``TMPDIR``; removed by ``close``) and
maps it read-only, and allocates the three outputs once and pre-faults
them.  A job is one whole call: the moments pass, then the tile loop.

Traffic keys: ``placement`` (``memmap``), ``sample_pixels_per_tile``
(before each job that many seeded pixels of every tile are poisoned in
the class and Moran outputs, after it their values are kept: every
job's own answers at those pixels are judged, and the last job's whole
outputs), ``call`` (extra arguments of the call).
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

import neilpy_tpu_torch as ntt

from .. import inputs

_PHASES = ("host_read", "upload", "dispatch", "readback_wait",
           "store_wait", "total", "tiles")


class Cell:
    def __init__(self, cfg, traffic, seed, device):
        if traffic["placement"] != "memmap":
            raise ValueError(f"placement {traffic['placement']!r}")
        self.cfg, self.traffic, self.device = cfg, traffic, device
        n = int(cfg["extent"])
        self.pixels_per_job = n * n
        self.kw = dict(cellsize=cfg["cellsize"],
                       lookup_pixels=cfg["lookup_pixels"],
                       threshold_angle=cfg["threshold_angle"],
                       windows=np.array(cfg["windows"]),
                       gi_radius=cfg["gi_radius"],
                       slope_threshold=cfg["slope_threshold"],
                       tile_size=cfg["tile_size"], wire=cfg["wire"],
                       device_input=cfg["device_input"],
                       products=tuple(cfg["products"]), **traffic["call"])
        self.dir = tempfile.mkdtemp(prefix="portbench-")
        path = os.path.join(self.dir, "dem.f32")
        Z = inputs.synth_dem(n, seed, device)
        mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(n, n))
        for r0 in range(0, n, 2048):
            mm[r0:r0 + 2048] = Z[r0:r0 + 2048].cpu().numpy()
        # written back in the set-up, not during the window
        mm.flush()
        del mm, Z
        self.Z = np.memmap(path, dtype=np.float32, mode="r", shape=(n, n))
        self.outs = tuple(np.empty((n, n), dtype=dt)
                          for dt in (np.uint8, bool, np.float32))
        for o in self.outs:
            o.fill(0)                          # pre-fault every page
        self.rng = np.random.default_rng(seed)
        self.samples = []                      # (rows, cols, classes, moran)
        self.stats = {}

    def _call(self, stats, **extra):
        return ntt.mosaic_terrain_products(
            self.Z, out=self.outs, phase_stats=stats, device=self.device,
            **{**self.kw, **extra})

    def warm(self, span):
        with span("call"):
            self._call({})

    def _positions(self):
        n, ts = int(self.cfg["extent"]), int(self.cfg["tile_size"])
        k = int(self.traffic["sample_pixels_per_tile"])
        rows, cols = [], []
        for r0 in range(0, n, ts):
            for c0 in range(0, n, ts):
                rows += list(r0 + self.rng.integers(0, min(ts, n - r0), k))
                cols += list(c0 + self.rng.integers(0, min(ts, n - c0), k))
        return np.array(rows), np.array(cols)

    def job(self, k, span):
        rows, cols = self._positions()
        with span("poison"):
            self.outs[0][rows, cols] = 0
            self.outs[2][rows, cols] = np.nan
        ps = {}
        with span("call"):
            self._call(ps)
        self.samples.append((rows, cols, self.outs[0][rows, cols].copy(),
                             self.outs[2][rows, cols].copy()))
        for name in _PHASES:
            self.stats[name] = self.stats.get(name, 0.0) + ps.get(name, 0.0)
        # the call's last phase_stats['total'] seconds are the tile loop
        return {"split": ("moments", "tile loop", ps.get("total", 0.0))}

    def work(self):
        return None

    def counters(self):
        return dict(self.stats)

    def judge(self, reference, limits):
        """({number: value}, jobs failed): the last job's whole outputs
        and every job's sampled pixels against the reference."""
        n = int(self.cfg["extent"])
        dev = self.device
        ref_c = torch.empty((n, n), dtype=torch.uint8, device=dev)
        ref_m = torch.empty((n, n), dtype=torch.float64, device=dev)
        class_diff = object_diff = 0
        moran_err = 0.0
        for (r0, r1, c0, c1), c, o, m in reference.products(
                self.Z, self.cfg, dev):
            core = np.s_[r0:r1, c0:c1]
            class_diff += int((torch.from_numpy(self.outs[0][core]).to(dev)
                               != c).sum())
            object_diff += int((torch.from_numpy(self.outs[1][core]).to(dev)
                                != o).sum())
            got = torch.from_numpy(self.outs[2][core]).to(dev).double()
            moran_err = max(moran_err, _max_err(got, m))
            ref_c[core], ref_m[core] = c, m
        scale = float(torch.nan_to_num(ref_m.abs(), nan=0.0).max()) or 1.0
        failed = 0
        for rows, cols, c, m in self.samples:
            ri = torch.from_numpy(rows).to(dev)
            ci = torch.from_numpy(cols).to(dev)
            d = int((torch.from_numpy(c).to(dev) != ref_c[ri, ci]).sum())
            e = _max_err(torch.from_numpy(m).to(dev).double(),
                         ref_m[ri, ci]) / scale
            class_diff += d
            moran_err = max(moran_err, e * scale)
            failed += d > limits["class_diff_px"] or \
                e > limits["moran_rel_err"]
        return {"class_diff_px": class_diff, "object_diff_px": object_diff,
                "moran_rel_err": moran_err / scale}, failed

    def control(self, reference, limits):
        """The program's own lower precision: the compact wire, which
        ships Moran as bfloat16; one call, judged as the timed path."""
        self.samples.clear()
        self._call({}, wire="compact")
        return self.judge(reference, limits)

    def close(self):
        self.samples.clear()
        self.Z = self.outs = None
        shutil.rmtree(self.dir, ignore_errors=True)


def _max_err(got, want):
    """max |got - want|: NaN against NaN is equal, NaN against a number
    (or a number against NaN) is an infinite error."""
    if got.numel() == 0:
        return 0.0
    a, b = torch.isnan(got), torch.isnan(want)
    err = torch.where(a | b, torch.where(a & b, 0.0, torch.inf),
                      torch.abs(got - want))
    return float(err.max())
