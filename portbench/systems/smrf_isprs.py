"""``smrf_isprs``: ``neilpy_tpu_torch.smrf`` on one 5,000,000-point lidar
tile a job, at the parameters Pingel et al. (2013) found best over the
ISPRS filter test (PDAL ``filters.smrf``'s defaults): cellsize 1,
windows 18, slope 0.15, elevation threshold 0.5, scaler 1.25; the
package's defaults otherwise (``precision='fast'``, ``chunk_points``).

A job is one public call on float64 host arrays, as a LAS reader gives
them, with the labels and the DTM back as numpy arrays.

Traffic keys: ``inputs`` (distinct clouds, ``lidar_tile``'s recipe from
the seed, the jobs cycling over them), ``call`` (extra arguments of the
call), ``sample_outputs`` (how many jobs' outputs are judged, drawn from
the seed uniformly over the window by reservoir sampling).
"""

from __future__ import annotations

import numpy as np
import torch

import neilpy_tpu_torch as ntt

_CALL_KEYS = ("cellsize", "windows", "slope_threshold",
              "elevation_threshold", "elevation_scaler")


def lidar_tile(rng, n, side, x0=500000.0, y0=4200000.0):
    """(x, y, z) float64: a synthetic lidar tile (``chip_smoke.py``'s
    ``lidar_tile`` on the generator ``rng``): ``n`` points uniform over
    ``side`` x ``side`` metres of UTM-like coordinates, on rolling ground
    (slopes under ~0.12), about 10% of them on flat-roofed box buildings
    10-24 m wide and 4-15 m high, about 10% scattered canopy returns 2-20
    m above the ground, and 5 cm of noise."""
    u = rng.uniform(0, side, n)
    v = rng.uniform(0, side, n)
    k = 2 * np.pi / side
    z = (100 + 0.01 * side * (np.sin(1.3 * k * u + 0.7) * np.cos(0.9 * k * v)
                              + 0.5 * np.sin(2.3 * k * v)) + 0.02 * u)
    cells = int(np.ceil(side))
    roof = np.zeros((cells, cells), np.float32)
    nb = int(0.1 * side * side / 300)
    for cx, cy, hw, hh, ht in zip(rng.uniform(0, side, nb),
                                  rng.uniform(0, side, nb),
                                  rng.uniform(5, 12, nb),
                                  rng.uniform(5, 12, nb),
                                  rng.uniform(4, 15, nb)):
        roof[max(int(cy - hh), 0):int(cy + hh),
             max(int(cx - hw), 0):int(cx + hw)] = ht
    height = roof[np.minimum(v.astype(np.int64), cells - 1),
                  np.minimum(u.astype(np.int64), cells - 1)]
    building = height > 0
    canopy = ~building & (rng.random(n) < 0.11)
    z = (z + height + np.where(canopy, rng.uniform(2, 20, n), 0.0)
         + rng.normal(0, 0.05, n))
    return x0 + u, y0 + v, z


class Cell:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.call = {**{k: cfg[k] for k in _CALL_KEYS}, **traffic["call"]}
        seq = np.random.SeedSequence(int(seed) % 2 ** 64)
        self.clouds = [
            lidar_tile(np.random.default_rng(s), int(cfg["points"]),
                       float(cfg["extent"]))
            for s in seq.spawn(int(traffic["inputs"]))]
        self.pixels_per_job = None
        self.rng = np.random.default_rng(seq.spawn(1)[0])
        self.samples = []          # (job, cloud index, labels, dtm)
        self.seen = 0

    def _run(self, k, span):
        x, y, z = self.clouds[k % len(self.clouds)]
        with span("call"):
            dtm, _, _, labels = ntt.smrf(x, y, z, device=self.device,
                                         **self.call)
        with span("readback"):
            return labels.cpu().numpy(), dtm.cpu().numpy()

    def warm(self, span):
        """One job per distinct cloud, kept out of the window; the first
        sets the pixels of a job, the cells of its DTM."""
        for k in range(len(self.clouds)):
            _, dtm = self._run(k, span)
            if self.pixels_per_job is None:
                self.pixels_per_job = dtm.size

    def job(self, k, span):
        labels, dtm = self._run(k, span)
        # reservoir sampling of the outputs the judgement reads
        keep = int(self.traffic["sample_outputs"])
        sample = (k, k % len(self.clouds), labels, dtm)
        if len(self.samples) < keep:
            self.samples.append(sample)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < keep:
                self.samples[j] = sample
        self.seen += 1
        return None

    def work(self):
        return None

    def counters(self):
        return {}

    def _reference(self, reference, dtype):
        """The reference's answer for every cloud a sample used."""
        return {i: reference.smrf(*self.clouds[i], self.cfg, self.device,
                                  dtype)
                for i in sorted({i for _, i, _, _ in self.samples})}

    def judge(self, reference, limits):
        """({number: value}, jobs failed): each number the worst over the
        sampled jobs."""
        want = self._reference(reference, torch.float64)
        numbers = {"label_diff_ppm": 0.0, "dtm_cells_off_ppm": 0.0,
                   "label_count_diff": 0}
        failed = 0
        for _, i, labels, dtm in self.samples:
            got = compare(labels, dtm, want[i], self.device,
                          float(self.cfg["dtm_tolerance_m"]))
            for name, v in got.items():
                numbers[name] = max(numbers[name], v)
            failed += any(v > limits[name] for name, v in got.items())
        return numbers, failed

    def control(self, reference, limits):
        """The reference with its raster stage in bfloat16 put in the
        program's place on the sampled jobs' clouds, judged as the program
        is."""
        low = self._reference(reference, torch.bfloat16)
        self.samples = [(k, i, low[i]["labels"].cpu().numpy(),
                         low[i]["dtm"].float().cpu().numpy())
                        for k, i, _, _ in self.samples]
        return self.judge(reference, limits)

    def close(self):
        self.samples.clear()
        self.clouds.clear()


def compare(labels, dtm, want, device, tolerance):
    """The checks of one job's outputs against the reference's ``want``:
    ``label_diff_ppm``, points labelled otherwise per million points (a
    point missing or extra counts as differing); ``dtm_cells_off_ppm``,
    DTM cells further than ``tolerance`` metres from the reference's (or
    NaN where it is not, or missing) per million cells;
    ``label_count_diff``, points missing or extra plus DTM cells missing
    or extra."""
    ref_labels, ref_dtm = want["labels"], want["dtm"]
    n, m = ref_labels.numel(), ref_dtm.numel()
    got = torch.from_numpy(np.asarray(labels).reshape(-1)).to(device)
    k = min(got.numel(), n)
    missing = abs(got.numel() - n)
    diff = int((got[:k] != ref_labels[:k]).sum()) + missing
    count = missing
    if tuple(np.shape(dtm)) == tuple(ref_dtm.shape):
        D = torch.from_numpy(np.asarray(dtm)).to(device).double()
        off = ~(torch.abs(D - ref_dtm) <= tolerance)
        cells = int(off.sum())
    else:
        cells = m
        count += abs(int(np.size(dtm)) - m) or m
    return {"label_diff_ppm": 1e6 * diff / max(n, 1),
            "dtm_cells_off_ppm": 1e6 * cells / max(m, 1),
            "label_count_diff": count}
