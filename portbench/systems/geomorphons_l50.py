"""``geomorphons_l50``: ``neilpy_tpu_torch.geomorphons`` on 8192^2 float32
DEMs, lookup 50, cellsize 10, threshold 1 degree.

Traffic keys: ``inputs`` (distinct DEMs, ``bench_input``'s recipe, the
jobs cycling over them), ``placement`` (``device``: the DEMs stay on the
card and a job ends in a synchronise; ``host``: pageable numpy arrays and
a job ends with the classes as a numpy array, the package's default for
numpy input), ``call`` (extra arguments of the call: ``fast``,
``how_fast``), ``sample_outputs`` (how many jobs' outputs are kept for
the judgement, drawn from the seed uniformly over the window by reservoir
sampling).
"""

from __future__ import annotations

import numpy as np
import torch

import neilpy_tpu_torch as ntt

from .. import inputs, roofline


class Cell:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        H, W = cfg["raster"]
        self.pixels_per_job = H * W
        self.call = dict(cellsize=cfg["cellsize"],
                         lookup_pixels=cfg["lookup_pixels"],
                         threshold_angle=cfg["threshold_angle"],
                         enhance=cfg["enhance"], **traffic["call"])
        self.host = traffic["placement"] == "host"
        if traffic["placement"] not in ("device", "host"):
            raise ValueError(f"placement {traffic['placement']!r}")
        Z = inputs.bench_input(traffic["inputs"], (H, W), seed, device)
        self.dems = ([z.cpu().numpy() for z in Z] if self.host
                     else list(Z))
        del Z
        self.rng = np.random.default_rng(seed)
        self.samples = []          # (job, dem index, output)
        self.seen = 0

    def _run(self, k, span):
        Z = self.dems[k % len(self.dems)]
        with span("call"):
            G = ntt.geomorphons(Z, **self.call, device=self.device)
        if self.host:
            with span("readback"):
                return G.cpu().numpy()
        with span("sync"):
            if G.is_cuda:
                torch.cuda.synchronize(G.device)
        return G

    def warm(self, span):
        """One job per distinct DEM (their shapes are one), kept out of
        the window."""
        for k in range(len(self.dems)):
            self._run(k, span)

    def job(self, k, span):
        G = self._run(k, span)
        # reservoir sampling of the outputs the judgement reads
        keep = int(self.traffic["sample_outputs"])
        if len(self.samples) < keep:
            self.samples.append((k, k % len(self.dems), G))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < keep:
                self.samples[j] = (k, k % len(self.dems), G)
        self.seen += 1
        return None

    def work(self):
        H, W = self.cfg["raster"]
        return roofline.geomorphons_work(
            H, W, self.cfg["lookup_pixels"],
            fast=bool(self.call.get("fast", False)),
            how_fast=int(self.call.get("how_fast", 20)))

    def counters(self):
        return {}

    def _reference(self, reference, dtype):
        """Reference classes of every DEM a sample used, on the device."""
        out = {}
        for i in sorted({i for _, i, _ in self.samples}):
            Z = self.dems[i]
            Z = torch.from_numpy(Z) if self.host else Z
            out[i] = reference.classes_of(Z.to(self.device), self.cfg,
                                          self.traffic["call"], dtype)
        return out

    def judge(self, reference, limits):
        """({number: value}, jobs failed) over the sampled jobs."""
        want = self._reference(reference, torch.float32)
        diff, failed = 0, 0
        for _, i, G in self.samples:
            d = reference.class_diff_px(torch.as_tensor(G), want[i])
            diff += d
            failed += d > limits["class_diff_px"]
        return {"class_diff_px": diff}, failed

    def control(self, reference, limits):
        """The reference in bfloat16 put in the program's place on the
        sampled jobs' DEMs, judged as the program is."""
        low = self._reference(reference, torch.bfloat16)
        self.samples = [(k, i, low[i]) for k, i, _ in self.samples]
        return self.judge(reference, limits)

    def close(self):
        self.samples.clear()
        self.dems.clear()
