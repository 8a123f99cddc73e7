"""``openness_l50``: ``neilpy_tpu_torch.openness_pair`` and
``neilpy_tpu_torch.skyview_factor`` on 8192^2 float32 DEMs, lookup 50,
cellsize 10, the exact ladder: the relief-visualisation set of positive
and negative openness and the sky-view factor.

Traffic keys: ``inputs`` (distinct DEMs, ``bench_input``'s recipe, the
jobs cycling over them), ``placement`` (``device`` only: the DEMs stay on
the card and a job ends in a synchronise), ``call`` (must be empty:
``skyview_factor`` has no fast ladder, so a job keeps one route),
``sample_outputs`` (how many jobs' outputs are kept for the judgement,
drawn from the seed uniformly over the window by reservoir sampling).
"""

from __future__ import annotations

import numpy as np
import torch

import neilpy_tpu_torch as ntt

from .. import inputs, roofline
from ..reference.plain import scan_ladder

# K2's fold per pixel and direction in operations, copied from
# ``chip_smoke.py`` (``ATAN_OPS``, ``ATAN_FMAS``, ``FOLD_OPS``): counted
# as elementwise operations of the TPU kernel's own body, a multiply whose
# one use is an add or a subtract counted with it as one (an FMA).
# Openness: two atans (ATAN_OPS less ATAN_FMAS such pairs each) plus seen,
# two subtractions from pi/2, -mn, two selects and two accumulates; svf:
# max, 1 + t*t, sqrt, div, accumulate
ATAN_OPS = 28
ATAN_FMAS = 4
FOLD_OPS = {"openness": 2 * (ATAN_OPS - ATAN_FMAS) + 8, "svf": 5}
# operations per ladder step: sub, mul, max, min for the pair; svf needs
# no min
STEP_OPS = {"openness": roofline.OPS_PER_STEP, "svf": 3}
# bytes a pixel: the DEM read once, float32 outputs written once
BYTES = {"openness": 4 + 2 * 4, "svf": 4 + 4}


def relief_work(H, W, lookup_pixels):
    """Operations and bytes of one ``openness_pair`` and one
    ``skyview_factor`` call on an (H, W) float32 raster on the exact
    ladder: per call its operations per ladder step and its fold over 8
    directions a pixel, the DEM read once and its outputs written once."""
    steps = roofline.ladder_steps(H, W, scan_ladder(lookup_pixels))
    return {"ops": sum(STEP_OPS[m] * steps + FOLD_OPS[m] * 8 * H * W
                       for m in ("openness", "svf")),
            "bytes": sum(BYTES.values()) * H * W}


class Cell:
    def __init__(self, cfg, traffic, seed, device):
        if traffic["placement"] != "device":
            raise ValueError(f"placement {traffic['placement']!r}: "
                             "openness_l50 keeps its DEMs on the device")
        if traffic["call"]:
            raise ValueError(f"call {traffic['call']!r}: openness_l50 "
                             "takes no extra arguments")
        self.cfg, self.traffic, self.device = cfg, traffic, device
        H, W = cfg["raster"]
        self.pixels_per_job = H * W
        self.call = dict(cellsize=cfg["cellsize"],
                         lookup_pixels=cfg["lookup_pixels"])
        self.dems = list(inputs.bench_input(traffic["inputs"], (H, W),
                                            seed, device))
        self.rng = np.random.default_rng(seed)
        self.samples = []          # (job, dem index, (pos, neg, svf))
        self.seen = 0

    def _run(self, k, span):
        Z = self.dems[k % len(self.dems)]
        with span("call"):
            pos, neg = ntt.openness_pair(Z, **self.call)
            svf = ntt.skyview_factor(Z, **self.call)
        with span("sync"):
            if svf.is_cuda:
                torch.cuda.synchronize(svf.device)
        return pos, neg, svf

    def warm(self, span):
        """One job per distinct DEM (their shapes are one), kept out of
        the window."""
        for k in range(len(self.dems)):
            self._run(k, span)

    def job(self, k, span):
        out = self._run(k, span)
        # reservoir sampling of the outputs the judgement reads
        keep = int(self.traffic["sample_outputs"])
        if len(self.samples) < keep:
            self.samples.append((k, k % len(self.dems), out))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < keep:
                self.samples[j] = (k, k % len(self.dems), out)
        self.seen += 1
        return None

    def work(self):
        H, W = self.cfg["raster"]
        return relief_work(H, W, self.cfg["lookup_pixels"])

    def counters(self):
        return {}

    def judge(self, reference, limits):
        """({number: value}, jobs failed) over the sampled jobs, against
        the float64 reference, each DEM's computed once."""
        total = {k: 0 for k in limits}
        failed = 0
        for i in sorted({i for _, i, _ in self.samples}):
            want = reference.relief(self.dems[i], self.cfg)
            for _, j, got in self.samples:
                if j != i:
                    continue
                numbers = reference.differences(got, want)
                failed += any(v > limits[k] for k, v in numbers.items())
                for k, v in numbers.items():
                    total[k] = (total[k] + v if k == "unseen_mismatch_px"
                                else max(total[k], v))
            del want
        return total, failed

    def control(self, reference, limits):
        """The reference in bfloat16 put in the program's place on the
        sampled jobs' DEMs, judged as the program is."""
        low = {i: reference.relief(self.dems[i], self.cfg, torch.bfloat16)
               for i in sorted({i for _, i, _ in self.samples})}
        self.samples = [(k, i, low[i]) for k, i, _ in self.samples]
        return self.judge(reference, limits)

    def close(self):
        self.samples.clear()
        self.dems.clear()
