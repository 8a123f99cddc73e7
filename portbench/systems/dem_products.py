"""``dem_products``: the landslide-mapping layers of one DTM tile,
``neilpy_tpu_torch.hillshade``, ``esri_curvature`` and
``shi_landslides`` at radii (5, 13), on 8192^2 float32 DEMs with NaN
voids, cellsize 10.

Traffic keys: ``inputs`` (distinct DEMs, ``bench_input``'s recipe with
seeded NaN discs, the jobs cycling over them), ``placement`` (``device``
only: the DEMs stay on the card and a job ends in a synchronise),
``call`` (must be empty), ``sample_outputs`` (how many jobs' outputs are
kept for the judgement, drawn from the seed uniformly over the window by
reservoir sampling).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

import neilpy_tpu_torch as ntt

from .. import inputs

# One job's least work a pixel, whatever computes it (``dem_work``).
# Footprint sums: a sliding window's add and subtract a footprint row, for
# the finite count and the value sum of each radius.
SUM_OPS_PER_ROW = 2
SUMS_PER_RADIUS = 2
# The elementwise formulas of ``reference/dem_products.py``, a multiply
# feeding an add counted as one, a compare, select, cast or elementary
# function (sqrt, atan, atan2, sin, cos, erfc) as one, a shared
# subexpression once:
# - hillshade: two gradient pairs (sub, scale) 8; S = atan(sqrt(gx gx +
#   gy gy)) 4; the aspect (neg, atan2, sub; A < 0: cmp, add, select; flat:
#   2 cmp, and, select) 10; cos z cos S + sin z sin S cos(az - A) 7; the
#   clip at 0 1; 255 H, round, NaN -> 0 (2), clamp (2), cast 7
HILLSHADE_OPS = 8 + 4 + 10 + 7 + 1 + 7
# - ESRI: 8 NaN neighbours to the centre (isnan, select) 16; D, E (add,
#   fma, scale) 6; F (3 adds, scale) 4; G, H (sub, scale) 4; GG, HH, GH
#   3; GG + HH 1; K (add, scale) 2; K_plan, K_profile (mul, 2 fma, scale,
#   div; NaN -> 0: isnan, select) 14
ESRI_OPS = 16 + 6 + 4 + 4 + 3 + 1 + 2 + 14
# - Evans/Wood K_tan: 8 reflection fills (isnan, fma, select) 24; A, B
#   (7 adds, 2 scales) 18; C (3 adds, scale) 4; D, E (5 adds, scale) 12;
#   DD, EE, P, DE, A EE, + B DD, C DE, -2 C DE +, sign 9; P sqrt(P + 1)
#   and the division 4; 0 where NaN on a finite centre (isnan, isfinite,
#   and, select) 4
EVANS_TAN_OPS = 24 + 18 + 4 + 12 + 9 + 4 + 4
# - Gi*: once (finite, the zeroed values, their cast 3; count, sum, the
#   centred square's sub and fma 4); a radius: s - w gm 1, sqrt(w k (nf -
#   w)) 4, the division 1, NaN off finite 1, P = erfc(|z| / sqrt 2) 3, P <
#   .01 and z < 0 3, the mask's or 1
GI_SHARED_OPS = 3 + 4
GI_RADIUS_OPS = 1 + 4 + 1 + 1 + 3 + 3 + 1
# bytes a pixel: the DEM read once a call (3 calls), the hillshade
# (uint8), three float32 curvatures and the mask (bool) written once
BYTES_PER_PIXEL = 3 * 4 + 1 + 3 * 4 + 1


def dem_work(H, W, radii):
    """Operations and bytes of one job on an (H, W) float32 raster: the
    footprint sums of each radius (its disk's 2r + 1 rows) and the three
    products' elementwise formulas a pixel; the DEM read once a call and
    each output written once."""
    sums = sum(SUMS_PER_RADIUS * SUM_OPS_PER_ROW * (2 * r + 1)
               for r in radii)
    per_pixel = (sums + HILLSHADE_OPS + ESRI_OPS + EVANS_TAN_OPS
                 + GI_SHARED_OPS + GI_RADIUS_OPS * len(radii))
    return {"ops": per_pixel * H * W, "bytes": BYTES_PER_PIXEL * H * W}


def voids(n, shape, seed, share, radius, device):
    """(n, H, W) bool: per raster, discs of radii drawn uniformly from
    ``radius`` (lo, hi) at uniform centres (clipped by the edges), as
    many as cover about ``share`` of the raster (before overlaps)."""
    H, W = shape
    lo, hi = radius
    mean_area = math.pi * ((hi ** 3 - lo ** 3) / (3 * (hi - lo)) if hi > lo
                           else lo * lo)
    count = max(1, round(share * H * W / mean_area))
    rng = np.random.default_rng([seed, 1])
    rows = torch.arange(H, device=device)[:, None]
    cols = torch.arange(W, device=device)[None, :]
    out = torch.zeros((n, H, W), dtype=torch.bool, device=device)
    for i in range(n):
        for r, cy, cx in zip(rng.uniform(lo, hi, count),
                             rng.integers(0, H, count),
                             rng.integers(0, W, count)):
            k = math.ceil(r)
            r0, r1 = max(0, cy - k), min(H, cy + k + 1)
            c0, c1 = max(0, cx - k), min(W, cx + k + 1)
            out[i, r0:r1, c0:c1] |= ((rows[r0:r1] - cy) ** 2
                                     + (cols[:, c0:c1] - cx) ** 2 <= r * r)
    return out


class Cell:
    def __init__(self, cfg, traffic, seed, device):
        if traffic["placement"] != "device":
            raise ValueError(f"placement {traffic['placement']!r}: "
                             "dem_products keeps its DEMs on the device")
        if traffic["call"]:
            raise ValueError(f"call {traffic['call']!r}: dem_products "
                             "takes no extra arguments")
        self.cfg, self.traffic, self.device = cfg, traffic, device
        H, W = cfg["raster"]
        self.pixels_per_job = H * W
        n = traffic["inputs"]
        Z = inputs.bench_input(n, (H, W), seed, device)
        Z[voids(n, (H, W), seed, cfg["voids"]["share"],
                cfg["voids"]["radius"], device)] = math.nan
        self.dems = list(Z)
        del Z
        self.rng = np.random.default_rng(seed)
        self.samples = []          # (job, dem index, outputs)
        self.seen = 0

    def _run(self, k, span):
        Z = self.dems[k % len(self.dems)]
        cfg = self.cfg
        with span("call"):
            shade = ntt.hillshade(Z, cfg["cellsize"])
            curv = ntt.esri_curvature(Z, cfg["cellsize"])
            mask = ntt.shi_landslides(Z, cfg["radii"], cfg["cellsize"])
        with span("sync"):
            if mask.is_cuda:
                torch.cuda.synchronize(mask.device)
        return shade, curv, mask

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
        return dem_work(H, W, self.cfg["radii"])

    def counters(self):
        return {}

    def judge(self, reference, limits):
        """({number: value}, jobs failed) over the sampled jobs, against
        the float64 reference, each DEM's computed once; the float64
        mask's share of the finite pixels goes to standard error."""
        total = {k: 0 for k in limits}
        failed = 0
        for i in sorted({i for _, i, _ in self.samples}):
            want = reference.products(self.dems[i], self.cfg)
            print(f"dem_products: DEM {i}: the float64 mask covers "
                  f"{reference.mask_share(want):.4f}% of the finite pixels",
                  file=sys.stderr)
            for _, j, got in self.samples:
                if j != i:
                    continue
                numbers = reference.differences(got, want, self.dems[i],
                                                self.cfg)
                failed += any(v > limits[k] for k, v in numbers.items())
                for k, v in numbers.items():
                    total[k] = (total[k] + v if k.endswith("_px")
                                else max(total[k], v))
            del want
        return total, failed

    def control(self, reference, limits):
        """The reference in bfloat16 put in the program's place on the
        sampled jobs' DEMs, judged as the program is."""
        low = {}
        for i in sorted({i for _, i, _ in self.samples}):
            out = reference.products(self.dems[i], self.cfg, torch.bfloat16)
            low[i] = (out["hillshade"], out["curvature"], out["mask"])
        self.samples = [(k, i, low[i]) for k, i, _ in self.samples]
        return self.judge(reference, limits)

    def close(self):
        self.samples.clear()
        self.dems.clear()
