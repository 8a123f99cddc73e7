"""Plain reference of ``openness_l50``: positive and negative openness
(Yokoyama, Shirasawa & Pike 2002) and the sky-view factor (Zaksek, Ostir
& Kokalj 2011) of a float32 DEM over the 8 azimuths, at lookup 50 on the
dense ladder 1..50, in ``dtype`` (float64 for the judgement; bfloat16 for
the control).  Plain PyTorch: nothing of the port, nothing of JAX.

Per direction d and ladder entry L the slope ratio is ``(Z[p + d*L] -
Z[p]) / (cellsize * w_d * L)`` (``w_d`` the step length, sqrt 2 on the
diagonals), divided in ``dtype`` (the port multiplies by a float32 scale
table instead); ``mx_d`` / ``mn_d`` are its running max / min, NaN and
off-raster reads skipped, and where the ladder's last step leaves the
raster ``mx_d >= 0`` and ``mn_d <= 0`` (``plain.extrema``'s edge rule).
Then

- positive openness = mean_d(pi/2 - atan(mx_d)) in degrees, negative
  openness = mean_d(pi/2 - atan(-mn_d)), +inf where a direction saw
  nothing (every read NaN);
- sky-view factor = 1 - mean_d(t / sqrt(1 + t^2)), ``t = max(mx_d, 0)``.

Departures from the reference (neilpy.py:1325-1384): its ``openness``
keeps the least zenith angle over the ladder, here ``pi/2 - atan`` of
the greatest ratio (the same number, atan being increasing); its shifts
read the pixel itself (openness: a ratio of 0) or the ray's exit
elevation (``skyview_factor``) where a step leaves the raster, here such
reads are skipped and the edge rule gives the same openness and, after
the clip at 0, the same SVF; a NaN read is skipped, as the package does.
The directions are worked one at a time so that the float64 planes fit
beside a run's kept outputs.
"""

from __future__ import annotations

import math

import torch

from .plain import OFFSETS, STEP_LENGTH, scan_ladder


def _extrema(Z, cellsize, ladder, d):
    """(mx, mn) of direction ``d`` over ``ladder``, in Z's dtype."""
    H, W = Z.shape
    R, Rmax = max(ladder), ladder[-1]
    dr, dc = OFFSETS[d]
    Zp = torch.nn.functional.pad(Z, (R, R, R, R), value=float("nan"))
    mx = torch.full_like(Z, -math.inf)
    mn = torch.full_like(Z, math.inf)
    for L in ladder:
        src = Zp[R + dr * L:R + dr * L + H, R + dc * L:R + dc * L + W]
        ratio = (src - Z).div_(float(cellsize) * STEP_LENGTH[d] * L)
        torch.fmax(mx, ratio, out=mx)    # fmax / fmin skip a NaN
        torch.fmin(mn, ratio, out=mn)
    rows = torch.arange(H, device=Z.device)[:, None] + dr * Rmax
    cols = torch.arange(W, device=Z.device)[None, :] + dc * Rmax
    off = (rows < 0) | (rows >= H) | (cols < 0) | (cols >= W)
    mx = torch.where(off, mx.clamp(min=0.0), mx)
    mn = torch.where(off, mn.clamp(max=0.0), mn)
    return mx, mn


def relief(Z, cfg, dtype=torch.float64, ladder=None,
           directions=tuple(range(8)), clip=True):
    """(positive openness, negative openness, sky-view factor) of raster
    ``Z`` (a tensor) at the configuration ``cfg``'s cellsize and lookup,
    computed in ``dtype``.  ``ladder``, ``directions`` and ``clip`` (the
    clip of SVF's ``t`` at 0) are there for the faults the tests put in
    the program's place."""
    Z = Z.to(dtype)
    if ladder is None:
        ladder = scan_ladder(cfg["lookup_pixels"])
    half_pi = torch.tensor(math.pi / 2, dtype=dtype, device=Z.device)
    pos = torch.zeros_like(Z)
    neg = torch.zeros_like(Z)
    svf = torch.zeros_like(Z)
    for d in directions:
        mx, mn = _extrema(Z, cfg["cellsize"], tuple(ladder), d)
        seen = mx > -math.inf
        pos += torch.where(seen, half_pi - torch.atan(mx), math.inf)
        neg += torch.where(seen, half_pi - torch.atan(-mn), math.inf)
        t = mx.clamp(min=0.0) if clip else mx
        svf += t / torch.sqrt(1.0 + t * t)
        del mx, mn, seen, t
    n = len(directions)
    return (torch.rad2deg(pos / n), torch.rad2deg(neg / n), 1.0 - svf / n)


def differences(got, want):
    """The judged numbers of outputs ``got`` (pos, neg, svf) against the
    reference's ``want``: the largest |difference| over both openness
    planes (degrees) and over SVF, at pixels finite on both sides, and
    the pixels of the three planes at which exactly one side is not
    finite."""
    out = {"openness_max_abs_deg": 0.0, "svf_max_abs": 0.0,
           "unseen_mismatch_px": 0}
    for k, (g, w) in enumerate(zip(got, want)):
        if tuple(g.shape) != tuple(w.shape):
            raise ValueError(f"shape {tuple(g.shape)} against "
                             f"{tuple(w.shape)}")
        g = g.to(device=w.device, dtype=torch.float64)
        w = w.to(torch.float64)
        fg, fw = torch.isfinite(g), torch.isfinite(w)
        out["unseen_mismatch_px"] += int((fg != fw).sum())
        both = fg & fw
        err = float((g - w).abs_().where(both, 0.0).max()) if g.numel() \
            else 0.0
        key = "svf_max_abs" if k == 2 else "openness_max_abs_deg"
        out[key] = max(out[key], err)
    return out
