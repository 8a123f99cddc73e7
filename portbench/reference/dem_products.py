"""Plain reference of ``dem_products``: a DEM's hillshade (neilpy.py:
814-824), ESRI's curvature triple (K, K_plan, K_profile; neilpy.py:
520-574) and Shi's landslide candidate mask (neilpy.py:2544-2553: the
Evans/Wood tangential curvature, neilpy.py:671-737, then Getis-Ord Gi*
over disk footprints, neilpy.py:330-421, and any radius's bin below -2),
in ``dtype`` (float64 for the judgement; bfloat16 for the control), with
no matrix product or convolution, so TF32 never applies.  Plain PyTorch:
nothing of the port, nothing of JAX.

- Neighbours Z1..Z9 (Zevenbergen & Thorne's naming, Z5 the centre)
  read the pixel itself where they leave the raster, as the reference's
  ``ashift`` does.
- Hillshade at the package's light, zenith 45 and azimuth 315 degrees:
  ``np.gradient``'s differences (central inside, one-sided at the edges)
  at spacing ``cellsize`` for the slope and 1 for the aspect;
  ``255 H`` rounded half to even, cast to uint8 with NaN -> 0 (the
  reference's uint8 cast leaves NaN unspecified).
- ESRI's triple: NaN neighbours take the centre; K_plan and K_profile
  are 0 where they are NaN.
- Evans/Wood: Wilson & Gallant's reflection fill of NaN neighbours
  (``2 Z5 - opposite``); the curvature is 0 where it is NaN on a finite
  centre.
- Gi*: edges ``nearest``; the global mean and variance (ddof 0) and the
  finite count of the whole raster; each disk sum made from float64
  prefix sums along the rows of the edge-padded raster, one run a
  footprint row (the port adds power-of-two column partials); bins as
  ArcGIS's (neilpy.py:405-419).

The departures that the faults of the tests need (``star``, ``radii``,
``square``, ``void_fill``, ``azimuth``) are keyword arguments of
:func:`products`.
"""

from __future__ import annotations

import math

import torch

# Z1..Z9 less the centre: (row, column) of the neighbour read
NEIGHBOURS = {"Z1": (-1, -1), "Z2": (-1, 0), "Z3": (-1, 1), "Z4": (0, -1),
              "Z6": (0, 1), "Z7": (1, -1), "Z8": (1, 0), "Z9": (1, 1)}
OPPOSITE = {"Z1": "Z9", "Z2": "Z8", "Z3": "Z7", "Z4": "Z6", "Z6": "Z4",
            "Z7": "Z3", "Z8": "Z2", "Z9": "Z1"}
# the edge of the landslide bin: P < .01 with z < 0, so z < -Z_EDGE
Z_EDGE = 2.5758293035489004


def _neighbours(X):
    """Z1..Z9 of ``X``: each neighbour's value, the centre's where the
    neighbour is off the raster."""
    H, W = X.shape
    out = {}
    for key, (dr, dc) in NEIGHBOURS.items():
        n = X.clone()
        n[max(0, -dr):H - max(0, dr), max(0, -dc):W - max(0, dc)] = \
            X[max(0, dr):H + min(0, dr), max(0, dc):W + min(0, dc)]
        out[key] = n
    return out


def _gradient(X, spacing):
    """``np.gradient``: (d/drow, d/dcolumn) at ``spacing``."""
    def axis(A, dim):
        n = A.shape[dim]
        inner = (A.narrow(dim, 2, n - 2) - A.narrow(dim, 0, n - 2)) \
            / (2 * spacing)
        first = (A.narrow(dim, 1, 1) - A.narrow(dim, 0, 1)) / spacing
        last = (A.narrow(dim, n - 1, 1) - A.narrow(dim, n - 2, 1)) / spacing
        return torch.cat([first, inner, last], dim=dim)
    return axis(X, 0), axis(X, 1)


def hillshade(X, cellsize, zenith=45.0, azimuth=315.0):
    """255 H before its rounding, in X's dtype (NaN where a gradient
    reads a void)."""
    gy, gx = _gradient(X, cellsize)
    gy1, gx1 = _gradient(X, 1.0)
    S = torch.atan(torch.sqrt(gx * gx + gy * gy))
    A = math.pi / 2 - torch.atan2(gy1, -gx1)
    A = torch.where(A < 0, A + 2 * math.pi, A)
    A = torch.where((gx1 == 0) & (gy1 == 0), 0.0, A)
    zen, azi = math.radians(zenith), math.radians(azimuth)
    H = (math.cos(zen) * torch.cos(S)
         + math.sin(zen) * torch.sin(S) * torch.cos(azi - A))
    return 255.0 * H.clamp(min=0.0)


def to_uint8(V):
    """``V`` rounded half to even, NaN -> 0, clamped to [0, 255]."""
    return torch.nan_to_num(torch.round(V), nan=0.0).clamp(0, 255) \
        .to(torch.uint8)


def esri_curvature(X, cellsize):
    """(K, K_plan, K_profile)."""
    L = cellsize
    n = {k: torch.where(torch.isnan(v), X, v)
         for k, v in _neighbours(X).items()}
    D = ((n["Z4"] + n["Z6"]) / 2 - X) / L ** 2
    E = ((n["Z2"] + n["Z8"]) / 2 - X) / L ** 2
    F = (-n["Z1"] + n["Z3"] + n["Z7"] - n["Z9"]) / (4 * L ** 2)
    G = (-n["Z4"] + n["Z6"]) / (2 * L)
    H = (n["Z2"] - n["Z8"]) / (2 * L)
    GG, HH, GH = G * G, H * H, G * H
    K = -200 * (D + E)
    K_plan = 200 * (D * HH + E * GG - F * GH) / (GG + HH)
    K_profile = -200 * (D * GG + E * HH + F * GH) / (GG + HH)
    return (K, torch.where(torch.isnan(K_plan), 0.0, K_plan),
            torch.where(torch.isnan(K_profile), 0.0, K_profile))


def tangential_curvature(X, cellsize):
    """Evans/Wood's K_tan, 0 where it is NaN on a finite centre."""
    L = cellsize
    n = _neighbours(X)
    for a, b in OPPOSITE.items():
        n[a] = torch.where(torch.isnan(n[a]), 2 * X - n[b], n[a])
    A = ((n["Z1"] + n["Z3"] + n["Z4"] + n["Z6"] + n["Z7"] + n["Z9"])
         / (6 * L ** 2) - (n["Z2"] + X + n["Z8"]) / (3 * L ** 2))
    B = ((n["Z1"] + n["Z2"] + n["Z3"] + n["Z7"] + n["Z8"] + n["Z9"])
         / (6 * L ** 2) - (n["Z4"] + X + n["Z6"]) / (3 * L ** 2))
    C = (n["Z3"] + n["Z7"] - n["Z1"] - n["Z9"]) / (4 * L ** 2)
    D = (n["Z3"] + n["Z6"] + n["Z9"] - n["Z1"] - n["Z4"] - n["Z7"]) / (6 * L)
    E = (n["Z1"] + n["Z2"] + n["Z3"] - n["Z7"] - n["Z8"] - n["Z9"]) / (6 * L)
    del n
    P = D * D + E * E
    T = -(A * E * E - 2 * C * D * E + B * D * D) / (P * torch.sqrt(P + 1))
    return torch.where(torch.isnan(T) & torch.isfinite(X), 0.0, T)


def disk(radius):
    """The disk footprint as (row offset, half-width) runs:
    ``x^2 + y^2 <= r^2`` (skimage's ``disk``)."""
    return [(dy, math.isqrt(radius * radius - dy * dy))
            for dy in range(-radius, radius + 1)]


def footprint_sum(V, runs, R):
    """Sum of V over the footprint ``runs`` ((row offset, half-width)) at
    every pixel, edges ``nearest``: per footprint row, the difference of
    two prefix sums along the rows of the padded raster (R its pad)."""
    H, W = V.shape
    rows = torch.arange(-R, H + R, device=V.device).clamp(0, H - 1)
    cols = torch.arange(-R, W + R, device=V.device).clamp(0, W - 1)
    Vp = V[rows][:, cols]
    C = torch.nn.functional.pad(Vp.cumsum(1), (1, 0))
    out = torch.zeros_like(V)
    for dy, k in runs:
        band = C[R + dy:R + dy + H]
        out += band[:, R + k + 1:R + k + 1 + W] - band[:, R - k:R - k + W]
    return out


def gi_star(X, runs, R, star=True):
    """Getis-Ord Gi* z-scores of X over the footprint ``runs``, NaN off
    the finite pixels; with ``star`` False Gi: the centre dropped from
    the footprint, the global moments taken without the pixel
    (neilpy.py:362-368)."""
    finite = torch.isfinite(X)
    one = finite.to(X.dtype)
    nf = one.sum()
    Xf = torch.where(finite, X, 0.0)
    w = footprint_sum(one, runs, R)
    s = footprint_sum(Xf, runs, R)
    if star:
        gm = Xf.sum() / nf
        gv = torch.where(finite, X - gm, 0.0).square().sum() / nf
        z = (s - w * gm) / torch.sqrt(w / (nf - 1) * (nf - w) * gv)
    else:
        w, s = w - one, s - Xf
        gm = (Xf.sum() - Xf) / (nf - 1)
        gv = (Xf.square().sum() - Xf.square()) / (nf - 1) - gm * gm
        z = (s - w * gm) / torch.sqrt(w / (nf - 2) * (nf - 1 - w) * gv)
    return torch.where(finite, z, math.nan)


def landslide_bin(z):
    """True where z's ArcGIS bin is -3: two-tailed P < .01, z < 0."""
    P = torch.special.erfc(z.abs() / math.sqrt(2.0))
    return (P < .01) & (z < 0)


def products(Z, cfg, dtype=torch.float64, star=True, radii=None,
             square=None, void_fill=None, azimuth=315.0):
    """The judged outputs of one DEM ``Z`` and what the judgement reads
    beside them: ``{"hillshade": uint8, "curvature": (K, K_plan,
    K_profile), "mask": bool, "shade": 255 H, "z": [z per radius]}``,
    computed in ``dtype``; the outputs in the program's types (float32
    curvatures).  ``star`` False drops the footprint's centre (Gi),
    ``radii`` replaces the configuration's, ``square`` maps a radius to
    a square's half-width in place of its disk, ``void_fill`` fills the
    voids before the curvatures, ``azimuth`` moves the light: the faults
    that the tests put in the program's place."""
    X = Z.to(dtype)
    shade = hillshade(X, cfg["cellsize"], azimuth=azimuth)
    Xc = X if void_fill is None else torch.nan_to_num(X, nan=void_fill)
    curv = tuple(c.to(torch.float32)
                 for c in esri_curvature(Xc, cfg["cellsize"]))
    T = tangential_curvature(Xc, cfg["cellsize"])
    zs, mask = [], torch.zeros(Z.shape, dtype=torch.bool, device=Z.device)
    for r in (cfg["radii"] if radii is None else radii):
        if square and r in square:
            k = square[r]
            runs, R = [(dy, k) for dy in range(-k, k + 1)], k
        else:
            runs, R = disk(r), r
        z = gi_star(T, runs, R, star)
        mask |= landslide_bin(z)
        zs.append(z)
    return {"hillshade": to_uint8(shade), "curvature": curv, "mask": mask,
            "shade": shade, "z": zs}


def differences(got, want, Z, cfg):
    """The judged numbers of one job's outputs ``got`` (hillshade,
    (K, K_plan, K_profile), mask) against the reference's ``want``
    (:func:`products` in float64) on the DEM ``Z``:

    - ``hillshade_max_levels``: the largest |difference| in levels;
    - ``hillshade_off_tie_px``: pixels a level or more off where 255 H
      is not within ``cfg["ties"]["shade"]`` of a rounding edge (x.5);
    - ``curvature_max_scaled_err``: the largest |port - float64| over
      the three planes at pixels finite on both sides, over the scale
      ``200 * 2^-24 * max|Z| / cellsize^2``, what one rounding of the
      DEM's largest elevation moves a curvature (200 / L^2 per metre);
    - ``landslide_off_tie_px``: mask pixels that differ where no radius's
      float64 z lies within ``cfg["ties"]["z"]`` of the bin's edge
      -2.5758;
    - ``landslide_diff_ppm``: mask pixels that differ, per million
      pixels;
    - ``nan_mismatch_px``: pixels of the three curvature planes at which
      exactly one side is NaN or infinite."""
    H_got, curv_got, M_got = got
    for g, w in ((H_got, want["hillshade"]), (M_got, want["mask"])):
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            raise ValueError(f"{g.dtype} {tuple(g.shape)} against "
                             f"{w.dtype} {tuple(w.shape)}")
    dev = want["mask"].device
    levels = (H_got.to(dev).int() - want["hillshade"].int()).abs()
    shade = want["shade"]
    tie = (shade - shade.floor() - 0.5).abs() <= cfg["ties"]["shade"]
    Zf = Z.to(dev)
    scale = 200 * 2.0 ** -24 * float(Zf.nan_to_num(0.0).abs().max()) \
        / cfg["cellsize"] ** 2
    err, nan_px = 0.0, 0
    for g, w in zip(curv_got, want["curvature"]):
        g = g.to(device=dev, dtype=torch.float64)
        w = w.to(torch.float64)
        fg, fw = torch.isfinite(g), torch.isfinite(w)
        nan_px += int((fg != fw).sum())
        both = fg & fw
        if bool(both.any()):
            err = max(err, float((g - w).abs()[both].max()))
    diff = M_got.to(dev) != want["mask"]
    near = torch.zeros_like(diff)
    for z in want["z"]:
        near |= (z + Z_EDGE).abs() <= cfg["ties"]["z"]
    return {"hillshade_max_levels": int(levels.max()),
            "hillshade_off_tie_px": int(((levels > 0) & ~tie).sum()),
            "curvature_max_scaled_err": err / scale if scale else err,
            "landslide_off_tie_px": int((diff & ~near).sum()),
            "landslide_diff_ppm": 1e6 * int(diff.sum()) / diff.numel(),
            "nan_mismatch_px": nan_px}


def mask_share(want):
    """The float64 mask's share of the finite pixels, in percent."""
    finite = torch.isfinite(want["z"][0])
    return 100.0 * int((want["mask"] & finite).sum()) / max(
        1, int(finite.sum()))

