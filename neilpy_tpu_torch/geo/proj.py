"""Pure-numpy coordinate transforms (no pyproj in the runtime image).

Parity surface: ``coord_transform(x, y, from_epsg, to_epsg)``
(reference neilpy/neilpy.py:108-110) and the geodesic helpers used by
the photogrammetry stack (track2azimuth via pyproj.Geod at
neilpy.py:2425-2440; great_circle_distance at neilpy.py:888-898).

Implemented CRS families:

* EPSG:4326  WGS84 geographic (lon/lat degrees)
* EPSG:326xx / 327xx  WGS84 UTM north/south zones (transverse
  Mercator, Kruger 6th-order series — sub-mm vs pyproj inside zones)
* EPSG:3857  Web/spherical Mercator
* any projected EPSG code whose conversion is one of the EPSG
  methods below on a GRS80/WGS84-class ellipsoid — parameters are
  read from the system PROJ database (``/usr/share/proj/proj.db``)
  when present:

  - Transverse Mercator (9807) and TM South Orientated (9808)
  - Lambert Conformal Conic 2SP (9802) / 1SP (9801)
  - Albers Equal Area (9822)
  - Polar Stereographic variants A (9810) and B (9829)
  - Mercator variants A (9804) and B (9805)
  - Lambert Azimuthal Equal Area (9820), oblique and polar aspects
  - Hotine Oblique Mercator variants A (9812) and B (9815)
  - Oblique "double" Stereographic (9809)
  - Cassini-Soldner (9806)
  - Equidistant Cylindrical (1028) — per the EPSG meridian-arc
    formula (note the installed PROJ maps this to spherical eqc)
  - New Zealand Map Grid (9811) — Reilly's 6th-order complex
    polynomial with the published LINZ constants
  - Colombia Urban (1052) — the MAGNA-SIRGAS urban grids
  - Krovak (9819 south-west axes, 1041 east-north) — S-JTSK, incl.
    the Ferro-meridian variants

  That covers ~99% of non-deprecated GRS80-class projected codes,
  including the NAD83 US State Plane zones (TM/LCC/ftUS twins) that
  dominate US lidar practice, ETRS89 LAEA Europe (3035), the polar
  LAEA/PS analysis grids, Michigan/Malaysia oblique Mercator and
  South African Lo grids.  Axis units (metre / ftUS / ft) are
  honoured; output is always (x=east, y=north) order (``always_xy``)
  regardless of the official axis convention.

* datum shifts: non-WGS84 datums (OSGB36, Amersfoort, CH1903/+,
  ED50, SAD69, Tokyo, Pulkovo 1942, ...; also any EPSG *geographic*
  CRS code on such datums) ride a geocentric Helmert bridge
  (source datum -> WGS84 -> target datum) whose parameters come from
  the EPSG ``helmert_transformation`` records in the PROJ database,
  selected like PROJ selects them: rows whose area of use contains
  the data's mean location first, then best published accuracy.
  Static 3-/7-/10-parameter methods (9603/9606/9607/9636) are
  supported; rotation conventions are normalised to position-vector.
  When the system PROJ installation ships an NTv2 grid for the datum
  (DHDN/BETA2007, CH1903/CHENyx06, NTF/ntf_r93, NZGD49/nzgd2kgrid)
  the grid interpolation is preferred over the Helmert, like PROJ
  (``geo/ntv2.py``).  Non-Greenwich prime meridians (Paris, Rome,
  ...) and grad/Sears-yard parameter units are folded in from the
  registry, so the NTF (Paris) Lambert zones work out of the box.
  GRS80/WGS84-class datums (NAD83 incl. CSRS/2011, ETRS89, GDA,
  SIRGAS, NZGD2000, ...) stay WGS84-equivalent (~1-2 m ensemble
  class, below DEM-cellsize accuracy) — except datums like GGRS87 or
  Israel 1993 whose registry shift exceeds 5 m, which are bridged.
  Grid-defined datums (NAD27/NADCON) are rejected with a clear
  error: a correct transform there needs datum-shift grids.

Geodesics on the WGS84 ellipsoid use Vincenty's inverse formula with a
spherical fallback at antipodal non-convergence.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["coord_transform", "utm_forward", "utm_inverse",
           "geodesic_inverse", "great_circle_distance"]

_WGS84_A = 6378137.0
_WGS84_F = 1 / 298.257223563
_WGS84_B = _WGS84_A * (1 - _WGS84_F)
_UTM_K0 = 0.9996
_UTM_FE = 500000.0
_UTM_FN_S = 10000000.0

# Kruger series coefficients (n = third flattening)
_N = _WGS84_F / (2 - _WGS84_F)
_A_CAP = _WGS84_A / (1 + _N) * (1 + _N ** 2 / 4 + _N ** 4 / 64
                                + _N ** 6 / 256)
_ALPHA = [
    _N / 2 - 2 * _N ** 2 / 3 + 5 * _N ** 3 / 16 + 41 * _N ** 4 / 180
    - 127 * _N ** 5 / 288 + 7891 * _N ** 6 / 37800,
    13 * _N ** 2 / 48 - 3 * _N ** 3 / 5 + 557 * _N ** 4 / 1440
    + 281 * _N ** 5 / 630 - 1983433 * _N ** 6 / 1935360,
    61 * _N ** 3 / 240 - 103 * _N ** 4 / 140 + 15061 * _N ** 5 / 26880
    + 167603 * _N ** 6 / 181440,
    49561 * _N ** 4 / 161280 - 179 * _N ** 5 / 168
    + 6601661 * _N ** 6 / 7257600,
    34729 * _N ** 5 / 80640 - 3418889 * _N ** 6 / 1995840,
    212378941 * _N ** 6 / 319334400,
]
_BETA = [
    _N / 2 - 2 * _N ** 2 / 3 + 37 * _N ** 3 / 96 - _N ** 4 / 360
    - 81 * _N ** 5 / 512 + 96199 * _N ** 6 / 604800,
    _N ** 2 / 48 + _N ** 3 / 15 - 437 * _N ** 4 / 1440
    + 46 * _N ** 5 / 105 - 1118711 * _N ** 6 / 3870720,
    17 * _N ** 3 / 480 - 37 * _N ** 4 / 840 - 209 * _N ** 5 / 4480
    + 5569 * _N ** 6 / 90720,
    4397 * _N ** 4 / 161280 - 11 * _N ** 5 / 504
    - 830251 * _N ** 6 / 7257600,
    4583 * _N ** 5 / 161280 - 108847 * _N ** 6 / 3991680,
    20648693 * _N ** 6 / 638668800,
]


def utm_forward(lon, lat, zone, northern=True):
    """Geographic (degrees) -> UTM easting/northing via the Kruger
    transverse-Mercator series."""
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    lon0 = np.deg2rad(zone * 6.0 - 183.0)
    phi = np.deg2rad(lat)
    lam = np.deg2rad(lon) - lon0

    e = np.sqrt(_WGS84_F * (2 - _WGS84_F))
    # conformal latitude
    t = np.sinh(np.arctanh(np.sin(phi))
                - e * np.arctanh(e * np.sin(phi)))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))

    xi = xi_p.copy()
    eta = eta_p.copy()
    for j, (a) in enumerate(_ALPHA, start=1):
        xi = xi + a * np.sin(2 * j * xi_p) * np.cosh(2 * j * eta_p)
        eta = eta + a * np.cos(2 * j * xi_p) * np.sinh(2 * j * eta_p)

    x = _UTM_K0 * _A_CAP * eta + _UTM_FE
    y = _UTM_K0 * _A_CAP * xi + (0.0 if northern else _UTM_FN_S)
    return x, y


def utm_inverse(x, y, zone, northern=True):
    """UTM easting/northing -> geographic lon/lat (degrees)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lon0 = np.deg2rad(zone * 6.0 - 183.0)
    xi = (y - (0.0 if northern else _UTM_FN_S)) / (_UTM_K0 * _A_CAP)
    eta = (x - _UTM_FE) / (_UTM_K0 * _A_CAP)

    xi_p = xi.copy()
    eta_p = eta.copy()
    for j, b in enumerate(_BETA, start=1):
        xi_p = xi_p - b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p = eta_p - b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)

    e = np.sqrt(_WGS84_F * (2 - _WGS84_F))
    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    # conformal -> geographic latitude by fixed-point iteration on
    # chi(phi) = arctan(sinh(artanh(sin phi) - e artanh(e sin phi)))
    phi = chi
    for _ in range(10):
        t = np.sinh(np.arctanh(np.sin(phi))
                    - e * np.arctanh(e * np.sin(phi)))
        phi = phi + (chi - np.arctan(t))
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    lon = np.rad2deg(lam + lon0)
    lat = np.rad2deg(phi)
    return lon, lat


def _webmercator_forward(lon, lat):
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    x = _WGS84_A * np.deg2rad(lon)
    y = _WGS84_A * np.log(np.tan(np.pi / 4 + np.deg2rad(lat) / 2))
    return x, y


def _webmercator_inverse(x, y):
    lon = np.rad2deg(np.asarray(x, dtype=np.float64) / _WGS84_A)
    lat = np.rad2deg(2 * np.arctan(np.exp(np.asarray(y, dtype=np.float64)
                                          / _WGS84_A)) - np.pi / 2)
    return lon, lat


@lru_cache(maxsize=16)
def _tm_consts(a, f):
    """Kruger series constants for an arbitrary ellipsoid (n = third
    flattening).  The module-level WGS84 constants are this function's
    output for (WGS84 a, f)."""
    n = f / (2 - f)
    A = a / (1 + n) * (1 + n ** 2 / 4 + n ** 4 / 64 + n ** 6 / 256)
    alpha = [
        n / 2 - 2 * n ** 2 / 3 + 5 * n ** 3 / 16 + 41 * n ** 4 / 180
        - 127 * n ** 5 / 288 + 7891 * n ** 6 / 37800,
        13 * n ** 2 / 48 - 3 * n ** 3 / 5 + 557 * n ** 4 / 1440
        + 281 * n ** 5 / 630 - 1983433 * n ** 6 / 1935360,
        61 * n ** 3 / 240 - 103 * n ** 4 / 140 + 15061 * n ** 5 / 26880
        + 167603 * n ** 6 / 181440,
        49561 * n ** 4 / 161280 - 179 * n ** 5 / 168
        + 6601661 * n ** 6 / 7257600,
        34729 * n ** 5 / 80640 - 3418889 * n ** 6 / 1995840,
        212378941 * n ** 6 / 319334400,
    ]
    beta = [
        n / 2 - 2 * n ** 2 / 3 + 37 * n ** 3 / 96 - n ** 4 / 360
        - 81 * n ** 5 / 512 + 96199 * n ** 6 / 604800,
        n ** 2 / 48 + n ** 3 / 15 - 437 * n ** 4 / 1440
        + 46 * n ** 5 / 105 - 1118711 * n ** 6 / 3870720,
        17 * n ** 3 / 480 - 37 * n ** 4 / 840 - 209 * n ** 5 / 4480
        + 5569 * n ** 6 / 90720,
        4397 * n ** 4 / 161280 - 11 * n ** 5 / 504
        - 830251 * n ** 6 / 7257600,
        4583 * n ** 5 / 161280 - 108847 * n ** 6 / 3991680,
        20648693 * n ** 6 / 638668800,
    ]
    return A, tuple(alpha), tuple(beta)


def _tm_xi_eta(lon, lat, lon0_deg, a, f):
    """Conformal-sphere + Kruger series: geographic -> (xi, eta)."""
    A, alpha, _ = _tm_consts(a, f)
    phi = np.deg2rad(np.asarray(lat, dtype=np.float64))
    lam = np.deg2rad(np.asarray(lon, dtype=np.float64) - lon0_deg)
    e = np.sqrt(f * (2 - f))
    t = np.sinh(np.arctanh(np.sin(phi))
                - e * np.arctanh(e * np.sin(phi)))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))
    xi = xi_p.copy()
    eta = eta_p.copy()
    for j, al in enumerate(alpha, start=1):
        xi = xi + al * np.sin(2 * j * xi_p) * np.cosh(2 * j * eta_p)
        eta = eta + al * np.cos(2 * j * xi_p) * np.sinh(2 * j * eta_p)
    return xi, eta, A


def _tm_forward(lon, lat, lat0, lon0, k0, fe, fn, a=_WGS84_A,
                f=_WGS84_F):
    """General Transverse Mercator (EPSG method 9807): arbitrary
    natural origin, scale and false offsets."""
    xi, eta, A = _tm_xi_eta(lon, lat, lon0, a, f)
    if lat0:
        xi0, _, _ = _tm_xi_eta(np.float64(lon0), np.float64(lat0),
                               lon0, a, f)
        m0 = A * float(xi0)
    else:
        m0 = 0.0
    x = fe + k0 * A * eta
    y = fn + k0 * (A * xi - m0)
    return x, y


def _tm_inverse(x, y, lat0, lon0, k0, fe, fn, a=_WGS84_A, f=_WGS84_F):
    A, _, beta = _tm_consts(a, f)
    if lat0:
        xi0, _, _ = _tm_xi_eta(np.float64(lon0), np.float64(lat0),
                               lon0, a, f)
        m0 = A * float(xi0)
    else:
        m0 = 0.0
    xi = (np.asarray(y, dtype=np.float64) - fn + k0 * m0) / (k0 * A)
    eta = (np.asarray(x, dtype=np.float64) - fe) / (k0 * A)
    xi_p = xi.copy()
    eta_p = eta.copy()
    for j, b in enumerate(beta, start=1):
        xi_p = xi_p - b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p = eta_p - b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    e = np.sqrt(f * (2 - f))
    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    phi = chi
    for _ in range(10):
        t = np.sinh(np.arctanh(np.sin(phi))
                    - e * np.arctanh(e * np.sin(phi)))
        phi = phi + (chi - np.arctan(t))
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return np.rad2deg(lam) + lon0, np.rad2deg(phi)


def _lcc_mt(phi, e):
    m = np.cos(phi) / np.sqrt(1 - (e * np.sin(phi)) ** 2)
    t = (np.tan(np.pi / 4 - phi / 2)
         / ((1 - e * np.sin(phi)) / (1 + e * np.sin(phi))) ** (e / 2))
    return m, t


def _lcc_setup(lat0, sp1, sp2, k0, a, f):
    """Lambert Conformal Conic cone constants (EPSG 9802 two-SP when
    sp1/sp2 given, 9801 one-SP otherwise)."""
    e = np.sqrt(f * (2 - f))
    phi0 = np.deg2rad(lat0)
    _, t0 = _lcc_mt(np.float64(phi0), e)
    if sp1 is not None:
        p1 = np.deg2rad(sp1)
        p2 = np.deg2rad(sp2 if sp2 is not None else sp1)
        m1, t1 = _lcc_mt(np.float64(p1), e)
        m2, t2 = _lcc_mt(np.float64(p2), e)
        if abs(p1 - p2) > 1e-12:
            n = (np.log(m1) - np.log(m2)) / (np.log(t1) - np.log(t2))
        else:
            n = np.sin(p1)
        F = m1 / (n * t1 ** n)
        rho0 = a * F * t0 ** n
    else:
        n = np.sin(phi0)
        m0, _ = _lcc_mt(np.float64(phi0), e)
        F = k0 * m0 / (n * t0 ** n)
        rho0 = a * F * t0 ** n
    return e, float(n), float(F), float(rho0)


def _lcc_forward(lon, lat, lat0, lon0, sp1, sp2, k0, fe, fn,
                 a=_WGS84_A, f=_WGS84_F):
    e, n, F, rho0 = _lcc_setup(lat0, sp1, sp2, k0, a, f)
    phi = np.deg2rad(np.asarray(lat, dtype=np.float64))
    _, t = _lcc_mt(phi, e)
    rho = a * F * t ** n
    theta = n * np.deg2rad(np.asarray(lon, dtype=np.float64) - lon0)
    return fe + rho * np.sin(theta), fn + rho0 - rho * np.cos(theta)


def _lcc_inverse(x, y, lat0, lon0, sp1, sp2, k0, fe, fn,
                 a=_WGS84_A, f=_WGS84_F):
    e, n, F, rho0 = _lcc_setup(lat0, sp1, sp2, k0, a, f)
    dx = np.asarray(x, dtype=np.float64) - fe
    dy = rho0 - (np.asarray(y, dtype=np.float64) - fn)
    rho = np.sign(n) * np.hypot(dx, dy)
    theta = np.arctan2(np.sign(n) * dx, np.sign(n) * dy)
    t = (rho / (a * F)) ** (1.0 / n)
    phi = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(12):
        phi = (np.pi / 2
               - 2 * np.arctan(t * ((1 - e * np.sin(phi))
                                    / (1 + e * np.sin(phi))) ** (e / 2)))
    return np.rad2deg(theta / n) + lon0, np.rad2deg(phi)


def _aea_q(phi, e):
    """Authalic q (Snyder eq. 3-12)."""
    s = np.sin(phi)
    return (1 - e * e) * (s / (1 - (e * s) ** 2)
                          - np.log((1 - e * s) / (1 + e * s)) / (2 * e))


def _aea_setup(lat0, sp1, sp2, a, f):
    """Albers Equal Area cone constants (EPSG method 9822)."""
    e = np.sqrt(f * (2 - f))
    p0 = np.deg2rad(lat0)
    p1 = np.deg2rad(sp1)
    p2 = np.deg2rad(sp2 if sp2 is not None else sp1)
    m1 = np.cos(p1) / np.sqrt(1 - (e * np.sin(p1)) ** 2)
    m2 = np.cos(p2) / np.sqrt(1 - (e * np.sin(p2)) ** 2)
    q0, q1, q2 = (_aea_q(np.float64(p), e) for p in (p0, p1, p2))
    if abs(p1 - p2) > 1e-12:
        n = (m1 ** 2 - m2 ** 2) / (q2 - q1)
    else:
        n = np.sin(p1)
    C = m1 ** 2 + n * q1
    rho0 = a * np.sqrt(C - n * q0) / n
    return e, float(n), float(C), float(rho0)


def _aea_forward(lon, lat, lat0, lon0, sp1, sp2, fe, fn,
                 a=_WGS84_A, f=_WGS84_F):
    e, n, C, rho0 = _aea_setup(lat0, sp1, sp2, a, f)
    q = _aea_q(np.deg2rad(np.asarray(lat, dtype=np.float64)), e)
    rho = a * np.sqrt(np.maximum(C - n * q, 0.0)) / n
    theta = n * np.deg2rad(np.asarray(lon, dtype=np.float64) - lon0)
    return fe + rho * np.sin(theta), fn + rho0 - rho * np.cos(theta)


def _aea_inverse(x, y, lat0, lon0, sp1, sp2, fe, fn,
                 a=_WGS84_A, f=_WGS84_F):
    e, n, C, rho0 = _aea_setup(lat0, sp1, sp2, a, f)
    dx = np.asarray(x, dtype=np.float64) - fe
    dy = rho0 - (np.asarray(y, dtype=np.float64) - fn)
    rho = np.sign(n) * np.hypot(dx, dy)
    theta = np.arctan2(np.sign(n) * dx, np.sign(n) * dy)
    q = (C - (rho * n / a) ** 2) / n
    # fixed-point iteration for phi (Snyder eq. 3-16), started from the
    # spherical solution; poles guarded (cos phi -> 0 only when q is
    # the polar authalic limit, where the update term vanishes too)
    phi = np.arcsin(np.clip(q / 2, -1.0, 1.0))
    for _ in range(15):
        s = np.sin(phi)
        es = e * s
        upd = ((1 - es ** 2) ** 2 / np.maximum(2 * np.cos(phi), 1e-12)
               * (q / (1 - e * e) - s / (1 - es ** 2)
                  + np.log((1 - es) / (1 + es)) / (2 * e)))
        phi = phi + upd
    return np.rad2deg(theta / n) + lon0, np.rad2deg(phi)


def _ps_t(phi, e):
    """Polar stereographic isometric t (EPSG GN7-2, north form)."""
    s = e * np.sin(phi)
    return np.tan(np.pi / 4 - phi / 2) * ((1 + s) / (1 - s)) ** (e / 2)


def _ps_setup(lat_ts, lat0, k0, a, f):
    """rho(t) scale for EPSG 9829 (variant B, standard parallel
    ``lat_ts``) or 9810 (variant A, scale ``k0`` at the pole).
    Returns (e, north, rho_at_t1) with rho = rho_at_t1 * t."""
    e = np.sqrt(f * (2 - f))
    if lat_ts is not None:
        north = lat_ts > 0
        pts = np.deg2rad(abs(lat_ts))
        m = np.cos(pts) / np.sqrt(1 - (e * np.sin(pts)) ** 2)
        return e, north, a * m / float(_ps_t(np.float64(pts), e))
    north = lat0 > 0
    denom = np.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e))
    return e, north, 2 * a * k0 / denom


def _ps_forward(lon, lat, lat_ts, lat0, k0, lon0, fe, fn,
                a=_WGS84_A, f=_WGS84_F):
    e, north, rf = _ps_setup(lat_ts, lat0, k0, a, f)
    sgn = 1.0 if north else -1.0
    phi = sgn * np.deg2rad(np.asarray(lat, dtype=np.float64))
    theta = np.deg2rad(np.asarray(lon, dtype=np.float64) - lon0)
    rho = rf * _ps_t(phi, e)
    # north: y decreases away from the pole along lon0; south mirrors
    return fe + rho * np.sin(theta), fn - sgn * rho * np.cos(theta)


def _ps_inverse(x, y, lat_ts, lat0, k0, lon0, fe, fn,
                a=_WGS84_A, f=_WGS84_F):
    e, north, rf = _ps_setup(lat_ts, lat0, k0, a, f)
    sgn = 1.0 if north else -1.0
    dx = np.asarray(x, dtype=np.float64) - fe
    dy = -sgn * (np.asarray(y, dtype=np.float64) - fn)
    t = np.hypot(dx, dy) / rf
    phi = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(12):
        s = e * np.sin(phi)
        phi = np.pi / 2 - 2 * np.arctan(t * ((1 - s) / (1 + s))
                                        ** (e / 2))
    lam = np.arctan2(dx, dy)
    return np.rad2deg(lam) + lon0, sgn * np.rad2deg(phi)


def _merc_k0(lat_ts, e):
    pts = np.deg2rad(lat_ts)
    return float(np.cos(pts) / np.sqrt(1 - (e * np.sin(pts)) ** 2))


def _merc_forward(lon, lat, lat_ts, k0, lon0, fe, fn,
                  a=_WGS84_A, f=_WGS84_F):
    """Mercator variant A (EPSG 9804, scale at equator) / variant B
    (9805, standard parallel ``lat_ts``)."""
    e = np.sqrt(f * (2 - f))
    if lat_ts is not None:
        k0 = _merc_k0(lat_ts, e)
    phi = np.deg2rad(np.asarray(lat, dtype=np.float64))
    s = e * np.sin(phi)
    x = a * k0 * np.deg2rad(np.asarray(lon, dtype=np.float64) - lon0)
    y = a * k0 * np.log(np.tan(np.pi / 4 + phi / 2)
                        * ((1 - s) / (1 + s)) ** (e / 2))
    return fe + x, fn + y


def _merc_inverse(x, y, lat_ts, k0, lon0, fe, fn,
                  a=_WGS84_A, f=_WGS84_F):
    e = np.sqrt(f * (2 - f))
    if lat_ts is not None:
        k0 = _merc_k0(lat_ts, e)
    t = np.exp((fn - np.asarray(y, dtype=np.float64)) / (a * k0))
    phi = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(12):
        s = e * np.sin(phi)
        phi = np.pi / 2 - 2 * np.arctan(t * ((1 - s) / (1 + s))
                                        ** (e / 2))
    lon = lon0 + np.rad2deg((np.asarray(x, dtype=np.float64) - fe)
                            / (a * k0))
    return lon, np.rad2deg(phi)


def _laea_setup(lat0, a, f):
    """Lambert Azimuthal Equal Area constants (EPSG 9820; Snyder
    pp. 187-190).  Returns (e, qp, aspect-dependent tuple)."""
    e = np.sqrt(f * (2 - f))
    qp = float(_aea_q(np.float64(np.pi / 2), e))
    if abs(lat0) >= 90.0 - 1e-12:
        return e, qp, None
    p0 = np.deg2rad(lat0)
    q0 = float(_aea_q(np.float64(p0), e))
    beta0 = np.arcsin(np.clip(q0 / qp, -1.0, 1.0))
    rq = a * np.sqrt(qp / 2)
    m0 = np.cos(p0) / np.sqrt(1 - (e * np.sin(p0)) ** 2)
    d = a * m0 / (rq * np.cos(beta0))
    return e, qp, (float(beta0), float(rq), float(d))


def _laea_phi_from_q(q, e):
    """Authalic -> geodetic latitude (same fixed point as AEA)."""
    qp = _aea_q(np.float64(np.pi / 2), e)
    phi = np.arcsin(np.clip(q / qp, -1.0, 1.0))
    for _ in range(15):
        s = np.sin(phi)
        es = e * s
        upd = ((1 - es ** 2) ** 2 / np.maximum(2 * np.cos(phi), 1e-12)
               * (q / (1 - e * e) - s / (1 - es ** 2)
                  + np.log((1 - es) / (1 + es)) / (2 * e)))
        phi = phi + upd
    return phi


def _laea_forward(lon, lat, lat0, lon0, fe, fn, a=_WGS84_A,
                  f=_WGS84_F):
    e, qp, ob = _laea_setup(lat0, a, f)
    q = _aea_q(np.deg2rad(np.asarray(lat, dtype=np.float64)), e)
    dlam = np.deg2rad(np.asarray(lon, dtype=np.float64) - lon0)
    if ob is None:                       # polar aspects
        sgn = 1.0 if lat0 > 0 else -1.0
        rho = a * np.sqrt(np.maximum(qp - sgn * q, 0.0))
        return (fe + rho * np.sin(dlam),
                fn - sgn * rho * np.cos(dlam))
    beta0, rq, d = ob
    beta = np.arcsin(np.clip(q / qp, -1.0, 1.0))
    bden = 1 + (np.sin(beta0) * np.sin(beta)
                + np.cos(beta0) * np.cos(beta) * np.cos(dlam))
    b = rq * np.sqrt(2.0 / bden)
    x = b * d * np.cos(beta) * np.sin(dlam)
    y = (b / d) * (np.cos(beta0) * np.sin(beta)
                   - np.sin(beta0) * np.cos(beta) * np.cos(dlam))
    return fe + x, fn + y


def _laea_inverse(x, y, lat0, lon0, fe, fn, a=_WGS84_A, f=_WGS84_F):
    e, qp, ob = _laea_setup(lat0, a, f)
    dx = np.asarray(x, dtype=np.float64) - fe
    dy = np.asarray(y, dtype=np.float64) - fn
    if ob is None:
        sgn = 1.0 if lat0 > 0 else -1.0
        rho = np.hypot(dx, dy)
        q = sgn * (qp - (rho / a) ** 2)
        lam = np.arctan2(dx, -sgn * dy)
        return (np.rad2deg(lam) + lon0,
                np.rad2deg(_laea_phi_from_q(q, e)))
    beta0, rq, d = ob
    rho = np.hypot(dx / d, d * dy)
    ce = 2 * np.arcsin(np.clip(rho / (2 * rq), -1.0, 1.0))
    rho_safe = np.where(rho == 0, 1.0, rho)
    beta = np.arcsin(np.clip(
        np.cos(ce) * np.sin(beta0)
        + d * dy * np.sin(ce) * np.cos(beta0) / rho_safe, -1.0, 1.0))
    beta = np.where(rho == 0, beta0, beta)
    lam = np.arctan2(dx * np.sin(ce),
                     d * rho_safe * np.cos(beta0) * np.cos(ce)
                     - d * d * dy * np.sin(beta0) * np.sin(ce))
    lam = np.where(rho == 0, 0.0, lam)
    q = qp * np.sin(beta)
    return (np.rad2deg(lam) + lon0,
            np.rad2deg(_laea_phi_from_q(q, e)))


def _hom_setup(latc, lonc, alphac, k0, a, f):
    """Hotine Oblique Mercator constants (EPSG 9812/9815)."""
    e = np.sqrt(f * (2 - f))
    pc = np.deg2rad(latc)
    ac = np.deg2rad(alphac)
    e2 = e * e
    cos4 = np.cos(pc) ** 4
    B = np.sqrt(1 + e2 * cos4 / (1 - e2))
    w = 1 - e2 * np.sin(pc) ** 2
    A = a * B * k0 * np.sqrt(1 - e2) / w
    t0 = _ps_t(np.float64(pc), e)
    D = B * np.sqrt(1 - e2) / (np.cos(pc) * np.sqrt(w))
    D2 = max(float(D) ** 2, 1.0)
    sgn = 1.0 if latc >= 0 else -1.0
    F = np.sqrt(D2) + np.sqrt(D2 - 1) * sgn
    H = F * float(t0) ** B
    G = (F - 1 / F) / 2
    gamma0 = np.arcsin(np.sin(ac) / np.sqrt(D2))
    lam0 = np.deg2rad(lonc) - np.arcsin(G * np.tan(gamma0)) / B
    uc = (A / B) * np.arctan2(np.sqrt(D2 - 1), np.cos(ac)) * sgn
    return (e, float(B), float(A), float(H), float(gamma0),
            float(lam0), float(uc))


def _hom_forward(lon, lat, latc, lonc, alphac, gammac, k0, fe, fn,
                 variant_b, a=_WGS84_A, f=_WGS84_F):
    e, B, A, H, g0, lam0, uc = _hom_setup(latc, lonc, alphac, k0, a, f)
    phi = np.deg2rad(np.asarray(lat, dtype=np.float64))
    lam = np.deg2rad(np.asarray(lon, dtype=np.float64))
    t = _ps_t(phi, e)
    Q = H / t ** B
    S = (Q - 1 / Q) / 2
    T = (Q + 1 / Q) / 2
    V = np.sin(B * (lam - lam0))
    U = (-V * np.cos(g0) + S * np.sin(g0)) / T
    v = A * np.log((1 - U) / (1 + U)) / (2 * B)
    u = A * np.arctan2(S * np.cos(g0) + V * np.sin(g0),
                       np.cos(B * (lam - lam0))) / B
    if variant_b:
        u = u - uc
    gc = np.deg2rad(gammac)
    return (fe + v * np.cos(gc) + u * np.sin(gc),
            fn + u * np.cos(gc) - v * np.sin(gc))


def _hom_inverse(x, y, latc, lonc, alphac, gammac, k0, fe, fn,
                 variant_b, a=_WGS84_A, f=_WGS84_F):
    e, B, A, H, g0, lam0, uc = _hom_setup(latc, lonc, alphac, k0, a, f)
    gc = np.deg2rad(gammac)
    dx = np.asarray(x, dtype=np.float64) - fe
    dy = np.asarray(y, dtype=np.float64) - fn
    v = dx * np.cos(gc) - dy * np.sin(gc)
    u = dy * np.cos(gc) + dx * np.sin(gc)
    if variant_b:
        u = u + uc
    Q = np.exp(-B * v / A)
    S = (Q - 1 / Q) / 2
    T = (Q + 1 / Q) / 2
    V = np.sin(B * u / A)
    U = (V * np.cos(g0) + S * np.sin(g0)) / T
    t = (H / np.sqrt((1 + U) / (1 - U))) ** (1 / B)
    phi = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(12):
        s = e * np.sin(phi)
        phi = np.pi / 2 - 2 * np.arctan(t * ((1 - s) / (1 + s))
                                        ** (e / 2))
    lam = lam0 - np.arctan2(S * np.cos(g0) - V * np.sin(g0),
                            np.cos(B * u / A)) / B
    return np.rad2deg(lam), np.rad2deg(phi)


def _ostereo_setup(lat0, lon0, k0, a, f):
    """Oblique (double) Stereographic constants (EPSG 9809)."""
    e = np.sqrt(f * (2 - f))
    e2 = e * e
    p0 = np.deg2rad(lat0)
    s0 = np.sin(p0)
    w = 1 - e2 * s0 * s0
    rho0 = a * (1 - e2) / w ** 1.5
    nu0 = a / np.sqrt(w)
    R = np.sqrt(rho0 * nu0)
    n = np.sqrt(1 + e2 * np.cos(p0) ** 4 / (1 - e2))
    S1 = (1 + s0) / (1 - s0)
    S2 = (1 - e * s0) / (1 + e * s0)
    w1 = (S1 * S2 ** e) ** n
    sin_chi0 = (w1 - 1) / (w1 + 1)
    c = ((n + s0) * (1 - sin_chi0)) / ((n - s0) * (1 + sin_chi0))
    w2 = c * w1
    chi0 = np.arcsin((w2 - 1) / (w2 + 1))
    return (e, float(n), float(c), float(R), float(chi0),
            np.deg2rad(lon0))


def _ostereo_chi(lat, e, n, c):
    phi = np.deg2rad(np.asarray(lat, dtype=np.float64))
    s = np.sin(phi)
    Sa = (1 + s) / (1 - s)
    Sb = (1 - e * s) / (1 + e * s)
    w = c * (Sa * Sb ** e) ** n
    return np.arcsin((w - 1) / (w + 1))


def _ostereo_forward(lon, lat, lat0, lon0, k0, fe, fn, a=_WGS84_A,
                     f=_WGS84_F):
    e, n, c, R, chi0, lam0 = _ostereo_setup(lat0, lon0, k0, a, f)
    chi = _ostereo_chi(lat, e, n, c)
    Lam = n * (np.deg2rad(np.asarray(lon, dtype=np.float64))
               - lam0) + lam0
    dl = Lam - lam0
    Bd = 1 + (np.sin(chi) * np.sin(chi0)
              + np.cos(chi) * np.cos(chi0) * np.cos(dl))
    return (fe + 2 * R * k0 * np.cos(chi) * np.sin(dl) / Bd,
            fn + 2 * R * k0 * (np.sin(chi) * np.cos(chi0)
                               - np.cos(chi) * np.sin(chi0)
                               * np.cos(dl)) / Bd)


def _ostereo_inverse(x, y, lat0, lon0, k0, fe, fn, a=_WGS84_A,
                     f=_WGS84_F):
    e, n, c, R, chi0, lam0 = _ostereo_setup(lat0, lon0, k0, a, f)
    dx = np.asarray(x, dtype=np.float64) - fe
    dy = np.asarray(y, dtype=np.float64) - fn
    g = 2 * R * k0 * np.tan(np.pi / 4 - chi0 / 2)
    h = 4 * R * k0 * np.tan(chi0) + g
    i = np.arctan2(dx, h + dy)
    j = np.arctan2(dx, g - dy) - i
    chi = chi0 + 2 * np.arctan2(dy - dx * np.tan(j / 2), 2 * R * k0)
    Lam = j + 2 * i + lam0
    lam = (Lam - lam0) / n + lam0
    # isometric latitude of the conformal-sphere point -> geodetic
    psi = 0.5 * np.log((1 + np.sin(chi))
                       / (c * (1 - np.sin(chi)))) / n
    phi = 2 * np.arctan(np.exp(psi)) - np.pi / 2
    for _ in range(15):
        s = e * np.sin(phi)
        psi_i = np.log(np.tan(phi / 2 + np.pi / 4)
                       * ((1 - s) / (1 + s)) ** (e / 2))
        phi = phi - (psi_i - psi) * np.cos(phi) * (1 - s * s) / (1 - e * e)
    return np.rad2deg(lam), np.rad2deg(phi)


@lru_cache(maxsize=16)
def _marc_consts(a, f):
    """Meridian-arc series constants (Snyder eq. 3-21) and the
    footpoint-latitude (rectifying) series (eq. 3-26)."""
    e2 = f * (2 - f)
    c0 = 1 - e2 / 4 - 3 * e2 ** 2 / 64 - 5 * e2 ** 3 / 256
    c2 = 3 * e2 / 8 + 3 * e2 ** 2 / 32 + 45 * e2 ** 3 / 1024
    c4 = 15 * e2 ** 2 / 256 + 45 * e2 ** 3 / 1024
    c6 = 35 * e2 ** 3 / 3072
    e1 = (1 - np.sqrt(1 - e2)) / (1 + np.sqrt(1 - e2))
    f2 = 3 * e1 / 2 - 27 * e1 ** 3 / 32
    f4 = 21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32
    f6 = 151 * e1 ** 3 / 96
    f8 = 1097 * e1 ** 4 / 512
    return (c0, c2, c4, c6), (f2, f4, f6, f8)


def _meridian_arc(phi, a, f):
    (c0, c2, c4, c6), _ = _marc_consts(a, f)
    return a * (c0 * phi - c2 * np.sin(2 * phi) + c4 * np.sin(4 * phi)
                - c6 * np.sin(6 * phi))


def _footpoint_lat(M, a, f):
    (c0, _, _, _), (f2, f4, f6, f8) = _marc_consts(a, f)
    mu = M / (a * c0)
    return (mu + f2 * np.sin(2 * mu) + f4 * np.sin(4 * mu)
            + f6 * np.sin(6 * mu) + f8 * np.sin(8 * mu))


def _cass_forward(lon, lat, lat0, lon0, fe, fn, a=_WGS84_A,
                  f=_WGS84_F):
    """Cassini-Soldner (EPSG 9806; Snyder pp. 94-95)."""
    e2 = f * (2 - f)
    phi = np.deg2rad(np.asarray(lat, dtype=np.float64))
    A = np.deg2rad(np.asarray(lon, dtype=np.float64) - lon0) \
        * np.cos(phi)
    T = np.tan(phi) ** 2
    C = e2 * np.cos(phi) ** 2 / (1 - e2)
    nu = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
    M = _meridian_arc(phi, a, f)
    M0 = _meridian_arc(np.deg2rad(lat0), a, f)
    x = nu * (A - T * A ** 3 / 6 - (8 - T + 8 * C) * T * A ** 5 / 120)
    y = M - M0 + nu * np.tan(phi) * (A ** 2 / 2
                                     + (5 - T + 6 * C) * A ** 4 / 24)
    return fe + x, fn + y


def _cass_inverse(x, y, lat0, lon0, fe, fn, a=_WGS84_A, f=_WGS84_F):
    e2 = f * (2 - f)
    M0 = _meridian_arc(np.deg2rad(lat0), a, f)
    M1 = M0 + (np.asarray(y, dtype=np.float64) - fn)
    phi1 = _footpoint_lat(M1, a, f)
    T1 = np.tan(phi1) ** 2
    w1 = 1 - e2 * np.sin(phi1) ** 2
    nu1 = a / np.sqrt(w1)
    rho1 = a * (1 - e2) / w1 ** 1.5
    D = (np.asarray(x, dtype=np.float64) - fe) / nu1
    phi = phi1 - (nu1 * np.tan(phi1) / rho1) \
        * (D ** 2 / 2 - (1 + 3 * T1) * D ** 4 / 24)
    lam = (D - T1 * D ** 3 / 3
           + (1 + 3 * T1) * T1 * D ** 5 / 15) / np.cos(phi1)
    return np.rad2deg(lam) + lon0, np.rad2deg(phi)


def _eqc_forward(lon, lat, lat_ts, lon0, fe, fn, a=_WGS84_A,
                 f=_WGS84_F):
    """Equidistant Cylindrical (EPSG 1028, e.g. 4087)."""
    e2 = f * (2 - f)
    p1 = np.deg2rad(lat_ts)
    nu1c = a * np.cos(p1) / np.sqrt(1 - e2 * np.sin(p1) ** 2)
    x = nu1c * np.deg2rad(np.asarray(lon, dtype=np.float64) - lon0)
    y = _meridian_arc(np.deg2rad(np.asarray(lat, dtype=np.float64)),
                      a, f)
    return fe + x, fn + y


def _eqc_inverse(x, y, lat_ts, lon0, fe, fn, a=_WGS84_A, f=_WGS84_F):
    e2 = f * (2 - f)
    p1 = np.deg2rad(lat_ts)
    nu1c = a * np.cos(p1) / np.sqrt(1 - e2 * np.sin(p1) ** 2)
    lam = (np.asarray(x, dtype=np.float64) - fe) / nu1c
    phi = _footpoint_lat(np.asarray(y, dtype=np.float64) - fn, a, f)
    return np.rad2deg(lam) + lon0, np.rad2deg(phi)


def _krovak_consts(latc, alphac, latp, kp, a, f):
    e2 = f * (2 - f)
    e = np.sqrt(e2)
    pc = np.deg2rad(latc)
    A = a * np.sqrt(1 - e2) / (1 - e2 * np.sin(pc) ** 2)
    B = np.sqrt(1 + e2 * np.cos(pc) ** 4 / (1 - e2))
    g0 = np.arcsin(np.sin(pc) / B)
    s = e * np.sin(pc)
    t0 = (np.tan(np.pi / 4 + g0 / 2)
          * ((1 + s) / (1 - s)) ** (e * B / 2)
          / np.tan(np.pi / 4 + pc / 2) ** B)
    pp = np.deg2rad(latp)
    n = np.sin(pp)
    r0 = kp * A / np.tan(pp)
    rn = r0 * np.tan(np.pi / 4 + pp / 2) ** n
    return (e, float(B), float(g0), float(t0), float(n), float(rn),
            np.deg2rad(alphac))


def _krovak_forward(lon, lat, latc, lon0, alphac, latp, kp, fe, fn,
                    east_north, a, f):
    """Krovak oblique conformal conic (EPSG 9819 south-west axes /
    1041 east-north) — the S-JTSK national projection."""
    e, B, g0, t0, n, rn, ac = _krovak_consts(latc, alphac, latp, kp,
                                             a, f)
    ph = np.deg2rad(np.asarray(lat, dtype=np.float64))
    s = e * np.sin(ph)
    U = 2 * (np.arctan(t0 * np.tan(ph / 2 + np.pi / 4) ** B
                       / ((1 + s) / (1 - s)) ** (e * B / 2))
             - np.pi / 4)
    V = B * np.deg2rad(lon0 - np.asarray(lon, dtype=np.float64))
    T = np.arcsin(np.cos(ac) * np.sin(U)
                  + np.sin(ac) * np.cos(U) * np.cos(V))
    D = np.arcsin(np.cos(U) * np.sin(V) / np.cos(T))
    r = rn / np.tan(T / 2 + np.pi / 4) ** n
    Xs = r * np.cos(n * D)              # southing
    Yw = r * np.sin(n * D)              # westing
    if east_north:
        return -Yw + fe, -Xs + fn
    return Xs + fe, Yw + fn


def _krovak_inverse(x, y, latc, lon0, alphac, latp, kp, fe, fn,
                    east_north, a, f):
    e, B, g0, t0, n, rn, ac = _krovak_consts(latc, alphac, latp, kp,
                                             a, f)
    if east_north:
        Yw = -(np.asarray(x, dtype=np.float64) - fe)
        Xs = -(np.asarray(y, dtype=np.float64) - fn)
    else:
        Xs = np.asarray(x, dtype=np.float64) - fe
        Yw = np.asarray(y, dtype=np.float64) - fn
    r = np.hypot(Xs, Yw)
    theta = np.arctan2(Yw, Xs)
    D = theta / n
    T = 2 * (np.arctan((rn / r) ** (1.0 / n)) - np.pi / 4)
    U = np.arcsin(np.cos(ac) * np.sin(T)
                  - np.sin(ac) * np.cos(T) * np.cos(D))
    V = np.arcsin(np.cos(T) * np.sin(D) / np.cos(U))
    phi = U
    for _ in range(15):
        s = e * np.sin(phi)
        phi = 2 * (np.arctan((np.tan(U / 2 + np.pi / 4) / t0
                              * ((1 + s) / (1 - s)) ** (e * B / 2))
                             ** (1.0 / B)) - np.pi / 4)
    lon = lon0 - np.rad2deg(V / B)
    return lon, np.rad2deg(phi)


def _colurban_consts(lat0, h0, a, f):
    e2 = f * (2 - f)
    p0 = np.deg2rad(lat0)
    w0 = 1 - e2 * np.sin(p0) ** 2
    nu0 = a / np.sqrt(w0)
    rho0 = a * (1 - e2) / w0 ** 1.5
    A = 1 + h0 / nu0
    B = np.tan(p0) / (2 * rho0 * nu0)
    G = 1 + h0 / rho0
    return e2, p0, float(A), float(B), float(G), float(rho0)


def _colurban_forward(lon, lat, lat0, lon0, h0, fe, fn, a, f):
    """Colombia Urban (EPSG 1052): a plane at elevation h0 over the
    origin.  E = FE + A nu(phi) cos(phi) dlam; N = FN + G rho0
    [(phi-phi0) + B dlam^2 nu^2 cos^2 phi] — verified <1e-5 m against
    the PROJ oracle across five MAGNA-SIRGAS urban zones."""
    e2, p0, A, B, G, rho0 = _colurban_consts(lat0, h0, a, f)
    ph = np.deg2rad(np.asarray(lat, dtype=np.float64))
    dl = np.deg2rad(np.asarray(lon, dtype=np.float64) - lon0)
    nc = a / np.sqrt(1 - e2 * np.sin(ph) ** 2) * np.cos(ph)
    E = fe + A * nc * dl
    N = fn + G * rho0 * ((ph - p0) + B * (dl * nc) ** 2)
    return E, N


def _colurban_inverse(x, y, lat0, lon0, h0, fe, fn, a, f):
    """Exact closed form: dlam * nu cos(phi) = (E-FE)/A eliminates the
    quadratic term, giving phi directly, then lambda."""
    e2, p0, A, B, G, rho0 = _colurban_consts(lat0, h0, a, f)
    t = (np.asarray(x, dtype=np.float64) - fe) / A
    ph = p0 + (np.asarray(y, dtype=np.float64) - fn) / (G * rho0) \
        - B * t * t
    nc = a / np.sqrt(1 - e2 * np.sin(ph) ** 2) * np.cos(ph)
    return np.rad2deg(t / nc) + lon0, np.rad2deg(ph)


# New Zealand Map Grid (EPSG 9811; Reilly 1973 / LINZ LINZG25700):
# a 6th-order complex polynomial in (scaled latitude series, dlon).
# Constants are the published LINZ values (byte-identical to the
# tables in the system libproj, from which they were verified).
_NZMG_TPSI = (0.6399175073, -0.1358797613, 0.063294409, -0.02526853,
              0.0117879, -0.0055161, 0.0026906, -0.001333, 0.00067,
              -0.00034)
_NZMG_TPHI = (1.5627014243, 0.5185406398, -0.03333098, -0.1052906,
              -0.0368594, 0.007317, 0.01220, 0.00394, -0.0013)
_NZMG_BF = (0.7557853228 + 0.0j, 0.249204646 + 0.003371507j,
            -0.001541739 + 0.041058560j, -0.10162907 + 0.01727609j,
            -0.26623489 - 0.36249218j, -0.6870983 - 1.1651967j)


def _nzmg_forward(lon, lat, lat0, lon0, fe, fn, a, f=None):
    dphi = (np.asarray(lat, dtype=np.float64) - lat0) * 3600e-5
    acc = np.zeros_like(dphi)
    for c in reversed(_NZMG_TPSI):
        acc = acc * dphi + c
    psi = acc * dphi
    z = psi + 1j * np.deg2rad(np.asarray(lon, dtype=np.float64)
                              - lon0)
    w = np.zeros_like(z)
    for c in reversed(_NZMG_BF):
        w = w * z + c
    w = w * z
    return fe + w.imag * a, fn + w.real * a


def _nzmg_inverse(x, y, lat0, lon0, fe, fn, a, f=None):
    w = ((np.asarray(y, dtype=np.float64) - fn)
         + 1j * (np.asarray(x, dtype=np.float64) - fe)) / a
    z = w / _NZMG_BF[0]
    for _ in range(12):                  # Newton on sum bf[i] z^(i+1)
        p = np.zeros_like(z)
        dp = np.zeros_like(z)
        for i in reversed(range(len(_NZMG_BF))):
            p = p * z + _NZMG_BF[i]
            dp = dp * z + (i + 1) * _NZMG_BF[i]
        p = p * z                        # f(z)
        z = z - (p - w) / dp
    psi = z.real
    acc = np.zeros_like(psi)
    for c in reversed(_NZMG_TPHI):
        acc = acc * psi + c
    dphi = acc * psi
    lat = lat0 + dphi / 3600e-5
    lon = lon0 + np.rad2deg(z.imag)
    return lon, lat


_PROJ_DB = "/usr/share/proj/proj.db"

# EPSG unit-of-measure -> factor to metres / degrees
_LINEAR_UOM = {9001: 1.0, 9002: 0.3048, 9003: 1200.0 / 3937.0,
               9036: 1000.0, 1025: 0.001, 1033: 0.01}

# rotation / scale-difference units used by Helmert records
_ROT_UOM = {9101: 1.0, 9104: np.pi / (180.0 * 3600.0),   # rad, arcsec
            9109: 1e-6,                                   # microradian
            1031: np.pi / (180.0 * 3600.0) / 1000.0,      # milliarcsec
            9112: np.pi / 200.0 / 100.0,                  # centesimal min
            9113: np.pi / 200.0 / 10000.0}                # centesimal sec
_SCALE_UOM = {9201: 1.0, 9202: 1e-6, 1028: 1e-9}  # unity, ppm, ppb


@lru_cache(maxsize=64)
def _linear_factor(uom):
    """Metres per unit for an EPSG linear unit-of-measure code; the
    common codes come from the table above, anything else (Sears
    yards/links, Indian feet, ...) from the PROJ database."""
    if uom in _LINEAR_UOM:
        return _LINEAR_UOM[uom]
    import os
    import sqlite3
    if os.path.exists(_PROJ_DB):
        db = sqlite3.connect(_PROJ_DB)
        try:
            row = db.execute(
                "SELECT conv_factor FROM unit_of_measure WHERE "
                "auth_name='EPSG' AND code=? AND type='length'",
                (str(uom),)).fetchone()
        finally:
            db.close()
        if row and row[0]:
            return float(row[0])
    raise ValueError(f"unsupported EPSG linear unit {uom}")


def _geodetic_to_ecef(lon, lat, a, f):
    """Geographic (degrees, h=0) -> geocentric cartesian (metres)."""
    e2 = f * (2 - f)
    phi = np.deg2rad(np.asarray(lat, dtype=np.float64))
    lam = np.deg2rad(np.asarray(lon, dtype=np.float64))
    nu = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
    return (nu * np.cos(phi) * np.cos(lam),
            nu * np.cos(phi) * np.sin(lam),
            nu * (1 - e2) * np.sin(phi))


def _ecef_to_geodetic(X, Y, Z, a, f):
    """Geocentric cartesian -> geographic (degrees), height dropped."""
    e2 = f * (2 - f)
    lam = np.arctan2(Y, X)
    pr = np.hypot(X, Y)
    phi = np.arctan2(Z, pr * (1 - e2))
    for _ in range(8):
        nu = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
        phi = np.arctan2(Z + e2 * nu * np.sin(phi), pr)
    return np.rad2deg(lam), np.rad2deg(phi)


# datums whose WGS84 relationship is grid-defined and whose Helmert
# variants scatter by tens of metres between regions — single-record
# shifts would silently mislocate, so these always raise
_GRID_ONLY_DATUM_CRS = {4267, 4268}          # NAD27, NAD27(76)


@lru_cache(maxsize=128)
def _datum_rows(geod_code):
    """All non-deprecated static Helmert records between a geographic
    CRS and WGS84, with their area-of-use bounding boxes.

    Each row: ``(accuracy, code, bbox, (t, r, s, p, inverted))`` —
    translations (m), rotations (rad, position-vector convention;
    coordinate-frame records negated on load), scale difference,
    Molodensky-Badekas pivot (m), and whether the record is stored
    WGS84->datum.  ``bbox`` is (south, north, west, east) or None."""
    import os
    import sqlite3
    if not os.path.exists(_PROJ_DB):
        return ()
    db = sqlite3.connect(_PROJ_DB)
    try:
        rows = db.execute(
            "SELECT h.method_code, h.source_crs_code, h.tx, h.ty, "
            "h.tz, h.translation_uom_code, h.rx, h.ry, h.rz, "
            "h.rotation_uom_code, h.scale_difference, "
            "h.scale_difference_uom_code, h.px, h.py, h.pz, "
            "h.pivot_uom_code, h.accuracy, h.code, "
            "x.south_lat, x.north_lat, x.west_lon, x.east_lon "
            "FROM helmert_transformation_table h "
            "LEFT JOIN usage u ON u.object_table_name="
            "'helmert_transformation' AND u.object_code=h.code "
            "AND u.object_auth_name=h.auth_name "
            "LEFT JOIN extent x ON x.code=u.extent_code "
            "AND x.auth_name=u.extent_auth_name "
            "WHERE h.auth_name='EPSG' AND h.deprecated=0 "
            "AND h.method_code IN (9603, 9606, 9607, 9636) "
            "AND ((h.source_crs_code=? AND h.target_crs_code='4326') "
            "  OR (h.source_crs_code='4326' AND h.target_crs_code=?))",
            (str(geod_code), str(geod_code))).fetchall()
    finally:
        db.close()
    out = []
    for (m, src, tx, ty, tz, tuom, rx, ry, rz, ruom, ds, suom,
         px, py, pz, puom, acc, code, s_lat, n_lat, w_lon,
         e_lon) in rows:
        tf = _LINEAR_UOM[tuom]
        t = (tx * tf, ty * tf, tz * tf)
        r = (0.0, 0.0, 0.0)
        s = 0.0
        p = (0.0, 0.0, 0.0)
        if m != 9603:
            rf = _ROT_UOM[ruom]
            r = (rx * rf, ry * rf, rz * rf)
            if m in (9607, 9636):    # coordinate frame -> pos. vector
                r = (-r[0], -r[1], -r[2])
            s = (ds or 0.0) * _SCALE_UOM[suom]
            if m == 9636:
                pf = _LINEAR_UOM[puom]
                p = (px * pf, py * pf, pz * pf)
        bbox = (None if s_lat is None
                else (s_lat, n_lat, w_lon, e_lon))
        out.append((float(acc) if acc is not None else 999.0,
                    int(code), bbox,
                    (t, r, s, p, str(src) != str(geod_code))))
    return tuple(out)


def _bbox_contains(bbox, lon, lat):
    if bbox is None:
        return False
    s, n, w, e = bbox
    if not (s <= lat <= n):
        return False
    if w <= e:
        return w <= lon <= e
    return lon >= w or lon <= e      # extent spans the antimeridian


def _helmert_at(geod_code, a, f, lon, lat):
    """Datum-shift record for a geodetic CRS at a location, or None
    for WGS84-equivalent handling.

    Selection mirrors PROJ: rows whose area of use contains the point
    first (falling back to all rows), then lowest published accuracy,
    newest code on ties.  Policy: GRS80/WGS84-class datums are
    WGS84-equivalent (null shift — PROJ's datum-ensemble handling for
    NAD83, ETRS89, GDA, SIRGAS, ... which keeps the sub-cm oracle
    agreement) EXCEPT when the registry records a large (>5 m)
    Helmert — e.g. GGRS87 at ~320 m or Israel 1993 — where ignoring
    the datum would silently mislocate by that much."""
    rows = _datum_rows(geod_code)
    if not rows:
        return None
    pool = [r for r in rows if _bbox_contains(r[2], lon, lat)]
    if not pool:
        pool = list(rows)
    pool.sort(key=lambda r: (r[0], -r[1]))
    hel = pool[0][3]
    if (abs(a - _WGS84_A) <= 0.5 and abs(f - _WGS84_F) <= 1e-6
            and float(np.hypot(np.hypot(hel[0][0], hel[0][1]),
                               hel[0][2])) <= 5.0):
        return None
    return hel


@lru_cache(maxsize=64)
def _greenwich_sibling(geod_code):
    """For a geographic CRS on a non-Greenwich prime meridian (NTF
    (Paris), Monte Mario (Rome), ...), the registry's longitude-
    rotation record names the Greenwich-referenced sibling that the
    datum-shift records are keyed to.  Returns geod_code unchanged
    when there is none."""
    import os
    import sqlite3
    if not os.path.exists(_PROJ_DB):
        return geod_code
    db = sqlite3.connect(_PROJ_DB)
    try:
        row = db.execute(
            "SELECT target_crs_code FROM other_transformation "
            "WHERE auth_name='EPSG' AND deprecated=0 "
            "AND method_code=9601 AND source_crs_code=?",
            (str(geod_code),)).fetchone()
    finally:
        db.close()
    return int(row[0]) if row else geod_code


@lru_cache(maxsize=256)
def _is_wgs84_equiv(geod_code):
    """True when a geographic CRS rides the WGS84-equivalent null
    path: GRS80/WGS84-class ellipsoid and no large registry shift.
    Deliberately avoids ``_epsg_db_geographic`` so grid-record
    evaluation cannot recurse through datum eligibility."""
    import os
    import sqlite3
    if not os.path.exists(_PROJ_DB):
        return False
    db = sqlite3.connect(_PROJ_DB)
    try:
        row = db.execute(
            "SELECT e.semi_major_axis, e.inv_flattening, "
            "e.semi_minor_axis, e.uom_code FROM geodetic_crs g "
            "JOIN geodetic_datum d ON d.code = g.datum_code "
            "AND d.auth_name = g.datum_auth_name "
            "JOIN ellipsoid e ON e.code = d.ellipsoid_code "
            "AND e.auth_name = d.ellipsoid_auth_name "
            "WHERE g.auth_name='EPSG' AND g.code=?",
            (str(geod_code),)).fetchone()
    finally:
        db.close()
    if row is None:
        return False
    a, invf, b, ell_uom = row
    a *= _linear_factor(ell_uom)   # Clarke-foot/link-defined ellipsoids
    f = 1.0 / invf if invf else (a - b * _linear_factor(ell_uom)) / a
    if abs(a - _WGS84_A) > 0.5 or abs(f - _WGS84_F) > 1e-6:
        return False
    return _helmert_at(geod_code, a, f, np.nan, np.nan) is None


@lru_cache(maxsize=128)
def _grid_records(geod_code):
    """Installed NTv2 datum-shift grids between a geographic CRS and
    a WGS84-equivalent frame, best accuracy first.

    Each row: ``(accuracy, code, path, inverted)`` where ``inverted``
    means the record is stored WGS84-side -> datum.  Only records
    whose .gsb file exists under the PROJ data dir are returned."""
    import os
    import sqlite3
    from . import ntv2
    if not os.path.exists(_PROJ_DB):
        return ()
    db = sqlite3.connect(_PROJ_DB)
    try:
        rows = db.execute(
            "SELECT g.code, g.source_crs_code, g.target_crs_code, "
            "g.grid_name, g.accuracy, "
            "COALESCE(a.old_proj_grid_name, g.grid_name), "
            "COALESCE(a.inverse_direction, 0) "
            "FROM grid_transformation g "
            "LEFT JOIN grid_alternatives a "
            "ON a.original_grid_name = g.grid_name "
            "WHERE g.auth_name='EPSG' AND g.deprecated=0 "
            "AND g.method_code=9615 "
            "AND (g.source_crs_code=? OR g.target_crs_code=?)",
            (str(geod_code), str(geod_code))).fetchall()
    finally:
        db.close()
    out = []
    for code, src, tgt, _name, acc, fname, inv_dir in rows:
        other = tgt if str(src) == str(geod_code) else src
        # the far side must be a WGS84-equivalent frame (ETRS89,
        # NZGD2000, RGF93, CHTRS95, WGS84 itself, ...)
        if other != "4326" and not _is_wgs84_equiv(int(other)):
            continue
        path = ntv2._find_grid_file(fname)
        if path is None:
            continue
        # record direction XOR file-native direction (PROJ's
        # grid_alternatives.inverse_direction: the .gsb is stored
        # opposite to the EPSG operation, e.g. rgf93_ntf)
        inverted = (str(src) != str(geod_code)) != bool(inv_dir)
        out.append((float(acc) if acc is not None else 999.0,
                    int(code), path, inverted))
    out.sort(key=lambda r: (r[0], -r[1]))
    return tuple(out)


def _grid_at(geod_code, lon, lat):
    """Best installed NTv2 grid covering the location, or None."""
    from . import ntv2
    if not np.isfinite(lon) or not np.isfinite(lat):
        return None
    for _acc, _code, path, inverted in _grid_records(geod_code):
        try:
            if ntv2.grid_covers(path, lon, lat):
                return path, inverted
        except (OSError, ValueError) as e:
            # a truncated/corrupt .gsb must not SILENTLY degrade the
            # transform to the (less accurate) Helmert fallback
            import warnings
            warnings.warn(f"NTv2 grid {path} unusable ({e}); "
                          "falling back to Helmert parameters")
            continue
    return None


def _datum_eligibility(geod_code, a, f, code, ell_name):
    """Parse-time check that a datum is transformable at all; raises
    the clear grid-needed error otherwise.  Returns the geodetic CRS
    code to carry (the null-shift policy itself is point-dependent
    and applied later by ``_helmert_at``)."""
    geod_code = _greenwich_sibling(int(geod_code))
    grs80_class = (abs(a - _WGS84_A) <= 0.5
                   and abs(f - _WGS84_F) <= 1e-6)
    if not grs80_class and _grid_records(geod_code):
        return geod_code             # installed NTv2 grid suffices
    if geod_code in _GRID_ONLY_DATUM_CRS or (
            not grs80_class and not _datum_rows(geod_code)):
        raise ValueError(
            f"EPSG:{code} is based on {ell_name} and its datum's "
            "WGS84 relationship is grid-defined (or the PROJ database "
            "has no Helmert transformation for it) — a correct "
            "transform needs datum-shift grids (e.g. NAD27/NADCON)")
    return geod_code


def _helmert_apply(xyz, hel, to_wgs84):
    """Apply a ``_helmert_to_wgs84`` record to geocentric coords.

    EPSG position-vector form Xt = T + P + (1+ds) R (Xs - P); the
    stored direction is honoured via ``inverted`` and the exact matrix
    inverse (not the negated-parameter approximation)."""
    t, r, s, p, inverted = hel
    X = np.stack([np.asarray(c, dtype=np.float64) for c in xyz],
                 axis=-1)
    M = (1.0 + s) * np.array([[1.0, -r[2], r[1]],
                              [r[2], 1.0, -r[0]],
                              [-r[1], r[0], 1.0]])
    T = np.asarray(t)
    P = np.asarray(p)
    forward = to_wgs84 != inverted   # apply record as stored?
    if forward:
        Y = (X - P) @ M.T + P + T
    else:
        Y = np.linalg.solve(M, (X - P - T)[..., None])[..., 0] + P
    return Y[..., 0], Y[..., 1], Y[..., 2]


def _datum_bridge(lon, lat, p_from, p_to):
    """Shift geographic coordinates between datums via geocentric
    Helmert legs (source -> WGS84 -> target).  ``p_from`` / ``p_to``
    are parameter dicts (or None for the built-in WGS84-class
    families).  The Helmert record for each leg is selected by the
    data's mean location (area-of-use filtering, like PROJ)."""
    geod_f = (p_from or {}).get("geod")
    geod_t = (p_to or {}).get("geod")
    if geod_f == geod_t:             # same datum (incl. both None)
        return lon, lat
    mlon = float(np.mean(np.asarray(lon, dtype=np.float64)))
    mlat = float(np.mean(np.asarray(lat, dtype=np.float64)))
    if not (np.isfinite(mlon) and np.isfinite(mlat)):
        mlon = mlat = np.nan         # no area filter, best accuracy
    from . import ntv2
    if geod_f is not None:
        grid = _grid_at(geod_f, mlon, mlat)
        if grid is not None:         # NTv2 grid beats single Helmert
            path, inverted = grid
            lon, lat = ntv2.apply_grid(path, lon, lat,
                                       inverse=inverted)
        else:
            hel = _helmert_at(geod_f, p_from["a"], p_from["f"],
                              mlon, mlat)
            if hel is not None:
                xyz = _geodetic_to_ecef(lon, lat, p_from["a"],
                                        p_from["f"])
                xyz = _helmert_apply(xyz, hel, to_wgs84=True)
                lon, lat = _ecef_to_geodetic(*xyz, _WGS84_A,
                                             _WGS84_F)
    if geod_t is not None:
        grid = _grid_at(geod_t, mlon, mlat)
        if grid is not None:
            path, inverted = grid
            lon, lat = ntv2.apply_grid(path, lon, lat,
                                       inverse=not inverted)
        else:
            hel = _helmert_at(geod_t, p_to["a"], p_to["f"],
                              mlon, mlat)
            if hel is not None:
                xyz = _geodetic_to_ecef(lon, lat, _WGS84_A,
                                        _WGS84_F)
                xyz = _helmert_apply(xyz, hel, to_wgs84=False)
                lon, lat = _ecef_to_geodetic(*xyz, p_to["a"],
                                             p_to["f"])
    return lon, lat


def _angle_from_uom(v, uom):
    if uom in (9102, 9122):   # degree (9122: supplier-defined)
        return float(v)
    if uom == 9105:      # grad (centesimal degree)
        return float(v) * 0.9
    if uom == 9110:      # sexagesimal DMS as DD.MMSSsss
        sign = -1.0 if v < 0 else 1.0
        v = abs(float(v))
        d = np.floor(v + 1e-12)
        rem = (v - d) * 100
        m = np.floor(rem + 1e-9)
        s = (rem - m) * 100
        return float(sign * (d + m / 60 + s / 3600))
    if uom == 9101:      # radian
        return float(np.rad2deg(v))
    raise ValueError(f"unsupported EPSG angle unit {uom}")


@lru_cache(maxsize=256)
def _epsg_db_params(code):
    """Projected-CRS parameters from the system PROJ database.

    Returns ``None`` when the database is missing or the code is not a
    supported projection method; raises for non-GRS80-class datums
    (a transform there needs datum-shift grids, not just formulas).
    """
    import os
    import sqlite3
    if not os.path.exists(_PROJ_DB):
        return None
    db = sqlite3.connect(_PROJ_DB)
    try:
        c = db.cursor()
        c.execute("SELECT coordinate_system_code, geodetic_crs_code, "
                  "conversion_code, name FROM projected_crs WHERE "
                  "auth_name='EPSG' AND code=?", (str(code),))
        row = c.fetchone()
        if row is None:
            return None
        cs_code, geod_code, conv_code, name = row
        c.execute("SELECT * FROM conversion_table WHERE "
                  "auth_name='EPSG' AND code=?", (str(conv_code),))
        conv = c.fetchone()
        if conv is None:
            return None
        cols = [d[0] for d in c.description]
        conv = dict(zip(cols, conv))
        method = conv["method_code"]
        if method not in (9807, 9802, 9801, 9822, 9829, 9810, 9804,
                          9805, 9808, 9820, 9812, 9815, 9809, 9806,
                          1028, 9811, 1052, 9819, 1041):
            return None
        params = {}
        for i in range(1, 8):
            pc = conv.get(f"param{i}_code")
            if pc is None:
                continue
            params[pc] = (conv[f"param{i}_value"],
                          conv[f"param{i}_uom_code"])
        # axis unit (metre / foot / ftUS)
        c.execute("SELECT uom_code FROM axis WHERE auth_name='EPSG' "
                  "AND coordinate_system_code=? ORDER BY "
                  "coordinate_system_order", (cs_code,))
        ax = c.fetchone()
        unit = _linear_factor(ax[0] if ax else 9001)
        # ellipsoid: must be GRS80/WGS84-class (no datum shift engine)
        c.execute(
            "SELECT e.semi_major_axis, e.inv_flattening, "
            "e.semi_minor_axis, e.name, pm.longitude, pm.uom_code, "
            "e.uom_code FROM geodetic_crs g "
            "JOIN geodetic_datum d ON d.code = g.datum_code "
            "AND d.auth_name = g.datum_auth_name "
            "JOIN ellipsoid e ON e.code = d.ellipsoid_code "
            "AND e.auth_name = d.ellipsoid_auth_name "
            "JOIN prime_meridian pm ON pm.code = d.prime_meridian_code "
            "AND pm.auth_name = d.prime_meridian_auth_name "
            "WHERE g.auth_name='EPSG' AND g.code=?", (geod_code,))
        ell = c.fetchone()
        a, invf, b, ell_name, pm_lon, pm_uom, ell_uom = ell
        # a handful of ellipsoids (Clarke 1858/1880, Everest 1830) are
        # DEFINED in feet/links in the EPSG registry — convert to
        # metres or every projection on them is ~wholesale wrong
        # (found by the registry-wide round-trip sweep)
        a *= _linear_factor(ell_uom)
        f = (1.0 / invf if invf
             else (a - b * _linear_factor(ell_uom)) / a)
        # non-Greenwich prime meridian (Paris, Rome, ...): longitude
        # parameters fold the meridian offset in, so all internal
        # geographic coordinates stay Greenwich-referenced
        pm_deg = _angle_from_uom(pm_lon, pm_uom) if pm_lon else 0.0
        geod = _datum_eligibility(geod_code, a, f,
                                  f"{code} ({name})", ell_name)
        base = {"unit": unit, "a": a, "f": f, "geod": geod}

        def ang(pc, default=None):
            if pc not in params:
                return default
            return _angle_from_uom(*params[pc])

        def lng(pc):
            """Longitude-of-origin parameter, Greenwich-referenced."""
            return (ang(pc, 0.0) or 0.0) + pm_deg

        def lin(pc, default=0.0):
            if pc not in params:
                return default
            v, uom = params[pc]
            return float(v) * _linear_factor(uom)

        if method in (9807, 9808):
            return {"method": "tm" if method == 9807 else "tmso",
                    **base,
                    "lat0": ang(8801, 0.0), "lon0": lng(8802),
                    "k0": float(params.get(8805, (1.0, 9201))[0]),
                    "fe": lin(8806), "fn": lin(8807)}
        if method in (9804, 9805):
            return {"method": "merc", **base,
                    "lat_ts": ang(8823) if method == 9805 else None,
                    "k0": float(params.get(8805, (1.0, 9201))[0]),
                    "lon0": lng(8802),
                    "fe": lin(8806), "fn": lin(8807)}
        if method == 9820:
            return {"method": "laea", **base,
                    "lat0": ang(8801, 0.0), "lon0": lng(8802),
                    "fe": lin(8806), "fn": lin(8807)}
        if method in (9812, 9815):
            return {"method": "hom", **base,
                    "variant_b": method == 9815,
                    "latc": ang(8811, 0.0), "lonc": lng(8812),
                    "alphac": ang(8813, 0.0), "gammac": ang(8814, 0.0),
                    "k0": float(params.get(8815, (1.0, 9201))[0]),
                    "fe": lin(8816 if method == 9815 else 8806),
                    "fn": lin(8817 if method == 9815 else 8807)}
        if method == 9809:
            return {"method": "ostereo", **base,
                    "lat0": ang(8801, 0.0), "lon0": lng(8802),
                    "k0": float(params.get(8805, (1.0, 9201))[0]),
                    "fe": lin(8806), "fn": lin(8807)}
        if method == 9806:
            return {"method": "cass", **base,
                    "lat0": ang(8801, 0.0), "lon0": lng(8802),
                    "fe": lin(8806), "fn": lin(8807)}
        if method in (9819, 1041):
            return {"method": "krovak", **base,
                    "east_north": method == 1041,
                    "latc": ang(8811, 0.0), "lon0": lng(8833),
                    "alphac": ang(1036, 0.0), "latp": ang(8818, 0.0),
                    "kp": float(params.get(8819, (1.0, 9201))[0]),
                    "fe": lin(8806), "fn": lin(8807)}
        if method == 1052:
            return {"method": "colurban", **base,
                    "lat0": ang(8801, 0.0), "lon0": lng(8802),
                    "h0": lin(1039), "fe": lin(8806),
                    "fn": lin(8807)}
        if method == 9811:
            return {"method": "nzmg", **base,
                    "lat0": ang(8801, 0.0), "lon0": lng(8802),
                    "fe": lin(8806), "fn": lin(8807)}
        if method == 1028:
            return {"method": "eqc", **base,
                    "lat_ts": ang(8823, 0.0), "lon0": lng(8802),
                    "fe": lin(8806), "fn": lin(8807)}
        if method == 9802:
            return {"method": "lcc", **base,
                    "lat0": ang(8821, 0.0), "lon0": lng(8822),
                    "sp1": ang(8823), "sp2": ang(8824), "k0": 1.0,
                    "fe": lin(8826), "fn": lin(8827)}
        if method == 9822:
            return {"method": "aea", **base,
                    "lat0": ang(8821, 0.0), "lon0": lng(8822),
                    "sp1": ang(8823), "sp2": ang(8824),
                    "fe": lin(8826), "fn": lin(8827)}
        if method == 9829:
            return {"method": "ps", **base,
                    "lat_ts": ang(8832), "lat0": None, "k0": None,
                    "lon0": lng(8833),
                    "fe": lin(8806), "fn": lin(8807)}
        if method == 9810:
            return {"method": "ps", **base,
                    "lat_ts": None, "lat0": ang(8801, 90.0),
                    "k0": float(params.get(8805, (1.0, 9201))[0]),
                    "lon0": lng(8802),
                    "fe": lin(8806), "fn": lin(8807)}
        # 9801: one standard parallel at the natural origin
        return {"method": "lcc", **base,
                "lat0": ang(8801, 0.0), "lon0": lng(8802),
                "sp1": None, "sp2": None,
                "k0": float(params.get(8805, (1.0, 9201))[0]),
                "fe": lin(8806), "fn": lin(8807)}
    finally:
        db.close()


def _db_forward(lon, lat, p):
    if p["method"] == "tm":
        x, y = _tm_forward(lon, lat, p["lat0"], p["lon0"], p["k0"],
                           p["fe"], p["fn"], p["a"], p["f"])
    elif p["method"] == "tmso":
        # EPSG 9808: TM with axes positive west and south
        xt, yt = _tm_forward(lon, lat, p["lat0"], p["lon0"], p["k0"],
                             0.0, 0.0, p["a"], p["f"])
        x, y = p["fe"] - xt, p["fn"] - yt
    elif p["method"] == "merc":
        x, y = _merc_forward(lon, lat, p["lat_ts"], p["k0"], p["lon0"],
                             p["fe"], p["fn"], p["a"], p["f"])
    elif p["method"] == "laea":
        x, y = _laea_forward(lon, lat, p["lat0"], p["lon0"],
                             p["fe"], p["fn"], p["a"], p["f"])
    elif p["method"] == "hom":
        x, y = _hom_forward(lon, lat, p["latc"], p["lonc"],
                            p["alphac"], p["gammac"], p["k0"],
                            p["fe"], p["fn"], p["variant_b"],
                            p["a"], p["f"])
    elif p["method"] == "ostereo":
        x, y = _ostereo_forward(lon, lat, p["lat0"], p["lon0"],
                                p["k0"], p["fe"], p["fn"],
                                p["a"], p["f"])
    elif p["method"] == "cass":
        x, y = _cass_forward(lon, lat, p["lat0"], p["lon0"],
                             p["fe"], p["fn"], p["a"], p["f"])
    elif p["method"] == "eqc":
        x, y = _eqc_forward(lon, lat, p["lat_ts"], p["lon0"],
                            p["fe"], p["fn"], p["a"], p["f"])
    elif p["method"] == "nzmg":
        x, y = _nzmg_forward(lon, lat, p["lat0"], p["lon0"],
                             p["fe"], p["fn"], p["a"])
    elif p["method"] == "colurban":
        x, y = _colurban_forward(lon, lat, p["lat0"], p["lon0"],
                                 p["h0"], p["fe"], p["fn"],
                                 p["a"], p["f"])
    elif p["method"] == "krovak":
        x, y = _krovak_forward(lon, lat, p["latc"], p["lon0"],
                               p["alphac"], p["latp"], p["kp"],
                               p["fe"], p["fn"], p["east_north"],
                               p["a"], p["f"])
    elif p["method"] == "aea":
        x, y = _aea_forward(lon, lat, p["lat0"], p["lon0"], p["sp1"],
                            p["sp2"], p["fe"], p["fn"], p["a"], p["f"])
    elif p["method"] == "ps":
        x, y = _ps_forward(lon, lat, p["lat_ts"], p["lat0"], p["k0"],
                           p["lon0"], p["fe"], p["fn"], p["a"], p["f"])
    else:
        x, y = _lcc_forward(lon, lat, p["lat0"], p["lon0"], p["sp1"],
                            p["sp2"], p["k0"], p["fe"], p["fn"],
                            p["a"], p["f"])
    return x / p["unit"], y / p["unit"]


def _db_inverse(x, y, p):
    x = np.asarray(x, dtype=np.float64) * p["unit"]
    y = np.asarray(y, dtype=np.float64) * p["unit"]
    if p["method"] == "tm":
        return _tm_inverse(x, y, p["lat0"], p["lon0"], p["k0"],
                           p["fe"], p["fn"], p["a"], p["f"])
    if p["method"] == "tmso":
        return _tm_inverse(p["fe"] - x, p["fn"] - y, p["lat0"],
                           p["lon0"], p["k0"], 0.0, 0.0,
                           p["a"], p["f"])
    if p["method"] == "merc":
        return _merc_inverse(x, y, p["lat_ts"], p["k0"], p["lon0"],
                             p["fe"], p["fn"], p["a"], p["f"])
    if p["method"] == "laea":
        return _laea_inverse(x, y, p["lat0"], p["lon0"],
                             p["fe"], p["fn"], p["a"], p["f"])
    if p["method"] == "hom":
        return _hom_inverse(x, y, p["latc"], p["lonc"], p["alphac"],
                            p["gammac"], p["k0"], p["fe"], p["fn"],
                            p["variant_b"], p["a"], p["f"])
    if p["method"] == "ostereo":
        return _ostereo_inverse(x, y, p["lat0"], p["lon0"], p["k0"],
                                p["fe"], p["fn"], p["a"], p["f"])
    if p["method"] == "cass":
        return _cass_inverse(x, y, p["lat0"], p["lon0"],
                             p["fe"], p["fn"], p["a"], p["f"])
    if p["method"] == "eqc":
        return _eqc_inverse(x, y, p["lat_ts"], p["lon0"],
                            p["fe"], p["fn"], p["a"], p["f"])
    if p["method"] == "nzmg":
        return _nzmg_inverse(x, y, p["lat0"], p["lon0"],
                             p["fe"], p["fn"], p["a"])
    if p["method"] == "colurban":
        return _colurban_inverse(x, y, p["lat0"], p["lon0"],
                                 p["h0"], p["fe"], p["fn"],
                                 p["a"], p["f"])
    if p["method"] == "krovak":
        return _krovak_inverse(x, y, p["latc"], p["lon0"],
                               p["alphac"], p["latp"], p["kp"],
                               p["fe"], p["fn"], p["east_north"],
                               p["a"], p["f"])
    if p["method"] == "aea":
        return _aea_inverse(x, y, p["lat0"], p["lon0"], p["sp1"],
                            p["sp2"], p["fe"], p["fn"], p["a"], p["f"])
    if p["method"] == "ps":
        return _ps_inverse(x, y, p["lat_ts"], p["lat0"], p["k0"],
                           p["lon0"], p["fe"], p["fn"], p["a"], p["f"])
    return _lcc_inverse(x, y, p["lat0"], p["lon0"], p["sp1"],
                        p["sp2"], p["k0"], p["fe"], p["fn"],
                        p["a"], p["f"])


@lru_cache(maxsize=128)
def _epsg_db_geographic(code):
    """Geographic 2D/3D CRS parameters (ellipsoid + datum bridge)
    from the system PROJ database, or None."""
    import os
    import sqlite3
    if not os.path.exists(_PROJ_DB):
        return None
    db = sqlite3.connect(_PROJ_DB)
    try:
        row = db.execute(
            "SELECT g.type, e.semi_major_axis, e.inv_flattening, "
            "e.semi_minor_axis, e.name, e.uom_code FROM geodetic_crs g "
            "JOIN geodetic_datum d ON d.code = g.datum_code "
            "AND d.auth_name = g.datum_auth_name "
            "JOIN ellipsoid e ON e.code = d.ellipsoid_code "
            "AND e.auth_name = d.ellipsoid_auth_name "
            "WHERE g.auth_name='EPSG' AND g.code=? AND g.deprecated=0",
            (str(code),)).fetchone()
    finally:
        db.close()
    if row is None or not row[0].startswith("geographic"):
        return None
    _, a, invf, b, ell_name, ell_uom = row
    a *= _linear_factor(ell_uom)
    f = 1.0 / invf if invf else (a - b * _linear_factor(ell_uom)) / a
    return {"a": a, "f": f,
            "geod": _datum_eligibility(code, a, f, code, ell_name)}


def _parse_epsg(code):
    code = int(code)
    if code in (4326, 4269):
        # 4269 = NAD83 geographic.  GRS80 and WGS84 ellipsoids agree to
        # <0.1 mm in the projection series and the NAD83<->WGS84 datum
        # shift is ~1-2 m (below neilpy's DEM-cellsize accuracy class),
        # so NAD83 coordinates ride the same machinery.
        return ("geographic", None, None)
    if code == 3857:
        return ("webmercator", None, None)
    if 32601 <= code <= 32660:
        return ("utm", code - 32600, True)
    if 32701 <= code <= 32760:
        return ("utm", code - 32700, False)
    if 26901 <= code <= 26923:
        # NAD83 / UTM zones 1N-23N (US lidar's most common CRS family)
        return ("utm", code - 26900, True)
    # anything else: look the projection up in the system PROJ
    # database (covers the NAD83 State Plane zones and their ftUS
    # twins, among ~thousands of TM/LCC codes)
    p = _epsg_db_params(code)
    if p is not None:
        return ("db", p, None)
    g = _epsg_db_geographic(code)
    if g is not None:
        return ("geographic", g, None)
    raise ValueError(
        f"EPSG:{code} not supported by the built-in transform engine. "
        "Supported families: 4326 (WGS84 geographic), 4269 (NAD83 "
        "geographic), 326xx/327xx (WGS84 UTM north/south), 269xx "
        "(NAD83 UTM), 3857 (Web Mercator), plus any Transverse "
        "Mercator (incl. South Orientated) / Lambert Conformal Conic "
        "/ Albers Equal Area / Polar Stereographic / Mercator / "
        "Lambert Azimuthal Equal Area / Hotine Oblique Mercator / "
        "Oblique Stereographic / Cassini-Soldner / Equidistant "
        "Cylindrical code on a GRS80-class datum resolvable via "
        "/usr/share/proj/proj.db (e.g. NAD83 State Plane, 5070 CONUS "
        "Albers, 3035 LAEA Europe, 3413/3031 polar)")


def coord_transform(x, y, from_epsg, to_epsg):
    """EPSG -> EPSG transform, ``always_xy`` ordering (parity:
    neilpy.py:108-110).  Non-GRS80-class datums ride a geocentric
    Helmert bridge (source datum -> WGS84 -> target datum)."""
    kind_f, zone_f, north_f = _parse_epsg(from_epsg)
    if kind_f == "geographic":
        lon, lat = (np.asarray(x, dtype=np.float64),
                    np.asarray(y, dtype=np.float64))
    elif kind_f == "utm":
        lon, lat = utm_inverse(x, y, zone_f, north_f)
    elif kind_f == "db":
        lon, lat = _db_inverse(x, y, zone_f)
    else:
        lon, lat = _webmercator_inverse(x, y)

    kind_t, zone_t, north_t = _parse_epsg(to_epsg)
    lon, lat = _datum_bridge(
        lon, lat,
        zone_f if isinstance(zone_f, dict) else None,
        zone_t if isinstance(zone_t, dict) else None)
    if kind_t == "geographic":
        return lon, lat
    if kind_t == "utm":
        return utm_forward(lon, lat, zone_t, north_t)
    if kind_t == "db":
        return _db_forward(lon, lat, zone_t)
    return _webmercator_forward(lon, lat)


def geodesic_inverse(lon1, lat1, lon2, lat2, tol=1e-12, maxiter=200):
    """Vincenty inverse on WGS84: forward azimuth (deg), back azimuth
    (deg), distance (m)."""
    lon1 = np.asarray(lon1, dtype=np.float64)
    lat1 = np.asarray(lat1, dtype=np.float64)
    lon2 = np.asarray(lon2, dtype=np.float64)
    lat2 = np.asarray(lat2, dtype=np.float64)
    a, b, f = _WGS84_A, _WGS84_B, _WGS84_F
    U1 = np.arctan((1 - f) * np.tan(np.deg2rad(lat1)))
    U2 = np.arctan((1 - f) * np.tan(np.deg2rad(lat2)))
    L = np.deg2rad(lon2 - lon1)
    lam = L.copy() if hasattr(L, "copy") else np.float64(L)
    sinU1, cosU1 = np.sin(U1), np.cos(U1)
    sinU2, cosU2 = np.sin(U2), np.cos(U2)
    for _ in range(maxiter):
        sinl, cosl = np.sin(lam), np.cos(lam)
        sin_sigma = np.sqrt((cosU2 * sinl) ** 2
                            + (cosU1 * sinU2 - sinU1 * cosU2 * cosl) ** 2)
        cos_sigma = sinU1 * sinU2 + cosU1 * cosU2 * cosl
        sigma = np.arctan2(sin_sigma, cos_sigma)
        with np.errstate(divide="ignore", invalid="ignore"):
            sin_alpha = np.where(sin_sigma != 0,
                                 cosU1 * cosU2 * sinl / sin_sigma, 0.0)
        cos2_alpha = 1 - sin_alpha ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            cos_2sm = np.where(cos2_alpha != 0,
                               cos_sigma - 2 * sinU1 * sinU2 / cos2_alpha,
                               0.0)
        C = f / 16 * cos2_alpha * (4 + f * (4 - 3 * cos2_alpha))
        lam_new = (L + (1 - C) * f * sin_alpha *
                   (sigma + C * sin_sigma *
                    (cos_2sm + C * cos_sigma * (-1 + 2 * cos_2sm ** 2))))
        if np.all(np.abs(lam_new - lam) < tol):
            lam = lam_new
            break
        lam = lam_new
    u2 = cos2_alpha * (a ** 2 - b ** 2) / b ** 2
    A = 1 + u2 / 16384 * (4096 + u2 * (-768 + u2 * (320 - 175 * u2)))
    B = u2 / 1024 * (256 + u2 * (-128 + u2 * (74 - 47 * u2)))
    sinl, cosl = np.sin(lam), np.cos(lam)
    sin_sigma = np.sqrt((cosU2 * sinl) ** 2
                        + (cosU1 * sinU2 - sinU1 * cosU2 * cosl) ** 2)
    cos_sigma = sinU1 * sinU2 + cosU1 * cosU2 * cosl
    sigma = np.arctan2(sin_sigma, cos_sigma)
    with np.errstate(divide="ignore", invalid="ignore"):
        cos_2sm = np.where(cos2_alpha != 0,
                           cos_sigma - 2 * sinU1 * sinU2 / cos2_alpha, 0.0)
    dsigma = (B * sin_sigma *
              (cos_2sm + B / 4 *
               (cos_sigma * (-1 + 2 * cos_2sm ** 2)
                - B / 6 * cos_2sm * (-3 + 4 * sin_sigma ** 2)
                * (-3 + 4 * cos_2sm ** 2))))
    dist = b * A * (sigma - dsigma)
    fwd = np.rad2deg(np.arctan2(cosU2 * sinl,
                                cosU1 * sinU2 - sinU1 * cosU2 * cosl))
    back = np.rad2deg(np.arctan2(cosU1 * sinl,
                                 -sinU1 * cosU2 + cosU1 * sinU2 * cosl))
    return fwd, back, dist


def great_circle_distance(slat, slon, elat, elon, radius=6372795):
    """Spherical law-of-cosines distance (parity: neilpy.py:888-898)."""
    slat, slon = np.deg2rad(slat), np.deg2rad(slon)
    elat, elon = np.deg2rad(elat), np.deg2rad(elon)
    return np.arccos(np.cos(slat) * np.cos(slon) * np.cos(elat) * np.cos(elon)
                     + np.cos(slat) * np.sin(slon) * np.cos(elat) * np.sin(elon)
                     + np.sin(slat) * np.sin(elat)) * radius
