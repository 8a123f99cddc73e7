"""Bicubic spline interpolation on a uniform grid, evaluated at
scattered points — the equivalent of scipy's
``RectBivariateSpline(kx=3, ky=3, s=0)`` that SMRF uses to lift the
provisional DTM back onto the point cloud (reference:
neilpy/neilpy.py:1768-1790).

PyTorch counterpart of ``neilpy_tpu/ops/spline.py``, with the same
names and arguments plus ``device=`` (numpy input goes to CUDA unless
``device='cpu'``; float32 and float64 keep their dtype).

FITPACK's interpolating bicubic spline on gridded data is the
tensor-product not-a-knot cubic spline, here in moment form: per axis,
a tridiagonal solve for the second derivatives (moments) with
not-a-knot ends, then the local cubic of each query's cell from 16
gathered numbers.  The solve is the Thomas sweep, O(n) sequential steps
each vectorised across the other axis; the bands are constants, so the
forward factors depend only on the position and are computed once on
the host, in the working dtype, and the device runs the right-hand
side's sweep (a few launches a step).  Out-of-domain queries are clamped
to the boundary knots, as FITPACK's ``bispev`` does.

Uniform spacing h=1 with data at ``offset + i`` (SMRF uses pixel
centres 0.5, 1.5, ...).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device import float_tensor, to_device

__all__ = ["spline_coefficients_2d", "spline_ev_2d", "interp_spline_2d"]


@functools.lru_cache(maxsize=16)
def _thomas_factors(m, dtype):
    """Forward factors of the Thomas sweep for the not-a-knot system of
    ``m`` unknowns (rows: identity, then M[j] + 4 M[j+1] + M[j+2], then
    identity), in ``dtype`` as the device would round them: the lower
    band ``a``, the denominators and the ``cp`` factors."""
    one, four, zero = dtype(1), dtype(4), dtype(0)
    a = [zero] + [one] * (m - 2) + [zero]
    b = [one] + [four] * (m - 2) + [one]
    c = [zero] + [one] * (m - 2) + [zero]
    cp_prev = zero
    denom, cp = [], []
    for ai, bi, ci in zip(a, b, c):
        d = dtype(bi - ai * cp_prev)
        cp_prev = dtype(ci / d)
        denom.append(d)
        cp.append(cp_prev)
    return tuple(a), tuple(denom), tuple(cp)


def _thomas(rhs):
    """Solve the not-a-knot tridiagonal system along axis 0 of ``rhs``
    (m rows, vectorised over the trailing axis): the forward sweep
    dp[i] = (rhs[i] - a[i] dp[i-1]) / denom[i], then the back
    substitution x[i] = dp[i] - cp[i] x[i+1]."""
    m = rhs.shape[0]
    a, denom, cp = _thomas_factors(
        m, np.float64 if rhs.dtype == torch.float64 else np.float32)
    dp = torch.empty_like(rhs)
    prev = torch.zeros_like(rhs[0])
    for i in range(m):
        row = rhs[i] - prev if a[i] else rhs[i]
        torch.div(row, float(denom[i]), out=dp[i])
        prev = dp[i]
    x = torch.empty_like(rhs)
    nxt = torch.zeros_like(rhs[0])
    for i in range(m - 1, -1, -1):
        torch.sub(dp[i], nxt, alpha=float(cp[i]), out=x[i])
        nxt = x[i]
    return x


def _notaknot_moments(Y):
    """Second-derivative moments of the 1-D not-a-knot cubic spline
    along axis 0 of ``Y`` (uniform spacing 1), vectorised over the
    remaining axis.

    Interior equations: M[i-1] + 4 M[i] + M[i+1] = 6 (y[i-1] - 2 y[i]
    + y[i+1]).  Not-a-knot (continuous third derivative at the second
    and penultimate data sites) eliminates to the closed forms
    M[1] = d[1], M[n-2] = d[n-2], M[0] = 2 M[1] - M[2],
    M[n-1] = 2 M[n-2] - M[n-3].
    """
    n = Y.shape[0]
    if n < 4:
        raise ValueError("need at least 4 samples per axis for a cubic "
                         "spline")
    d = Y[:-2] - 2.0 * Y[1:-1] + Y[2:]          # d[i] for i = 1..n-2
    if n == 4:
        inner = d
    else:
        inner = _thomas(torch.cat([d[:1], 6.0 * d[1:-1], d[-1:]], dim=0))
    M0 = 2.0 * inner[0] - inner[1]
    Mn = 2.0 * inner[-1] - inner[-2]
    return torch.cat([M0[None], inner, Mn[None]], dim=0)


def spline_coefficients_2d(Z, device=None):
    """Moments for tensor-product evaluation: returns (Z, Mx, My, Mxy),
    Mx the moments along axis 1 (x, columns), My along axis 0 (rows),
    Mxy both."""
    Z = float_tensor(Z, device)
    Mx = _notaknot_moments(Z.T.contiguous()).T.contiguous()
    My = _notaknot_moments(Z)
    Mxy = _notaknot_moments(Mx)
    return Z, Mx, My, Mxy


def _eval_1d(y0, y1, m0, m1, t):
    """Evaluate the moment-form cubic on a unit interval:
    f(t) = m0 (1-t)^3/6 + m1 t^3/6 + (y0 - m0/6)(1-t) + (y1 - m1/6) t."""
    u = 1.0 - t
    return (m0 * u ** 3 / 6.0 + m1 * t ** 3 / 6.0
            + (y0 - m0 / 6.0) * u + (y1 - m1 / 6.0) * t)


def spline_ev_2d(coeffs, r, c, offset=0.5, device=None):
    """Evaluate the bicubic interpolant at scattered (r, c) query
    coordinates, on the coefficients' device.  ``offset`` is the grid
    coordinate of sample 0 along both axes (pixel centres -> 0.5).
    ``device`` places numpy coefficients (CUDA by default)."""
    Z, Mx, My, Mxy = (float_tensor(A, device) for A in coeffs)
    H, W = Z.shape
    dt = Z.dtype
    # FITPACK bispev clamps out-of-domain query coordinates to the
    # boundary knots (constant extrapolation); replicate that.
    r = torch.clamp(to_device(r, Z.device, dt) - offset, 0.0, H - 1)
    c = torch.clamp(to_device(c, Z.device, dt) - offset, 0.0, W - 1)
    i = torch.clamp(torch.floor(r).to(torch.int64), 0, H - 2)
    j = torch.clamp(torch.floor(c).to(torch.int64), 0, W - 2)
    tr = r - i.to(dt)
    tc = c - j.to(dt)
    k = i * W + j

    def g(A, di, dj):
        return A.reshape(-1)[k + (di * W + dj)]

    # interpolate along columns (x) at the two bounding rows,
    # for values and for row-direction moments
    w0 = _eval_1d(g(Z, 0, 0), g(Z, 0, 1), g(Mx, 0, 0), g(Mx, 0, 1), tc)
    w1 = _eval_1d(g(Z, 1, 0), g(Z, 1, 1), g(Mx, 1, 0), g(Mx, 1, 1), tc)
    m0 = _eval_1d(g(My, 0, 0), g(My, 0, 1), g(Mxy, 0, 0), g(Mxy, 0, 1), tc)
    m1 = _eval_1d(g(My, 1, 0), g(My, 1, 1), g(Mxy, 1, 0), g(Mxy, 1, 1), tc)
    return _eval_1d(w0, w1, m0, m1, tr)


def interp_spline_2d(Z, r, c, offset=0.5, device=None):
    """One-shot construction + evaluation (RectBivariateSpline.ev
    equivalent for uniform pixel-centre grids)."""
    return spline_ev_2d(spline_coefficients_2d(Z, device), r, c,
                        offset=offset)
