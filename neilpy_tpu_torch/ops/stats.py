"""Raster spatial statistics and accuracy metrics.

PyTorch counterpart of ``neilpy_tpu/ops/stats.py``, with the same names
and arguments plus ``device=`` last on the device functions
(``rasterGi``, ``morans_i``, ``local_morans_i``, ``rmse``,
``shi_landslides``; numpy input goes to CUDA unless ``device='cpu'``).
Their neighbourhood counts and sums are footprint sums
(``surface.binary_footprint_sum``: generic_filter semantics, a boolean
mask, no kernel flip), in float32 as in the JAX package; the normal tail
is ``torch.special.erfc``.  Whole-map reductions are torch sums on the
device, so at ~10^7 values their last bits differ from XLA's, and a
significance bin may flip only where P lies at a bin edge.

The point-set and accuracy functions (``gi_formula``,
``gistar_formula``, ``score``, ``bdr``, ``chamfer_distance``,
``hungarian_algorithm``, ``bdr_bootstrap``) are host numpy and scipy,
as in the JAX package, without sklearn: ``score`` computes Cohen's
kappa, the confusion matrix, binary F1 and accuracy by sklearn's
formulas, and ``chamfer_distance`` queries ``scipy.spatial.cKDTree``.

Parity targets (reference neilpy/neilpy.py): gi_formula/gistar_formula
285-294, rasterGi 330-421, rmse 1918-1919, score 2515-2537,
shi_landslides 2544-2553, bdr 2642-2675, chamfer_distance 2679-2718,
hungarian_algorithm 2724-2731, bdr_bootstrap 2735-2745.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.codes import disk
from .surface import binary_footprint_sum, evans_curvature
from .visibility import as_raster

__all__ = ["gi_formula", "gistar_formula", "rasterGi", "morans_i",
           "local_morans_i", "rmse", "score", "shi_landslides", "bdr",
           "chamfer_distance", "hungarian_algorithm", "bdr_bootstrap"]


def gi_formula(x, n, m, v):
    """Scalar Getis-Ord Gi (parity: neilpy.py:285-289)."""
    x = np.asarray(x, dtype=float)
    k = int(np.sum(np.isfinite(x)))
    return (np.nansum(x) - k * m) / np.sqrt((k * (n - 1 - k) * v) / (n - 2))


def gistar_formula(x, n, m, v):
    """Scalar Getis-Ord Gi* (parity: neilpy.py:291-294)."""
    x = np.asarray(x, dtype=float)
    k = int(np.sum(np.isfinite(x)))
    return (np.nansum(x) - k * m) / np.sqrt((k * (n - k) * v) / (n - 1))


def _norm_sf(z):
    """Standard normal survival function via erfc."""
    return 0.5 * torch.special.erfc(z / math.sqrt(2.0))


def _nanmean(X):
    """``jnp.nanmean``: the sum of the non-NaN values over their count."""
    keep = ~torch.isnan(X)
    return torch.where(keep, X, 0.0).sum() / keep.sum().to(X.dtype)


def _nanstd(X):
    """``jnp.nanstd`` with ddof 0: the square root of the mean squared
    deviation of the non-NaN values from their mean."""
    nan = torch.isnan(X)
    centered = torch.where(nan, 0.0, X - _nanmean(X))
    n = (~nan).sum()
    var = (centered * centered).sum() / n.clamp(min=1).to(X.dtype)
    return torch.sqrt(torch.where(n > 0, var, torch.nan))


def significance_bins(Z, P, finite):
    """ArcGIS-style bins {0, ±1, ±2, ±3} of z-scores ``Z`` with two-tailed
    p-values ``P`` (neilpy.py:405-419); NaN off ``finite``."""
    sig = torch.zeros_like(Z)
    sig = torch.where(P < .1, 1.0, sig)
    sig = torch.where(P < .05, 2.0, sig)
    sig = torch.where(P < .01, 3.0, sig)
    sig = torch.where(Z < 0, -sig, sig)
    sig = torch.where(P >= .1, 0.0, sig)
    return torch.where(finite, sig, torch.nan)


def rasterGi(X, footprint=1, mode="nearest", apply_correction=False,
             star=False, global_mean=None, global_var=None,
             global_n=None, device=None):
    """Raster Getis-Ord Gi / Gi* hotspot statistics (parity:
    neilpy.py:330-421).

    Returns (Z, P, sig_bin): z-scores, two-tailed p-values and the
    ArcGIS-style significance bins {0, ±1, ±2, ±3}.  An explicit
    ``footprint`` array is a boolean MASK (``fp != 0``, generic_filter
    semantics: weights are not applied), and its centre cell decides
    ``star``.  ``global_mean``/``global_var``/``global_n`` override the
    whole-map moments and finite-cell count (star path only), so a mosaic
    processed tile-wise z-scores against the global statistics."""
    X = as_raster(X, device)

    if np.isscalar(footprint):
        m = int(footprint)
        size = 2 * m + 1
        fp = np.ones((size, size), dtype=np.float32)
        if not star:
            fp[m, m] = 0
    else:
        fp = np.asarray(footprint).astype(np.float32)
        star = bool(fp[fp.shape[0] // 2, fp.shape[1] // 2] != 0)

    finite = torch.isfinite(X)
    nf = finite.sum().to(torch.float32)
    if star and global_n is not None:
        nf = torch.tensor(global_n, dtype=torch.float32, device=X.device)

    if not star:
        gm = (torch.nansum(X) - X) / (nf - 1)
        gv = ((torch.nansum(X ** 2) - X ** 2) / (nf - 1)) - gm ** 2
        gm = torch.where(finite, gm, torch.nan)
        gv = torch.where(finite, gv, torch.nan)
    else:
        gm = (_nanmean(X) if global_mean is None else
              torch.tensor(global_mean, dtype=torch.float32, device=X.device))
        gv = (_nanstd(X) ** 2 if global_var is None else
              torch.tensor(global_var, dtype=torch.float32, device=X.device))

    fp = fp != 0
    w_neighbors = binary_footprint_sum(finite.to(torch.float32), fp,
                                       mode=mode)
    w_neighbors = torch.round(w_neighbors)
    w_neighbors = torch.where(finite, w_neighbors, torch.nan)

    nansum_w = binary_footprint_sum(torch.where(finite, X, 0.0), fp,
                                    mode=mode)
    a = nansum_w - w_neighbors * gm
    if star:
        b = torch.sqrt((w_neighbors / (nf - 1)) * (nf - w_neighbors) * gv)
    else:
        b = torch.sqrt((w_neighbors / (nf - 2)) * (nf - 1 - w_neighbors)
                       * gv)
    Z = a / b
    Z = torch.where(finite, Z, torch.nan)

    if apply_correction:
        Z = (Z - _nanmean(Z)) / _nanstd(Z)

    P = 2.0 * _norm_sf(torch.abs(Z))
    return Z, P, significance_bins(Z, P, finite)


def _lag_footprint(footprint, drop_centre):
    """The binary weight matrix of Moran's I: a scalar m is the
    (2m+1)^2 box without its centre; an array is taken as a mask, its
    centre dropped when ``drop_centre``."""
    if np.isscalar(footprint):
        m = int(footprint)
        fp = np.ones((2 * m + 1, 2 * m + 1), dtype=np.float32)
        fp[m, m] = 0
    else:
        fp = np.asarray(footprint).astype(np.float32)
        if drop_centre:
            fp = fp.copy()
            fp[fp.shape[0] // 2, fp.shape[0] // 2] = 0
    return fp != 0


def morans_i(X, footprint=1, mode="nearest", device=None):
    """Global Moran's I with a binary footprint weight matrix
    (row-unstandardised), from the same counted footprint sums as
    rasterGi.  Returns (I, E_I, z_score) under the normality
    assumption, as 0-d tensors."""
    X = as_raster(X, device)
    fp = _lag_footprint(footprint, drop_centre=True)

    finite = torch.isfinite(X)
    nf = finite.sum().to(torch.float32)
    xbar = _nanmean(X)
    zdev = torch.where(finite, X - xbar, 0.0)

    lag = binary_footprint_sum(zdev, fp, mode=mode)
    num = torch.sum(zdev * lag)
    den = torch.sum(zdev ** 2)
    # W = total weight: pairs of finite cells within the footprint
    wsum_map = binary_footprint_sum(finite.to(torch.float32), fp, mode=mode)
    W = torch.sum(torch.where(finite, wsum_map, 0.0))
    I = (nf / W) * (num / den)
    E_I = -1.0 / (nf - 1)
    # normality-assumption variance (Cliff & Ord)
    S0 = W
    S1 = 2.0 * W  # binary symmetric: (1/2) sum (w_ij + w_ji)^2 = 2 W
    S2 = torch.sum(torch.where(finite, (2.0 * wsum_map) ** 2, 0.0))
    var_I = ((nf ** 2 * S1 - nf * S2 + 3.0 * S0 ** 2)
             / ((nf ** 2 - 1.0) * S0 ** 2)) - E_I ** 2
    z = (I - E_I) / torch.sqrt(var_I)
    return I, E_I, z


def local_morans_i(X, footprint=1, mode="nearest", mean=None, s2=None,
                   device=None):
    """Local Moran's I (Anselin LISA) per cell with binary weights.

    ``mean``/``s2`` override the global moments, so a mosaic processed
    tile-wise z-scores each tile against the global statistics."""
    X = as_raster(X, device)
    fp = _lag_footprint(footprint, drop_centre=False)
    finite = torch.isfinite(X)
    nf = finite.sum().to(torch.float32)
    xbar = (_nanmean(X) if mean is None else
            torch.tensor(mean, dtype=torch.float32, device=X.device))
    zdev = torch.where(finite, X - xbar, 0.0)
    if s2 is None:
        s2 = torch.sum(zdev ** 2) / nf
    else:
        s2 = torch.tensor(s2, dtype=torch.float32, device=X.device)
    lag = binary_footprint_sum(zdev, fp, mode=mode)
    I = (zdev / s2) * lag
    return torch.where(finite, I, torch.nan)


def rmse(X, device=None):
    """sqrt(nansum(X^2)/N) (parity: neilpy.py:1918-1919)."""
    X = as_raster(X, device)
    return torch.sqrt(torch.nansum(X ** 2) / X.numel())


def _labels(A, B):
    """The sorted labels of two label vectors, refusing continuous ones
    as sklearn's ``type_of_target`` does."""
    labels = np.union1d(A, B)
    if labels.dtype.kind == "f" and not np.all(labels == np.round(labels)):
        raise ValueError("Classification metrics can't handle continuous "
                         "targets")
    return labels


def _confusion_matrix(A, B, labels):
    """sklearn's ``confusion_matrix``: rows true labels, columns
    predicted, int64."""
    n = labels.size
    ti = np.searchsorted(labels, A)
    pi = np.searchsorted(labels, B)
    return np.bincount(ti * n + pi, minlength=n * n).reshape(n, n)


def _cohen_kappa(confusion):
    """sklearn's ``cohen_kappa_score`` (unweighted) from the confusion
    matrix, in its order of operations."""
    n_classes = confusion.shape[0]
    sum0 = np.sum(confusion, axis=0)
    sum1 = np.sum(confusion, axis=1)
    expected = np.outer(sum0, sum1) / np.sum(sum0)
    w_mat = np.ones([n_classes, n_classes], dtype=int)
    w_mat.flat[::n_classes + 1] = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        k = np.sum(w_mat * confusion) / np.sum(w_mat * expected)
    return float(1 - k)  # NaN with a single label, as sklearn


def _f1_binary(A, B, labels):
    """sklearn's ``f1_score`` with its default ``average='binary'``,
    ``pos_label=1``: 2 tp / (2 tp + fp + fn), 0.0 where that is 0/0;
    raises on more than two labels, or on two without the label 1."""
    if labels.size > 2:
        raise ValueError("Target is multiclass but average='binary'. Please "
                         "choose another average setting, one of [None, "
                         "'micro', 'macro', 'weighted'].")
    if 1 not in labels and labels.size >= 2:
        raise ValueError(f"pos_label=1 is not a valid label. It should be "
                         f"one of {list(labels)}")
    tp = np.sum((A == 1) & (B == 1))
    denom = np.sum(A == 1) + np.sum(B == 1)
    return float(2 * tp / denom) if denom else 0.0


def score(A, B, k=100000, mask=None, seed=None):
    """Sampled classification metrics: Cohen's kappa, confusion matrix,
    F1, accuracy (parity: neilpy.py:2515-2537), by sklearn's formulas."""
    A = np.asarray(A)
    B = np.asarray(B)
    if mask is None:
        A, B = A.flatten(), B.flatten()
    else:
        A, B = A[mask].flatten(), B[mask].flatten()
    if k > len(A):
        k = len(A)
    rng = np.random.default_rng(seed)
    s = rng.choice(len(A), k, replace=True)
    a, b = A[s], B[s]
    labels = _labels(a, b)
    confusion = _confusion_matrix(a, b, labels)
    return {"cohen_kappa_score": _cohen_kappa(confusion),
            "confusion_matrix": confusion,
            "f1_score": _f1_binary(a, b, labels),
            "accuracy_score": float(np.average(a == b))}


def shi_landslides(dem, radii, cellsize=1, device=None):
    """Landslide candidate map: Gi* of tangential curvature over several
    disk radii (parity: neilpy.py:2544-2553); each radius one footprint
    Gi* on the device."""
    k, kprof, kplan, ktan, klong, kcross = evans_curvature(dem, cellsize,
                                                           device=device)
    sig_bins = []
    for radius in radii:
        _, _, sig = rasterGi(ktan, disk(radius), star=True)
        sig_bins.append(sig)
    return torch.any(torch.stack(sig_bins) < -2, dim=0)


# ----------------------------------------------------------------------
# Point-set comparison / regression metrics (host-side analytics)
# ----------------------------------------------------------------------
def bdr(XY, AB):
    """Euclidean bidimensional regression, Friedman & Kohler 2003
    (parity: neilpy.py:2642-2675)."""
    from scipy import stats as sstats
    XY = np.asarray(XY, dtype=float)
    AB = np.asarray(AB, dtype=float)
    X, Y = XY[:, 0], XY[:, 1]
    A, B = AB[:, 0], AB[:, 1]

    def ssq(v):
        return np.sum((v - np.mean(v)) ** 2)

    denom = ssq(X) + ssq(Y)
    beta1 = (np.sum((X - X.mean()) * (A - A.mean()))
             + np.sum((Y - Y.mean()) * (B - B.mean()))) / denom
    beta2 = (np.sum((X - X.mean()) * (B - B.mean()))
             - np.sum((Y - Y.mean()) * (A - A.mean()))) / denom
    scale = np.hypot(beta1, beta2)
    theta = np.rad2deg(np.arctan2(beta2, beta1))
    alpha1 = A.mean() - beta1 * X.mean() + beta2 * Y.mean()
    alpha2 = B.mean() - beta2 * X.mean() - beta1 * Y.mean()
    aPrime = alpha1 + beta1 * X - beta2 * Y
    bPrime = alpha2 + beta2 * X + beta1 * Y
    resid = np.sum((A - aPrime) ** 2 + (B - bPrime) ** 2)
    rsquare = 1 - resid / (ssq(A) + ssq(B))
    D = np.sqrt(resid)
    Dmax = np.sqrt(ssq(A) + ssq(B))
    DI = np.sqrt(max(1 - rsquare, 0.0))
    # Nakaya F; a perfect fit (rsquare == 1) gives F = inf, P = 0
    with np.errstate(divide="ignore"):
        F = ((2 * len(A) - 4) / 2) * np.divide(rsquare, 1 - rsquare)
    P = 1 - sstats.f.cdf(F, 2, 2 * len(A) - 4)
    return {"beta1": beta1, "beta2": beta2, "alpha1": alpha1,
            "alpha2": alpha2, "scale": scale, "theta": theta,
            "aPrime": aPrime, "bPrime": bPrime, "rsquare": rsquare,
            "D": D, "Dmax": Dmax, "DI": DI, "F": F, "P": P}


# sklearn's kd_tree metric names as Minkowski orders
_MINKOWSKI_P = {"euclidean": 2, "l2": 2, "minkowski": 2, "manhattan": 1,
                "cityblock": 1, "l1": 1, "chebyshev": np.inf,
                "infinity": np.inf}


def chamfer_distance(x, y, metric="l2", direction="bi"):
    """Chamfer distance between point clouds (parity:
    neilpy.py:2679-2718): the mean nearest-neighbour distance, by
    ``scipy.spatial.cKDTree``; ``metric`` is one of sklearn's kd_tree
    names for a Minkowski order (2, 1 or infinity)."""
    from scipy.spatial import cKDTree
    if metric not in _MINKOWSKI_P:
        raise ValueError(f"metric {metric!r} is not supported; use one of "
                         f"{sorted(_MINKOWSKI_P)}")
    p = _MINKOWSKI_P[metric]

    def one_way(src, dst):
        d, _ = cKDTree(np.asarray(dst, dtype=float)).query(
            np.asarray(src, dtype=float), k=1, p=p)
        return float(np.mean(d))

    if direction == "y_to_x":
        return one_way(y, x)
    if direction == "x_to_y":
        return one_way(x, y)
    if direction == "bi":
        return one_way(y, x) + one_way(x, y)
    raise ValueError("Invalid direction type. Supported types: "
                     "'y_to_x', 'x_to_y', 'bi'")


def hungarian_algorithm(XY, AB):
    """Optimal assignment between point sets (parity:
    neilpy.py:2724-2731)."""
    from scipy.optimize import linear_sum_assignment
    from scipy.spatial.distance import cdist
    cost = cdist(XY, AB)
    rows, cols = linear_sum_assignment(cost)
    return rows, cols, cost[rows, cols]


def bdr_bootstrap(XY, AB, k=10000, seed=None):
    """Bootstrap r^2/DI under random correspondence + Hungarian
    matching (parity: neilpy.py:2735-2745)."""
    rng = np.random.default_rng(seed)
    rsq = np.zeros(k)
    DI = np.zeros(k)
    XY = np.asarray(XY)
    AB = np.asarray(AB)
    for i in range(k):
        idx = rng.choice(len(AB), len(XY), replace=False)
        ABs = AB[idx, :]
        _, col, _ = hungarian_algorithm(XY, ABs)
        res = bdr(XY, ABs[col, :])
        rsq[i] = res["rsquare"]
        DI[i] = res["DI"]
    return rsq, DI
