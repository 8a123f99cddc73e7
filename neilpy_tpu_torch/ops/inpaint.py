"""NaN inpainting as matrix-free linear solves.

PyTorch counterpart of ``neilpy_tpu/ops/inpaint.py``, with the same
names and arguments plus ``device=`` on the public functions (numpy
input goes to CUDA unless ``device='cpu'``).  Reference:
neilpy/neilpy.py:1171-1283 — D'Errico-style inpainting via sparse least
squares over (a) a 4-neighbour "spring" graph (method 4, the one
``create_dem`` and ``smrf`` use) and (b) a second-difference operator.

Both systems have symmetric positive (semi-)definite normal equations
whose operators are local stencils, solved matrix-free by conjugate
gradients: springs with a Galerkin multigrid K-cycle as the (flexible)
preconditioner, or Jacobi below 64 cells a side; fda unpreconditioned.

The JAX package runs CG as a ``lax.while_loop`` whose stop test is a
device value.  Here the loop runs on the host: each iteration also
computes the stop test on the device, and once it holds the iterate is
frozen (``torch.where(done, old, new)`` for x, r, p, rz and the count),
so the result is the one a per-iteration test gives.  The host reads the
flag back every ``check_every`` iterations only: each read waits for the
device.  ``inpaint_nans_by_springs(return_info=True)`` reports the
iterations and those host syncs.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.device import float_tensor, to_device

__all__ = ["inpaint_nans_by_springs", "inpaint_nans_by_fda",
           "inpaint_nearest", "inpaint_nearest_device", "cg_solve",
           "springs_fill"]

# iterations between host reads of the CG stop flag: a K-cycle iteration
# is thousands of launches, so reading every time costs little; a Jacobi
# or fda iteration is a dozen, so those read every 16
CHECK_EVERY_MULTIGRID = 1
CHECK_EVERY_PLAIN = 16


def _neighbor_sum(X):
    """Sum of the in-bounds 4-neighbour values of X (zero beyond the
    edge), in the JAX package's order: up + down + left + right."""
    s = torch.zeros_like(X)
    s[:-1] += X[1:]
    s[1:] += X[:-1]
    s[:, :-1] += X[:, 1:]
    s[:, 1:] += X[:, :-1]
    return s


def _degree(shape, dtype=torch.float32, device=None):
    """Number of in-bounds 4-neighbours per cell (4 interior, 3 edge,
    2 corner)."""
    H, W = shape
    rows = torch.arange(H, device=device)[:, None]
    cols = torch.arange(W, device=device)[None, :]
    return (((rows > 0).to(dtype) + (rows < H - 1).to(dtype))
            + (cols > 0).to(dtype) + (cols < W - 1).to(dtype))


class _Tensor:
    """The vector operations ``_cg`` runs on, for one tensor.  The sharded
    fill (``dist/smrf._Layout``) gives the same five for lists of blocks:
    ``dot`` returns a 0-d tensor, ``scalar`` puts such a tensor where
    ``axpy`` and ``where`` take it."""

    @staticmethod
    def dot(a, b):
        return torch.sum(a * b)

    @staticmethod
    def scalar(s):
        return s

    @staticmethod
    def sub(a, b):
        return a - b

    @staticmethod
    def axpy(a, s, b, sign=1):
        """a + s b (a - s b for ``sign`` < 0)."""
        return a + s * b if sign > 0 else a - s * b

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)


def _cg(apply_fn, b, x0, precond, tol, maxiter, flexible, check_every,
        space=_Tensor):
    """CG with the stop test on the device (see the module docstring), on
    the vectors of ``space`` (``_Tensor``'s operations).  Returns (x,
    iterations, host syncs)."""
    V = space
    if precond is None:
        precond = lambda r: r
    bnorm = torch.sqrt(V.dot(b, b))
    atol2 = (tol * torch.clamp_min(bnorm, 1e-30)) ** 2

    x = x0
    r = V.sub(b, apply_fn(x0))
    z = precond(r)
    p = z
    rz = V.dot(r, z)
    it = torch.zeros((), dtype=torch.int64, device=bnorm.device)
    done = ~(V.dot(r, r) > atol2)  # a NaN residual stops, as in JAX
    syncs = iterations = 0
    for n in range(1, int(maxiter) + 1):
        Ap = apply_fn(p)
        alpha = V.scalar(rz / V.dot(p, Ap))
        x_new = V.axpy(x, alpha, p)
        r_new = V.axpy(r, alpha, Ap, -1)
        z = precond(r_new)
        rz_new = V.dot(r_new, z)
        if flexible:
            # Polak-Ribiere: robust to a nonlinear preconditioner
            beta = (rz_new - V.dot(r, z)) / rz
        else:
            beta = rz_new / rz
        p_new = V.axpy(z, V.scalar(beta), p)
        d = V.scalar(done)
        x = V.where(d, x, x_new)
        r = V.where(d, r, r_new)
        p = V.where(d, p, p_new)
        rz = torch.where(done, rz, rz_new)
        it = it + (~done).to(it.dtype)
        done = done | ~(V.dot(r, r) > atol2)
        if n % check_every == 0 or n == maxiter:
            # one read of the flag and the count: the only host sync
            syncs += 1
            stop, iterations = torch.stack([done.to(it.dtype), it]).tolist()
            if stop:
                break
    return x, iterations, syncs


def cg_solve(apply_fn, b, x0, precond=None, tol=1e-7, maxiter=2000,
             flexible=False):
    """Conjugate gradients with optional preconditioner.  ``apply_fn``
    must be linear, symmetric, positive definite on the masked subspace.
    ``flexible=True`` uses the Polak–Ribière beta (Notay's flexible CG),
    robust when the preconditioner is only approximately symmetric —
    e.g. a multigrid cycle.  Returns (x, iterations)."""
    b = torch.as_tensor(b)
    x, it, _ = _cg(apply_fn, b, x0, precond, tol, maxiter, flexible,
                   CHECK_EVERY_PLAIN)
    return x, it


def springs_fill(A, tol=1e-7, maxiter=4000, multiscale=True):
    """Spring-graph fill of a tensor on its own device, returning the
    filled array only (the SMRF raster stage composes it)."""
    out, _ = _springs_core(A, tol, maxiter, multiscale)
    return out


def _blocksum2(X):
    """2x2 block sum (restriction = prolongationᵀ for the piecewise-
    constant interpolation used by the multigrid cycle)."""
    X = _pad_even(X)
    H, W = X.shape
    return X.reshape(H // 2, 2, W // 2, 2).sum(dim=(1, 3))


def _prolong2(Xc, H, W):
    """Piecewise-constant 2x prolongation cropped to (H, W)."""
    h, w = Xc.shape
    return Xc[:, None, :, None].expand(h, 2, w, 2).reshape(2 * h,
                                                           2 * w)[:H, :W]


def _pad_even(X):
    H, W = X.shape
    if H % 2 == 0 and W % 2 == 0:
        return X
    return torch.nn.functional.pad(X, (0, W % 2, 0, H % 2))


def _build_levels(unknown, deg, min_size=4):
    """Exact Galerkin coarse hierarchy of the masked spring Laplacian
    under piecewise-constant transfers (aggregation multigrid).

    Each level is ``(diag, E, S, u)``: the diagonal, the coupling weight
    ``E[r, c]`` to the east neighbour ``(r, c+1)``, the coupling ``S`` to
    the south neighbour, and the unknown mask.  The fine operator is
    5-point and the transfers are 2x2 block-constant, so RAP stays
    5-point at every level: inter-block coupling = sum of the fine edge
    weights crossing the block boundary, block diagonal = sum of fine
    diagonals - 2 x (intra-block edge weights).
    """
    u = unknown
    diag = deg * u
    E = torch.zeros_like(u)
    E[:, :-1] = u[:, :-1] * u[:, 1:]
    S = torch.zeros_like(u)
    S[:-1, :] = u[:-1, :] * u[1:, :]
    levels = [(diag, E, S, u)]
    while min(u.shape) > min_size:
        level = _coarsen_level(*levels[-1])
        levels.append(level)
        u = level[3]
    return levels


def _coarsen_level(diag, E, S, u):
    """One Galerkin coarsening step ``(diag, E, S, u) -> coarse level``
    (see ``_build_levels``); odd extents are zero-padded first."""
    diag, E, S, u = map(_pad_even, (diag, E, S, u))
    H, W = diag.shape

    def blk(X):
        return X.reshape(H // 2, 2, W // 2, 2)

    # an E-edge with left endpoint at even column is intra-block;
    # at odd column it crosses into the east block (same for S/rows)
    intra_h = blk(E)[:, :, :, 0].sum(dim=1)
    E_c = blk(E)[:, :, :, 1].sum(dim=1)
    intra_v = blk(S)[:, 0, :, :].sum(dim=2)
    S_c = blk(S)[:, 1, :, :].sum(dim=2)
    diag_c = blk(diag).sum(dim=(1, 3)) - 2.0 * (intra_h + intra_v)
    u_c = (blk(u).sum(dim=(1, 3)) > 0).to(u.dtype)
    return diag_c, E_c, S_c, u_c


def _apply_level(x, diag, E, S):
    """Apply the 5-point coefficient-array operator of one level:
    diag*x - E*x_east - E_west*x_west - S*x_south - S_north*x_north."""
    out = diag * x
    out[:, :-1] -= E[:, :-1] * x[:, 1:]
    out[:, 1:] -= E[:, :-1] * x[:, :-1]
    out[:-1] -= S[:-1] * x[1:]
    out[1:] -= S[:-1] * x[:-1]
    return out


def _coarse_cg(r, level, iters=24):
    """Fixed-iteration CG solve of the coarsest level (a few hundred
    unknowns at most), with guards so a zero residual stays zero."""
    diag, E, S, u = level

    def A(x):
        return _apply_level(x * u, diag, E, S) * u

    x = torch.zeros_like(r)
    rr, p = r, r
    rz = torch.sum(r * r)
    for _ in range(iters):
        Ap = A(p)
        pAp = torch.sum(p * Ap)
        pos = pAp > 0
        alpha = torch.where(pos, rz / torch.where(pos, pAp, 1.0), 0.0)
        x = x + alpha * p
        rn = rr - alpha * Ap
        rzn = torch.sum(rn * rn)
        pos = rz > 0
        beta = torch.where(pos, rzn / torch.where(pos, rz, 1.0), 0.0)
        rr, p, rz = rn, rn + beta * p, rzn
    return x


def _safe_div(num, den):
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, 1.0), 0.0)


def _kcycle(r, levels, l, omega=0.9, nsmooth=2, kdepth=2,
            coarse_iters=24):
    """One multigrid K-cycle on the Galerkin hierarchy, the flexible-CG
    preconditioner.

    Damped-Jacobi (ω=0.9) pre/post smoothing; at the first ``kdepth``
    level transitions the coarse problem is solved with two steps of
    flexible CG preconditioned by the next level's cycle (Notay's
    K-cycle) instead of one recursive call; below that depth, plain
    V-recursion.
    """
    if l + 1 == len(levels):
        return _coarse_cg(r, levels[l], iters=coarse_iters)

    diag, E, S, u = levels[l]
    H, W = u.shape
    invD = torch.where(diag > 0, omega / diag, 0.0) * u

    def A(x):
        return _apply_level(x * u, diag, E, S) * u

    def smooth(x):
        for _ in range(nsmooth):
            x = x + invD * (r - A(x))
        return x

    x = smooth(torch.zeros_like(r))
    rc = _blocksum2(r - A(x)) * levels[l + 1][3]

    if kdepth > 0 and l + 2 < len(levels):
        dc, Ec, Sc, uc = levels[l + 1]

        def Ac(xx):
            return _apply_level(xx * uc, dc, Ec, Sc) * uc

        xc = torch.zeros_like(rc)
        rr = rc
        z = _kcycle(rr, levels, l + 1, omega, nsmooth, kdepth - 1,
                    coarse_iters)
        p = z
        rz = torch.sum(rr * z)
        for _ in range(2):
            Ap = Ac(p)
            alpha = _safe_div(rz, torch.sum(p * Ap))
            xc = xc + alpha * p
            r_new = rr - alpha * Ap
            z_new = _kcycle(r_new, levels, l + 1, omega, nsmooth,
                            kdepth - 1, coarse_iters)
            rz_new = torch.sum(r_new * z_new)
            beta = _safe_div(rz_new - torch.sum(rr * z_new), rz)
            p = z_new + beta * p
            rr, z, rz = r_new, z_new, rz_new
    else:
        xc = _kcycle(rc, levels, l + 1, omega, nsmooth, 0, coarse_iters)

    return smooth(x + _prolong2(xc, H, W) * u)


def _springs_core(A, tol, maxiter, multiscale=True):
    """Spring-graph fill of a float tensor on its own device.  Returns
    (filled, {"iterations", "host_syncs"})."""
    A = float_tensor(A)
    nanmask = torch.isnan(A)
    unknown = nanmask.to(A.dtype)
    known_vals = torch.where(nanmask, 0.0, A)
    known_mask = 1.0 - unknown

    deg = _degree(A.shape, dtype=A.dtype, device=A.device)

    def apply_fn(x):
        # x lives on the unknown cells (zero elsewhere)
        x = x * unknown
        return (deg * x - _neighbor_sum(x)) * unknown

    b = _neighbor_sum(known_vals * known_mask) * unknown

    # warm start: mean of known values (flat sheet)
    mean = torch.nansum(known_vals) / torch.clamp_min(torch.sum(known_mask),
                                                      1.0)
    x0 = unknown * mean

    H, W = A.shape
    if multiscale and min(H, W) >= 64:
        # multigrid-preconditioned flexible CG: iteration counts stay
        # ~O(10) whatever the diameter of the NaN regions
        levels = _build_levels(unknown, deg)
        x, it, syncs = _cg(apply_fn, b, x0, lambda r: _kcycle(r, levels, 0),
                           tol, maxiter, True, CHECK_EVERY_MULTIGRID)
    else:
        inv_deg = torch.where(deg > 0, 1.0 / deg, 0.0)
        x, it, syncs = _cg(apply_fn, b, x0, lambda r: r * inv_deg * unknown,
                           tol, maxiter, False, CHECK_EVERY_PLAIN)
    return torch.where(nanmask, x, A), {"iterations": it,
                                        "host_syncs": syncs}


def _warn_exhausted(it, maxiter, tol):
    if int(it) >= int(maxiter):
        warnings.warn(
            f"inpaint_nans_by_springs: CG exhausted maxiter={maxiter} "
            f"without reaching tol={tol}; result is the best iterate. "
            "Raise maxiter or loosen tol.", RuntimeWarning)


def inpaint_nans_by_springs(A, inplace=False, neighbors=4, tol=1e-7,
                            maxiter=4000, multiscale=True,
                            return_info=False, device=None):
    """Spring-graph inpainting (parity: neilpy.py:1227-1271).

    Matrix-free CG on the spring normal equations; equilibrium matches
    the reference's lsqr solution to solver tolerance.  ``multiscale``
    preconditions the (flexible) CG solve with a Galerkin multigrid
    K-cycle (same equilibrium, ~O(10) iterations regardless of the
    NaN-region diameter).  float32 and float64 input keep their dtype.
    ``return_info=True`` additionally returns ``{"iterations",
    "converged", "maxiter", "host_syncs"}``; a solve that exhausts
    ``maxiter`` warns either way, after the solve.
    """
    if neighbors != 4:
        raise ValueError("At the moment, only 4 neighbors are supported.")
    del inplace  # functional API: always returns the filled array
    out, info = _springs_core(float_tensor(A, device), tol, maxiter,
                              multiscale)
    it = info["iterations"]
    _warn_exhausted(it, maxiter, tol)
    if return_info:
        return out, {"iterations": it, "converged": it < maxiter,
                     "maxiter": maxiter, "host_syncs": info["host_syncs"]}
    return out


def _second_diff_apply(x, unknown):
    """Apply D^T D where D stacks all interior row/column second
    differences (the fda operator, neilpy.py:1180-1194), restricted to
    the unknown cells."""
    return _second_diff_normal(x * unknown) * unknown


def _second_diff_normal(x):
    """D^T D x for the stacked row/column second differences."""
    tv = x[:-2, :] - 2.0 * x[1:-1, :] + x[2:, :]
    yv = torch.zeros_like(x)
    yv[:-2, :] += tv
    yv[1:-1, :] += -2.0 * tv
    yv[2:, :] += tv
    th = x[:, :-2] - 2.0 * x[:, 1:-1] + x[:, 2:]
    yh = torch.zeros_like(x)
    yh[:, :-2] += th
    yh[:, 1:-1] += -2.0 * th
    yh[:, 2:] += th
    return yv + yh


def inpaint_nans_by_fda(A, fast=True, inplace=False, tol=1e-7,
                        maxiter=8000, device=None):
    """Second-difference (biharmonic-flavoured) inpainting (parity:
    neilpy.py:1171-1216), float32.  ``fast`` is accepted for API
    parity; the matrix-free formulation already drops constant rows,
    which is what fast=True's row restriction achieves."""
    del fast, inplace
    A = to_device(A, device, torch.float32)
    nanmask = torch.isnan(A)
    unknown = nanmask.to(torch.float32)
    known_vals = torch.where(nanmask, 0.0, A)

    # b = -D^T D applied to the known values, restricted to unknowns
    b = -_second_diff_normal(known_vals) * unknown
    mean = torch.nansum(known_vals) / torch.clamp_min(
        torch.sum(1.0 - unknown), 1.0)
    x, _, _ = _cg(lambda x: _second_diff_apply(x, unknown), b,
                  unknown * mean, None, tol, maxiter, False,
                  CHECK_EVERY_PLAIN)
    return torch.where(nanmask, x, A)


def inpaint_nearest(X):
    """Nearest-finite-value fill (parity: neilpy.py:1277-1283).

    Host path via scipy's KD-tree interpolator — exact Euclidean
    nearest with the reference's index-order tie-breaking; returns a
    float64 numpy array.  For device-resident pipelines use
    ``inpaint_nearest_device`` (a jump-flooding fill).
    """
    if isinstance(X, torch.Tensor):
        X = X.cpu().numpy()
    X = np.asarray(X, dtype=np.float64)
    from scipy import interpolate
    idx = np.isfinite(X)
    RI, CI = np.meshgrid(np.arange(X.shape[0]), np.arange(X.shape[1]))
    f_near = interpolate.NearestNDInterpolator(
        (RI.T[idx], CI.T[idx]), X[idx])
    miss = ~idx
    X[miss] = f_near(RI.T[miss], CI.T[miss])
    return X


def inpaint_nearest_device(X, device=None):
    """Nearest-finite-value fill as a jump-flooding pass on the device
    (float32).

    Each cell carries (seed row, seed col, seed value); rounds of
    8-neighbour propagation at power-of-two offsets (N/2, N/4, ..., 1)
    keep the closest seed by squared Euclidean distance.  JFA can
    differ from the exact KD-tree fill on tie/near-tie cells (both are
    *a* nearest finite value).
    """
    X = to_device(X, device, torch.float32)
    H, W = X.shape
    finite = torch.isfinite(X)
    rows = torch.arange(H, device=X.device, dtype=torch.int32)[:, None]
    cols = torch.arange(W, device=X.device, dtype=torch.int32)[None, :]
    rows, cols = rows.expand(H, W), cols.expand(H, W)
    BIG = 2 ** 30
    r0 = torch.where(finite, rows, BIG)
    c0 = torch.where(finite, cols, BIG)
    v0 = torch.where(finite, X, 0.0)

    def shift(a, dy, dx, fill):
        inb = ((rows + dy >= 0) & (rows + dy < H)
               & (cols + dx >= 0) & (cols + dx < W))
        return torch.roll(torch.where(inb, a, fill), (dy, dx), (0, 1))

    def d2(r, c):
        dr = (r - rows).to(torch.float32)
        dc = (c - cols).to(torch.float32)
        return dr * dr + dc * dc

    step = 1 << max(int(np.ceil(np.log2(max(H, W, 2)))) - 1, 0)
    while step >= 1:
        best_d = d2(r0, c0)
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                rn = shift(r0, dy, dx, BIG)
                cn = shift(c0, dy, dx, BIG)
                vn = shift(v0, dy, dx, 0.0)
                dn = d2(rn, cn)
                take = dn < best_d
                r0 = torch.where(take, rn, r0)
                c0 = torch.where(take, cn, c0)
                v0 = torch.where(take, vn, v0)
                best_d = torch.where(take, dn, best_d)
        step //= 2
    return torch.where(finite, X, v0)
