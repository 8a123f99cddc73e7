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
iterations and those host syncs; while a ``torch.profiler`` profile is
open each springs fill is the span ``inpaint.springs`` with the same two
counts, how the fill ran (``graph``), its graph replays and where its
K-cycle ran (``kcycle``) as its ``attr``.

A multigrid iteration is thousands of small kernels, which on a CUDA
device the host issues more slowly than the card runs them.  There the
springs fill runs its CG as two CUDA graphs per grid shape, captured at
the shape's first fill and replayed by every later one (``_GRAPHS``):
the same kernels in the same order, so the same bits as the eager loop,
with one graph launch and one flag read an iteration.  The K-cycle itself
runs there as the hand-written kernels of ``csrc/multigrid_kcycle.cu``
(``_kcycle_cuda``), about a hundred launches in place of the plain
version's ~14,700 torch ops (``_kcycle_torch``, which CPU tensors run).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
import warnings

import numpy as np
import torch

from .. import _build, profiling
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


def _atol2(b, tol, space=_Tensor):
    """The CG's squared stop tolerance for the right-hand side ``b``."""
    bnorm = torch.sqrt(space.dot(b, b))
    return (tol * torch.clamp_min(bnorm, 1e-30)) ** 2


def _cg_start(apply_fn, b, x0, precond, atol2, space=_Tensor):
    """The CG state before the first iteration: (x, r, p, rz, it, done)."""
    V = space
    r = V.sub(b, apply_fn(x0))
    z = precond(r)
    rz = V.dot(r, z)
    it = torch.zeros((), dtype=torch.int64, device=atol2.device)
    done = ~(V.dot(r, r) > atol2)  # a NaN residual stops, as in JAX
    return x0, r, z, rz, it, done


def _cg_step(state, apply_fn, precond, atol2, flexible, space=_Tensor):
    """One CG iteration: the state (x, r, p, rz, it, done) after it, the
    one before in value once ``done`` holds.  Every iteration of every CG
    here runs this body: eagerly in ``_cg``, or captured in a CUDA graph
    (``_SpringsGraphs``)."""
    V = space
    x, r, p, rz, it, done = state
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
    return x, r, p, rz, it, done


def _flag(state):
    """The stop flag and the iteration count of a CG state, stacked: what
    the host reads."""
    it, done = state[4], state[5]
    return torch.stack([done.to(it.dtype), it])


def _cg(apply_fn, b, x0, precond, tol, maxiter, flexible, check_every,
        space=_Tensor):
    """CG with the stop test on the device (see the module docstring), on
    the vectors of ``space`` (``_Tensor``'s operations).  Returns (x,
    iterations, host syncs)."""
    V = space
    if precond is None:
        precond = lambda r: r
    atol2 = _atol2(b, tol, V)
    state = _cg_start(apply_fn, b, x0, precond, atol2, V)

    def step():
        nonlocal state
        state = _cg_step(state, apply_fn, precond, atol2, flexible, V)

    iterations, syncs, _ = _iterate(step, lambda: _flag(state), maxiter,
                                    check_every)
    return state[0], iterations, syncs


def _iterate(step, flag, maxiter, check_every):
    """The CG's host schedule: ``step()`` up to ``maxiter`` times and,
    every ``check_every`` iterations and after the last, one read of
    ``flag()`` (the stop flag and the count): the only host sync.
    Returns (iterations, host syncs, steps run)."""
    syncs = iterations = n = 0
    for n in range(1, int(maxiter) + 1):
        step()
        if n % check_every == 0 or n == maxiter:
            syncs += 1
            stop, iterations = flag().tolist()
            if stop:
                break
    return iterations, syncs, n


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
            coarse_iters=24, ran=None):
    """One multigrid K-cycle on the Galerkin hierarchy from level ``l``,
    the flexible-CG preconditioner: the kernels (:func:`_kcycle_cuda`) for
    a CUDA tensor, the plain version (:func:`_kcycle_torch`) for any
    other.  The version that ran, "cuda" or "torch", is added to the set
    ``ran`` where one is given."""
    if r.is_cuda:
        z, how = _kcycle_cuda(r, levels[l:], omega, nsmooth, kdepth,
                              coarse_iters), "cuda"
    else:
        z, how = _kcycle_torch(r, levels, l, omega, nsmooth, kdepth,
                               coarse_iters), "torch"
    if ran is not None:
        ran.add(how)
    return z


def _kcycle_torch(r, levels, l, omega=0.9, nsmooth=2, kdepth=2,
                  coarse_iters=24):
    """The plain version of the K-cycle, in torch ops on any device.

    Damped-Jacobi (ω=0.9) pre/post smoothing; at the first ``kdepth``
    level transitions the coarse problem is solved with two steps of
    flexible CG preconditioned by the next level's cycle (Notay's
    K-cycle) instead of one recursive call; below that depth, plain
    V-recursion.  The second step ends at its update of the coarse
    correction: its residual, cycle and direction would go unused.
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
        z = _kcycle_torch(rr, levels, l + 1, omega, nsmooth, kdepth - 1,
                          coarse_iters)
        p = z
        rz = torch.sum(rr * z)
        for step in range(2):
            Ap = Ac(p)
            alpha = _safe_div(rz, torch.sum(p * Ap))
            xc = xc + alpha * p
            if step == 1:
                break
            r_new = rr - alpha * Ap
            z_new = _kcycle_torch(r_new, levels, l + 1, omega, nsmooth,
                                  kdepth - 1, coarse_iters)
            rz_new = torch.sum(r_new * z_new)
            beta = _safe_div(rz_new - torch.sum(rr * z_new), rz)
            p = z_new + beta * p
            rr, z, rz = r_new, z_new, rz_new
    else:
        xc = _kcycle_torch(rc, levels, l + 1, omega, nsmooth, 0,
                           coarse_iters)

    return smooth(x + _prolong2(xc, H, W) * u)


# the levels the kernels take (csrc/multigrid_kcycle.cu: kMaxLevels)
_MAX_LEVELS = 40


@functools.lru_cache(maxsize=None)
def _smem_optin(device):
    """Shared memory one block may opt into on ``device`` (232,448 bytes
    on an H100), as ``csrc/multigrid_kcycle.cu:launch_tail`` opts in."""
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def _kcycle_plan(shapes, itemsize, kdepth, smem_max):
    """Where the K-cycle kernels' one-block tail starts: the first level,
    at or below the flexible-CG levels (the tail runs plain V-recursion),
    whose working set and every coarser level's fit in ``smem_max`` bytes
    of a block's shared memory: eight arrays a level and the coarse CG's
    A(p) (``csrc/multigrid_kcycle.cu:tail_elems``).  Returns (level,
    bytes); bytes 0 where not even the coarsest level fits, and the tail
    works in global memory."""
    n = [h * w for h, w in shapes]
    L = len(n)
    for t in range(max(0, min(kdepth, L - 2)), L):
        nbytes = (8 * sum(n[t:]) + n[-1]) * itemsize
        if nbytes <= smem_max:
            return t, nbytes
    return L - 1, 0


def _kcycle_cuda(r, levels, omega=0.9, nsmooth=2, kdepth=2,
                 coarse_iters=24):
    """:func:`_kcycle_torch` from level 0 of ``levels`` as the hand-written
    kernels of ``csrc/multigrid_kcycle.cu``: one C call issues the
    recursion's launches (85 at SMRF's 2001^2 float32 hierarchy) on the
    current stream, with scratch from ``torch.empty`` (the graph's pool
    under capture), and does not synchronise.  ``r`` and every level
    tensor must be contiguous float32 or float64 CUDA tensors of one dtype
    and device, each level the 2x2 coarsening of the one above; anything
    else raises.  It equals the plain version to rounding: its dot
    products sum in another order.  ``_kcycle_cuda.launches`` counts the
    applications of this process; the first is the span
    ``first_use.launch``."""
    if r.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"_kcycle_cuda takes float32 or float64, not "
                         f"{r.dtype}")
    if any(t.dtype != r.dtype or t.device != r.device
           or not t.is_contiguous() for lv in ([r], *levels) for t in lv):
        raise ValueError("_kcycle_cuda needs contiguous tensors of one "
                         "dtype and device")
    if nsmooth < 0:
        raise ValueError(f"_kcycle_cuda: nsmooth {nsmooth} < 0")
    shapes = [tuple(r.shape)]
    while len(shapes) < len(levels):
        h, w = shapes[-1]
        shapes.append(((h + 1) // 2, (w + 1) // 2))
    if (r.dim() != 2 or min(r.shape) < 1
            or not 1 <= len(levels) <= _MAX_LEVELS
            or any(len(lv) != 4 or any(tuple(t.shape) != s for t in lv)
                   for lv, s in zip(levels, shapes))):
        raise ValueError("_kcycle_cuda needs a 2-D r and the Galerkin "
                         "levels of its shape (diag, E, S, u each)")
    if not r.is_cuda:
        raise ValueError("_kcycle_cuda needs a CUDA tensor, got one on "
                         f"{r.device}; use _kcycle_torch on the CPU")
    L = len(levels)
    tail, smem = _kcycle_plan(shapes, r.element_size(), kdepth,
                              _smem_optin(r.device))
    f64 = int(r.dtype == torch.float64)
    lev = (ctypes.c_void_p * (4 * L))(*(t.data_ptr() for lv in levels
                                        for t in lv))
    hw = (ctypes.c_longlong * (2 * L))(*(v for s in shapes for v in s))
    lib = _build.load()
    nbytes = lib.mg_scratch_bytes(hw, L, tail, kdepth, smem, f64)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=r.device)
    z = torch.empty_like(r)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        with profiling.first_launch("mg_kcycle_launch"):
            err = lib.mg_kcycle_launch(
                lev, hw, L, r.data_ptr(), z.data_ptr(), scratch.data_ptr(),
                nbytes, float(omega), int(nsmooth), int(kdepth),
                int(coarse_iters), tail, smem, f64, stream)
    if err != 0:
        raise RuntimeError(f"mg_kcycle_launch failed: CUDA error {err}")
    _kcycle_cuda.launches += 1
    return z


_kcycle_cuda.launches = 0


class _SpringsGraphs:
    """The multigrid flexible CG of one grid shape on fixed tensors, as two
    CUDA graphs that share one memory pool: P, ``_cg_start`` with the first
    K-cycle, and I, one ``_cg_step`` with its K-cycle and the stop flag.

    ``load`` copies a fill's mask, Galerkin levels, right-hand side, warm
    start and tolerance into the fixed inputs; ``start`` and ``step`` run
    the shared bodies on them and copy the results into the fixed state
    (x, r, p, rz, it, done) and ``flag``.  ``capture`` runs both once
    eagerly on a side stream (the warm-up that ``torch.cuda.graph`` asks
    for) and then records them; a replay runs the same kernels on the
    current stream.  The holder of ``lock`` owns the fixed tensors."""

    def __init__(self):
        self.lock = threading.Lock()
        self.inputs = self.state = self.flag = self.graphs = None
        self.released = None   # CUDA event: the last holder's work on them
        self.kcycle = set()    # the K-cycle versions the captures ran

    def load(self, unknown, deg, levels, b, x0, atol2):
        new = [unknown, deg, b, x0, atol2, *(t for lv in levels for t in lv)]
        if self.inputs is None:
            self.inputs = [t.clone() for t in new]
            z = torch.zeros((), dtype=torch.int64, device=b.device)
            self.state = (torch.empty_like(b), torch.empty_like(b),
                          torch.empty_like(b), torch.empty_like(atol2), z,
                          z.bool())
            self.flag = torch.zeros(2, dtype=torch.int64, device=b.device)
        else:
            for dst, src in zip(self.inputs, new):
                dst.copy_(src)

    def _apply(self, x):
        unknown, deg = self.inputs[:2]
        x = x * unknown
        return (deg * x - _neighbor_sum(x)) * unknown

    def _precond(self, r):
        flat = self.inputs[5:]
        return _kcycle(r, [flat[i:i + 4] for i in range(0, len(flat), 4)],
                       0, ran=self.kcycle)

    def _store(self, state):
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        self.flag.copy_(_flag(state))

    def start(self):
        b, x0, atol2 = self.inputs[2:5]
        self._store(_cg_start(self._apply, b, x0, self._precond, atol2))

    def step(self):
        self._store(_cg_step(self.state, self._apply, self._precond,
                             self.inputs[4], True))

    def capture(self):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.start()
            self.step()
        torch.cuda.current_stream().wait_stream(side)
        start, step = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(start, capture_error_mode="thread_local"):
            self.start()
        with torch.cuda.graph(step, pool=start.pool(),
                              capture_error_mode="thread_local"):
            self.step()
        self.graphs = (start, step)


class _GraphCache:
    """The ``_SpringsGraphs`` of the last ``size`` (H, W, dtype, device)
    keys filled, least recently used evicted.  An entry holds about ten
    grids of the fill's dtype and the pool of one iteration's temporaries
    (≈ 0.4 GB at 2001² float32).  Captures run one at a time, each the
    span ``first_use.graph_capture`` (a key's again after an eviction)."""

    def __init__(self, size=4):
        self.size = size
        self._entries = collections.OrderedDict()
        self._lock = threading.Lock()
        self._capture = threading.Lock()

    def fill(self, A, nanmask, unknown, deg, levels, b, x0, atol2, maxiter):
        """The multigrid fill of ``A`` (on a CUDA device) through the
        graphs of its key, capturing them at the key's first fill.
        Returns (filled, iterations, host syncs, "captured" or
        "replayed", graph replays, the K-cycle versions in the graphs)."""
        key = (tuple(A.shape), A.dtype, A.device)
        with self._lock:
            g = self._entries.pop(key, None) or _SpringsGraphs()
            self._entries[key] = g
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)
        with g.lock, torch.cuda.device(A.device):
            stream = torch.cuda.current_stream()
            if g.released is not None:
                stream.wait_event(g.released)
            g.load(unknown, deg, levels, b, x0, atol2)
            how = "replayed"
            if g.graphs is None:
                with self._capture, profiling.once(
                        "first_use.graph_capture",
                        attr={"shape": list(A.shape), "dtype": str(A.dtype)}):
                    g.capture()
                how = "captured"
            start, step = g.graphs
            start.replay()
            it, syncs, steps = _iterate(step.replay, lambda: g.flag,
                                        maxiter, CHECK_EVERY_MULTIGRID)
            out = torch.where(nanmask, g.state[0], A)
            g.released = stream.record_event()
        return out, it, syncs, how, 1 + steps, set(g.kcycle)


_GRAPHS = _GraphCache()


def _graphs_on(device):
    """Whether a multigrid fill on ``device`` runs as CUDA graphs: on a
    CUDA device."""
    return device.type == "cuda"


def _springs_core(A, tol, maxiter, multiscale=True):
    """Spring-graph fill of a float tensor on its own device.  Returns
    (filled, {"iterations", "host_syncs", "graph", "replays", "kcycle"}):
    ``graph`` is "captured" or "replayed" for a multigrid fill on a CUDA
    device (``_GRAPHS``), else "eager"; ``replays`` counts the graph
    replays; ``kcycle`` is the K-cycle version that ``_kcycle`` ran (in
    the graphs, the one they captured): "cuda" for the kernels, "torch"
    for the plain version, None on the Jacobi branch.
    While a profile is open the fill is the span ``inpaint.springs``, with
    its device time and that dict as its ``attr``."""
    A = float_tensor(A)
    with profiling.span("inpaint.springs", device=A.device) as sp:
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
        mean = torch.nansum(known_vals) / torch.clamp_min(
            torch.sum(known_mask), 1.0)
        x0 = unknown * mean

        H, W = A.shape
        graph, replays, ran = "eager", 0, set()
        if multiscale and min(H, W) >= 64:
            # multigrid-preconditioned flexible CG: iteration counts stay
            # ~O(10) whatever the diameter of the NaN regions
            levels = _build_levels(unknown, deg)
            if _graphs_on(A.device):
                # each iteration thousands of small kernels: replayed as
                # CUDA graphs, the host launches one graph an iteration
                out, it, syncs, graph, replays, ran = _GRAPHS.fill(
                    A, nanmask, unknown, deg, levels, b, x0,
                    _atol2(b, tol), maxiter)
            else:
                x, it, syncs = _cg(apply_fn, b, x0,
                                   lambda r: _kcycle(r, levels, 0, ran=ran),
                                   tol, maxiter, True, CHECK_EVERY_MULTIGRID)
                out = torch.where(nanmask, x, A)
        else:
            inv_deg = torch.where(deg > 0, 1.0 / deg, 0.0)
            x, it, syncs = _cg(apply_fn, b, x0,
                               lambda r: r * inv_deg * unknown, tol,
                               maxiter, False, CHECK_EVERY_PLAIN)
            out = torch.where(nanmask, x, A)
        info = {"iterations": it, "host_syncs": syncs, "graph": graph,
                "replays": replays, "kcycle": "+".join(sorted(ran)) or None}
        if sp is not None:
            sp.attr = dict(info)
        return out, info


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
