"""The springs fill's multigrid K-cycle as hand-written kernels
(``neilpy_tpu_torch/ops/inpaint.py``: ``_kcycle``, ``_kcycle_cuda``,
``_kcycle_torch``, ``_kcycle_plan``; ``csrc/multigrid_kcycle.cu``).

On the CPU: a CPU tensor takes the plain version, which gives the bits of
the K-cycle as it was before the kernels (a copy of it is kept here, with
the second flexible-CG step's unused residual, cycle and direction that
the plain version no longer computes); the wrapper's checks raise before
anything launches; the tail's top level follows from the shapes, the
dtype and the shared memory a block may opt into; ``_kcycle`` reports the
version it ran, and the ``inpaint.springs`` span's ``attr`` carries it.
The ``cuda`` tests hold each kernel stage to its torch ops on the card,
an application to the plain version, a fill to the eager fill and a
graph replay to a direct run; they need no JAX: ``python3 -m pytest
--noconftest -p no:cacheprovider tests/test_torch_inpaint_kcycle_cuda.py
-m cuda``.
"""

import ctypes

import numpy as np
import pytest
import torch

from neilpy_tpu_torch import _build, profiling
from neilpy_tpu_torch.ops import inpaint

CPU = torch.device("cpu")
# SMRF's 2001^2 DTM: its hierarchy's extents, 2001^2 down to 4^2
SMRF_SHAPES = [(2001, 2001), (1001, 1001), (501, 501), (251, 251),
               (126, 126), (63, 63), (32, 32), (16, 16), (8, 8), (4, 4)]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def kcycle_before(r, levels, l, omega=0.9, nsmooth=2, kdepth=2,
                  coarse_iters=24):
    """``inpaint._kcycle`` as it was before the kernels, its second
    flexible-CG step whole: the reference of the CPU tests below."""
    if l + 1 == len(levels):
        return inpaint._coarse_cg(r, levels[l], iters=coarse_iters)
    diag, E, S, u = levels[l]
    H, W = u.shape
    invD = torch.where(diag > 0, omega / diag, 0.0) * u

    def A(x):
        return inpaint._apply_level(x * u, diag, E, S) * u

    def smooth(x):
        for _ in range(nsmooth):
            x = x + invD * (r - A(x))
        return x

    x = smooth(torch.zeros_like(r))
    rc = inpaint._blocksum2(r - A(x)) * levels[l + 1][3]
    if kdepth > 0 and l + 2 < len(levels):
        dc, Ec, Sc, uc = levels[l + 1]

        def Ac(xx):
            return inpaint._apply_level(xx * uc, dc, Ec, Sc) * uc

        xc = torch.zeros_like(rc)
        rr = rc
        z = kcycle_before(rr, levels, l + 1, omega, nsmooth, kdepth - 1,
                          coarse_iters)
        p = z
        rz = torch.sum(rr * z)
        for _ in range(2):
            Ap = Ac(p)
            alpha = inpaint._safe_div(rz, torch.sum(p * Ap))
            xc = xc + alpha * p
            r_new = rr - alpha * Ap
            z_new = kcycle_before(r_new, levels, l + 1, omega, nsmooth,
                                  kdepth - 1, coarse_iters)
            rz_new = torch.sum(r_new * z_new)
            beta = inpaint._safe_div(rz_new - torch.sum(rr * z_new), rz)
            p = z_new + beta * p
            rr, z, rz = r_new, z_new, rz_new
    else:
        xc = kcycle_before(rc, levels, l + 1, omega, nsmooth, 0,
                           coarse_iters)
    return smooth(x + inpaint._prolong2(xc, H, W) * u)


def smrf_mask(shape, seed=0, empty=0.29):
    """An SMRF-like mask of unknown cells: scattered empty bins (a share
    ``empty`` in all) and one block without returns."""
    H, W = shape
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < empty - 0.04
    m[H // 3:H // 3 + max(1, H // 5), W // 4:W // 4 + max(1, W // 5)] = True
    return torch.from_numpy(m)


def hierarchy(shape, seed=0, dtype=torch.float32, device=CPU):
    """(levels, r): the Galerkin levels of an SMRF-like mask and a
    residual on its unknown cells."""
    unknown = smrf_mask(shape, seed).to(device, dtype)
    levels = inpaint._build_levels(unknown, inpaint._degree(
        shape, dtype=dtype, device=device))
    rng = np.random.default_rng(seed + 100)
    r = torch.from_numpy(rng.normal(size=shape)).to(device, dtype) * unknown
    return levels, r


# ----------------------------------------------------------------------
# CPU
# ----------------------------------------------------------------------
CPU_CASES = [((64, 97), torch.float32, {}),
             ((64, 97), torch.float64, {}),
             ((127, 300), torch.float32, {}),
             ((70, 99), torch.float32, dict(kdepth=1, nsmooth=3)),
             ((70, 99), torch.float64, dict(kdepth=3, omega=0.7,
                                            coarse_iters=5)),
             ((96, 80), torch.float32, dict(nsmooth=1, kdepth=0))]


@pytest.mark.parametrize("shape,dtype,kw", CPU_CASES,
                         ids=[f"{s[0]}x{s[1]}-{str(d)[6:]}-{i}"
                              for i, (s, d, _) in enumerate(CPU_CASES)])
def test_cpu_tensor_takes_the_plain_version_bit_for_bit(monkeypatch, shape,
                                                        dtype, kw):
    """``_kcycle`` on a CPU tensor runs the plain version, which equals the
    K-cycle as it was before the kernels bit for bit: leaving out the
    second flexible-CG step's unused work changes nothing."""
    def no_kernels(*args, **kwargs):
        raise AssertionError("the kernel path was taken on the CPU")

    monkeypatch.setattr(inpaint, "_kcycle_cuda", no_kernels)
    levels, r = hierarchy(shape, seed=shape[1], dtype=dtype)
    for l, rl in ((0, r), (1, inpaint._blocksum2(r) * levels[1][3])):
        got = inpaint._kcycle(rl, levels, l, **kw)
        assert got.dtype == dtype
        assert torch.equal(got, kcycle_before(rl, levels, l, **kw))


@pytest.mark.parametrize("case", ["cpu", "float16", "non_contiguous",
                                  "mixed_dtype", "wrong_levels",
                                  "negative_nsmooth"])
def test_wrapper_raises_before_launching(monkeypatch, case):
    """``_kcycle_cuda`` takes contiguous float32 / float64 CUDA tensors of
    one dtype and a hierarchy of r's shape, and raises on anything else
    without building or loading the library."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "load", no_library)
    levels, r = hierarchy((40, 50))
    kw = {}
    if case == "float16":
        r = r.half()
        levels = [[t.half() for t in lv] for lv in levels]
        match = "float32 or float64"
    elif case == "non_contiguous":
        r = torch.zeros((50, 40)).T
        match = "contiguous"
    elif case == "mixed_dtype":
        levels = [list(lv) for lv in levels]
        levels[2][1] = levels[2][1].double()
        match = "one dtype"
    elif case == "wrong_levels":
        levels = levels[1:]
        match = "Galerkin levels"
    elif case == "negative_nsmooth":
        kw = dict(nsmooth=-1)
        match = "nsmooth"
    else:
        match = "CUDA tensor"
    with pytest.raises(ValueError, match=match):
        inpaint._kcycle_cuda(r, levels, **kw)


# shared memory one block may opt into on an H100 (sm_90), and the 48 KiB
# any CUDA card gives a block
H100_OPTIN, SMALL_OPTIN = 232_448, 49_152


def test_tail_level_from_the_shapes_and_the_dtype():
    """The tail starts at the first level whose working set (8 arrays a
    level, every coarser level's, and the coarse CG's A(p)) fits in the
    shared memory a block may opt into, never above the flexible-CG
    levels: at SMRF's 2001^2 on an H100, 63^2 in float32 and 32^2 in
    float64; lower where a card offers less."""
    def plan(shapes, itemsize, kdepth, smem=H100_OPTIN):
        return inpaint._kcycle_plan(shapes, itemsize, kdepth, smem)
    n = [h * w for h, w in SMRF_SHAPES]
    assert plan(SMRF_SHAPES, 4, 2) == (5, (8 * sum(n[5:]) + 16) * 4)
    assert plan(SMRF_SHAPES, 8, 2) == (6, (8 * sum(n[6:]) + 16) * 8)
    assert plan(SMRF_SHAPES, 4, 2)[1] <= H100_OPTIN
    assert (8 * sum(n[4:]) + 16) * 4 > H100_OPTIN
    assert plan(SMRF_SHAPES, 4, 2, SMALL_OPTIN) == (
        6, (8 * sum(n[6:]) + 16) * 4)
    assert plan(SMRF_SHAPES, 8, 2, SMALL_OPTIN) == (
        7, (8 * sum(n[7:]) + 16) * 8)
    # small grids: the tail starts where the flexible CG ends
    small = [(64, 97), (32, 49), (16, 25), (8, 13), (4, 7)]
    assert plan(small, 8, 2)[0] == 2
    assert plan(small, 4, 0)[0] == 1       # 64 x 97 alone is 266 KB
    assert plan(small[1:], 4, 0)[0] == 0
    assert plan(small, 4, 9)[0] == 3       # kdepth past the levels
    assert plan([(4, 7)], 4, 2) == (0, (8 * 28 + 28) * 4)
    # a coarsest level too wide for shared memory: the tail in global memory
    wide = [(8, 20000), (4, 10000)]
    assert plan(wide, 4, 2) == (1, 0)
    assert plan([(4, 7)], 4, 2, 0) == (0, 0)


def test_span_attr_says_where_the_kcycle_ran():
    """On the CPU a multigrid fill's ``inpaint.springs`` span reads
    ``kcycle`` "torch", a Jacobi fill (a side under 64) None; the attr is
    the fill's info."""
    fills = []
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for shape in ((96, 80), (40, 63)):
            A = torch.from_numpy(np.random.default_rng(1).normal(
                size=shape).cumsum(0))
            A[smrf_mask(shape, 2)] = float("nan")
            fills.append(inpaint._springs_core(A, 1e-7, 4000)[1])
    spans = [s for s in profiling.spans() if s.name == "inpaint.springs"]
    profiling.clear_spans()
    assert [s.attr for s in spans] == fills
    assert [f["kcycle"] for f in fills] == ["torch", None]


def test_kcycle_reports_the_version_it_ran(monkeypatch):
    """``_kcycle`` adds the version it dispatched to to ``ran``, and a
    fill's ``kcycle`` is what its K-cycles reported, not its device."""
    levels, r = hierarchy((64, 97), seed=3)
    ran = set()
    got = inpaint._kcycle(r, levels, 0, ran=ran)
    assert ran == {"torch"}
    assert torch.equal(got, inpaint._kcycle_torch(r, levels, 0))
    plain = inpaint._kcycle

    def reports(tag):
        def kcycle(r, levels, l, *a, ran=None, **kw):
            if ran is not None:
                ran.add(tag)
            return plain(r, levels, l, *a, **kw)
        return kcycle

    A = torch.from_numpy(np.random.default_rng(4).normal(
        size=(96, 80)).cumsum(0))
    A[smrf_mask((96, 80), 4)] = float("nan")
    want, info = inpaint._springs_core(A, 1e-7, 4000)
    assert info["kcycle"] == "torch"
    for tag in ("cuda", "elsewhere"):
        monkeypatch.setattr(inpaint, "_kcycle", reports(tag))
        got, info = inpaint._springs_core(A, 1e-7, 4000)
        assert info["kcycle"] == tag and torch.equal(got, want)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _level_args(level):
    return ((ctypes.c_void_p * 4)(*(t.data_ptr() for t in level)),
            (ctypes.c_longlong * 2)(*level[3].shape))


def _ptr(t):
    return None if t is None else t.data_ptr()


def smooth_kernel(level, r, x, xc, mode, sweep, omega=0.9):
    """One launch of the smoothing kernel (mode 0 from zero, 1 with the
    prolonged xc, 2 plain)."""
    out = torch.empty_like(r)
    lev, hw = _level_args(level)
    err = _build.load().mg_smooth_launch(
        lev, hw, r.data_ptr(), _ptr(x), _ptr(xc),
        1 if xc is None else xc.shape[1], omega, mode, sweep,
        out.data_ptr(), int(r.dtype == torch.float64), _stream())
    assert err == 0
    return out


def restrict_kernel(level, r, x, uc):
    rc = torch.empty_like(uc)
    lev, hw = _level_args(level)
    err = _build.load().mg_restrict_launch(
        lev, hw, r.data_ptr(), x.data_ptr(), uc.data_ptr(), *uc.shape,
        rc.data_ptr(), int(r.dtype == torch.float64), _stream())
    assert err == 0
    return rc


def torch_ops(level, omega=0.9):
    """The plain version's stages as torch ops: (sweep, A)."""
    diag, E, S, u = level
    invD = torch.where(diag > 0, omega / diag, 0.0) * u

    def A(x):
        return inpaint._apply_level(x * u, diag, E, S) * u

    def sweep(x, r):
        return x + invD * (r - A(x))

    return sweep, A


STAGE_SHAPES = [(2001, 2001), (64, 97), (127, 1000), (5, 3), (1, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", STAGE_SHAPES,
                         ids=[f"{h}x{w}" for h, w in STAGE_SHAPES])
def test_each_stage_equals_its_torch_ops_on_card(card, shape, dtype):
    """Every smoothing mode and the restriction on the same inputs as the
    plain version's torch ops, on the card: bit for bit.  The restriction's
    2x2 block sum is held bit for bit to the kernel's order ((v00 + v01) +
    v10) + v11 in torch ops, and to ``_blocksum2`` (torch.sum's own order)
    within 2 ulp of the sum of the four terms' magnitudes, the most two
    orders of four additions can differ by."""
    levels, r = hierarchy(shape, seed=7, dtype=dtype, device=card)
    for l in range(min(2, len(levels))):
        level = levels[l]
        u = level[3]
        H, W = u.shape
        rng = np.random.default_rng(l)
        if l:
            r = torch.from_numpy(rng.normal(size=(H, W))).to(card, dtype) * u
        x = torch.from_numpy(rng.normal(size=(H, W))).to(card, dtype) * u
        sweep, A = torch_ops(level)
        zero = torch.zeros_like(r)
        x1 = sweep(zero, r)
        assert torch.equal(smooth_kernel(level, r, None, None, 0, 0), x1)
        assert torch.equal(smooth_kernel(level, r, None, None, 0, 1),
                           sweep(x1, r))
        assert torch.equal(smooth_kernel(level, r, x, None, 2, 1),
                           sweep(x, r))
        for omega in (0.9, 0.55):
            sweep_w, _ = torch_ops(level, omega)
            assert torch.equal(smooth_kernel(level, r, x, None, 2, 1, omega),
                               sweep_w(x, r))
        if len(levels) > l + 1:
            uc = levels[l + 1][3]
            Hc, Wc = uc.shape
            xc = torch.from_numpy(rng.normal(size=(Hc, Wc))).to(card, dtype)
            x3 = x + inpaint._prolong2(xc, H, W) * u
            assert torch.equal(smooth_kernel(level, r, x, xc, 1, 0), x3)
            assert torch.equal(smooth_kernel(level, r, x, xc, 1, 1),
                               sweep(x3, r))
            got = restrict_kernel(level, r, x, uc)
            v = inpaint._pad_even(r - A(x))
            ordered = ((v[0::2, 0::2] + v[0::2, 1::2]) + v[1::2, 0::2]) \
                + v[1::2, 1::2]
            assert torch.equal(got, ordered * uc)
            want = inpaint._blocksum2(r - A(x)) * uc
            mag = inpaint._blocksum2((r - A(x)).abs())
            eps = torch.finfo(dtype).eps
            assert bool(((got - want).abs() <= 2 * eps * mag).all())


# relative tolerances of one application against the plain version, of
# max |plain|: its 7 dot products a flexible-CG level and the coarse CG's
# 49 sums a V-recursion round in another order than torch.sum, and each
# scalar they give (alpha, beta) scales a whole correction; a few thousand
# ulp of the largest value in float32, as many in float64
APPLY_RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
APPLY_SHAPES = [(2001, 2001), (64, 97), (127, 1000), (300, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", APPLY_SHAPES,
                         ids=[f"{h}x{w}" for h, w in APPLY_SHAPES])
def test_one_application_equals_the_plain_version_on_card(card, shape,
                                                          dtype):
    levels, r = hierarchy(shape, seed=3, dtype=dtype, device=card)
    launches = inpaint._kcycle_cuda.launches
    got = inpaint._kcycle(r, levels, 0)
    assert inpaint._kcycle_cuda.launches == launches + 1
    want = inpaint._kcycle_torch(r, levels, 0)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert scale > 0 and err <= APPLY_RTOL[dtype] * scale, (err, scale)
    assert torch.equal(got * (1 - levels[0][3]), torch.zeros_like(got))
    # from a coarser level, and with other parameters, as the sharded
    # fill's hand-off calls it
    rc = inpaint._blocksum2(r) * levels[1][3]
    for kw in ({}, dict(omega=0.7, nsmooth=3, kdepth=1, coarse_iters=10),
               dict(nsmooth=1, kdepth=0), dict(nsmooth=0)):
        got = inpaint._kcycle(rc, levels, 1, **kw)
        want = inpaint._kcycle_torch(rc, levels, 1, **kw)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= APPLY_RTOL[dtype] * scale, (kw, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_any_tail_level_gives_the_same_bits_on_card(card, monkeypatch,
                                                    dtype):
    """The tail and the level kernels share their arithmetic: starting the
    tail at any level it may take, or keeping its work in global memory,
    gives the same bits."""
    levels, r = hierarchy((300, 301), seed=5, dtype=dtype, device=card)
    shapes = [tuple(lv[3].shape) for lv in levels]
    want = inpaint._kcycle_cuda(r, levels)
    size = r.element_size()
    for tail in range(2, len(levels)):
        nbytes = (8 * sum(h * w for h, w in shapes[tail:])
                  + shapes[-1][0] * shapes[-1][1]) * size
        for smem in ([nbytes, 0] if nbytes <= inpaint._smem_optin(card)
                     else [0]):
            monkeypatch.setattr(inpaint, "_kcycle_plan",
                                lambda *a, t=tail, s=smem: (t, s))
            assert torch.equal(inpaint._kcycle_cuda(r, levels), want), \
                (tail, smem)


@pytest.mark.cuda
def test_graph_replay_equals_a_direct_run_and_syncs_nothing_on_card(card):
    levels, r = hierarchy((2001, 2001), seed=9, device=card)
    want = inpaint._kcycle_cuda(r, levels)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        inpaint._kcycle_cuda(r, levels)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = inpaint._kcycle_cuda(r, levels)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = inpaint._kcycle_cuda(r, levels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(again, want)


# a fill against the eager fill whose K-cycle is the plain version: the
# CG stops at |r| <= tol |b| on both, so the answers agree to what the
# stop leaves (float32 at tol 1e-7: 1e-3 of a raster of unit steps, as
# chip_smoke's f32-vs-f64 fill; float64 at tol 1e-12: 1e-8)
FILL_ATOL = {torch.float32: 1e-3, torch.float64: 1e-8}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fill_equals_the_plain_versions_fill_on_card(card, monkeypatch,
                                                     dtype):
    shape = (1031, 777)
    A = torch.from_numpy(np.random.default_rng(11).normal(
        size=shape).cumsum(0).cumsum(1) * 0.1).to(card, dtype)
    A[smrf_mask(shape, 4).to(card)] = float("nan")
    tol = 1e-7 if dtype == torch.float32 else 1e-12
    monkeypatch.setattr(inpaint, "_GRAPHS", inpaint._GraphCache())
    launches = inpaint._kcycle_cuda.launches
    got, info = inpaint._springs_core(A, tol, 100_000)
    assert info["kcycle"] == "cuda" and info["graph"] == "captured"
    assert inpaint._kcycle_cuda.launches > launches
    with monkeypatch.context() as m:
        m.setattr(inpaint, "_graphs_on", lambda device: False)
        m.setattr(inpaint, "_kcycle_cuda",
                  lambda r, levels, *a: inpaint._kcycle_torch(r, levels, 0,
                                                              *a))
        want, winfo = inpaint._springs_core(A, tol, 100_000)
    assert abs(info["iterations"] - winfo["iterations"]) <= 1
    err = float((got - want).abs().max())
    assert err <= FILL_ATOL[dtype], err
    known = ~torch.isnan(A)
    assert torch.equal(got[known], A[known])
