"""The port's ladder routing (``neilpy_tpu_torch/ops/cuda_scan.py``): K5's
static region plan and the dynamic per-block predicate of K1-K4, held
against the JAX package and against brute force on the CPU.

- (a) the port's copies of ``_resolve_specialize``, ``_axis_segments``
  and ``_axis_bad`` equal the JAX functions;
- (b) soundness, by brute force in numpy: every (thread block,
  direction) pair that the plan or the predicate sends down the maskless
  ladder reads only on-array cells for every pixel and every ladder step,
  and for a shard block stays inside the global raster; NaN cells need no
  routing, since the maskless body skips a NaN read as the masked one
  does (shown on NaN holes, bands and single NaNs);
- (c) the plain versions routed as the kernels route
  (``route='static'`` / ``'dynamic'``: ``torch.fmax`` / ``torch.fmin``
  and no epilogue on the safe pairs, +inf read off the array) equal the
  unrouted plain versions and the JAX functions
  run with ``specialize=True`` in interpret mode, on the JAX package's own
  fixtures (tests/test_pallas.py): counts, classes and codes exactly,
  openness within 1e-4 degrees, skyview within 1e-6;
- (d) ``openness_pair(specialize=None/True/False)`` gives the same output.

Kernel tests (both routes against the plain version) need a card; they
skip here, and ``chip_smoke.py`` runs the same comparisons on the H100.
"""

import numpy as np
import pytest
import torch

from neilpy_tpu.ops import pallas_scan as jps
from neilpy_tpu_torch.core.shift import OFFSETS
from neilpy_tpu_torch.ops import cuda_scan as cs
from neilpy_tpu_torch.ops import visibility as tvis

torch.set_num_threads(1)

OPENNESS_ATOL = 1e-4
SVF_ATOL = 1e-6


# ----------------------------------------------------------------------
# (a) the port's copies of the JAX plan functions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("specialize", [None, True, False])
@pytest.mark.parametrize("interpret", [True, False])
@pytest.mark.parametrize("fast", [True, False])
def test_resolve_specialize_equals_jax(specialize, interpret, fast):
    assert (cs._resolve_specialize(specialize, interpret, fast)
            is jps._resolve_specialize(specialize, interpret, fast))


def test_resolve_specialize_truth_table():
    """tests/test_pallas.py::test_specialize_default_resolution, on the
    port's copy."""
    r = cs._resolve_specialize
    assert r(None, interpret=False, fast=False) is True
    assert r(None, interpret=True, fast=False) is False
    assert r(None, interpret=False, fast=True) is False
    assert r(None, interpret=True, fast=True) is False
    assert r(True, interpret=True, fast=True) is True
    assert r(False, interpret=False, fast=False) is False


@pytest.mark.parametrize("align", [8, 128, 32])
def test_axis_segments_equal_jax(align):
    """A sweep of (P, T, Rmax, N) at JAX's (8, 128) alignment and at the
    port's 32-column blocks."""
    for N in (1, 7, 8, 24, 40, 97, 130, 260, 640, 1000):
        P = -(-N // align) * align
        for T in (align, 2 * align, 4 * align):
            for Rmax in (1, 2, 5, 7, 12, 23, 33, 50, 100, 300):
                a = cs._axis_segments(P, T, Rmax, N, align)
                assert a == jps._axis_segments(P, T, Rmax, N, align)
                for *_, flags in a:
                    for dd in (-1, 0, 1):
                        assert (cs._axis_bad(dd, flags)
                                == jps._axis_bad(dd, flags))


def test_specialize_picks_the_kernel():
    """On a CUDA tensor ``specialize`` picks K5 or K1/K2 as
    ``_resolve_specialize`` says: None is K5 for the exact ladder only."""
    assert cs._counts_kernel(None, False) is cs.openness_counts_plan_cuda
    assert cs._counts_kernel(None, True) is cs.openness_counts_cuda
    assert cs._counts_kernel(True, True) is cs.openness_counts_plan_cuda
    assert cs._counts_kernel(False, False) is cs.openness_counts_cuda
    assert cs._reduced_kernel(None, False) is cs.openness_reduced_plan_cuda
    assert cs._reduced_kernel(None, True) is cs.openness_reduced_cuda
    assert cs._reduced_kernel(True, True) is cs.openness_reduced_plan_cuda
    assert cs._reduced_kernel(False, False) is cs.openness_reduced_cuda


def test_specialize_on_cpu_never_reaches_a_kernel():
    """No fallback: a CPU tensor forced onto a kernel raises, on either
    route; ``engine='auto'`` runs the plain version and counts nothing."""
    Zt = torch.zeros((16, 40))
    for call in (
            lambda: cs.openness_counts(Zt, engine="cuda", specialize=True),
            lambda: cs.openness_counts(Zt, engine="cuda", specialize=False),
            lambda: cs.openness_reduced(Zt, "svf", engine="cuda",
                                        specialize=True),
            lambda: cs.openness_counts_plan_cuda(Zt),
            lambda: cs.openness_reduced_plan_cuda(Zt, "ternary"),
            lambda: cs.geomorphons_cuda(Zt, specialize=True),
            lambda: cs.skyview_cuda(Zt, specialize=False)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    counters = (cs.openness_counts_cuda, cs.openness_counts_plan_cuda,
                cs.openness_reduced_cuda, cs.openness_reduced_plan_cuda)
    before = [fn.launches for fn in counters]
    for spec in (None, True, False):
        cs.openness_counts(Zt, lookup_pixels=3, specialize=spec)
        cs.openness_reduced(Zt, "openness", lookup_pixels=3, specialize=spec)
    assert [fn.launches for fn in counters] == before


def test_region_plan_regions():
    """The plan makes the 9 regions of a large raster: low strips of
    ceil(Rmax / block) blocks, the interior maskless in every direction,
    and only the 10 unsafe sets the kernels instantiate."""
    rlo, rhi, rm, clo, chi, cm = cs.region_plan(8192, 8192, 50)
    assert (rlo, rhi, clo, chi) == (56, 8136, 64, 8128)
    assert (rm & 0xFF, rm >> 8 & 0xFF, rm >> 16) == (0x07, 0, 0x70)
    assert (cm & 0xFF, cm >> 8 & 0xFF, cm >> 16) == (0xC1, 0, 0x1C)
    sets = set()
    for H, W, R in ((8192, 8192, 50), (130, 260, 12), (24, 40, 30),
                    (97, 45, 7), (640, 640, 2), (1000, 1537, 100)):
        safe = cs.plan_safe(H, W, R)
        unsafe = sum((~safe[d]).astype(int) << d for d in range(8))
        sets |= set(np.unique(unsafe).tolist())
    assert sets <= {0x00, 0x07, 0x70, 0xC1, 0x1C, 0xC7, 0x1F, 0xF1, 0x7C,
                    0xFF}
    assert len(sets) == 10
    share = cs.plan_safe(8192, 8192, 50).mean()
    assert share > 0.98


# ----------------------------------------------------------------------
# (b) soundness by brute force
# ----------------------------------------------------------------------
def _bad_blocks(Z, ladder, grid, grid0, origin=None, global_shape=None):
    """(8, nby, nbx) bool: some pixel of the thread block (one the kernel
    computes: inside the grid's (rows, cols) extent) reads off the array at
    some ladder step in direction d, or its last step leaves the global
    raster."""
    H, W = Z.shape
    nby, nbx = grid
    by, bx = cs.BLOCK
    r0, c0 = grid0
    rows = np.arange(H)[:, None]
    cols = np.arange(W)[None, :]
    out = np.zeros((8, nby, nbx), dtype=bool)
    for d, (dr, dc) in enumerate(OFFSETS):
        bad = np.zeros((H, W), dtype=bool)
        for L in ladder:
            sr, sc = rows + dr * L, cols + dc * L
            bad |= (sr < 0) | (sr >= H) | (sc < 0) | (sc >= W)
        if origin is not None:
            gh, gw = global_shape
            gr = rows + origin[0] + dr * ladder[-1]
            gc = cols + origin[1] + dc * ladder[-1]
            bad |= (gr < 0) | (gr >= gh) | (gc < 0) | (gc >= gw)
        # pixels the kernel's grid computes, per thread block
        ext = np.zeros((max(H, r0 + nby * by), max(W, c0 + nbx * bx)),
                       dtype=bool)
        ext[:H, :W] = bad
        ext = ext[r0:r0 + nby * by, c0:c0 + nbx * bx]
        out[d] = ext.reshape(nby, by, nbx, bx).any(axis=(1, 3))
    return out


def _raster(shape, seed, holes=()):
    Z = np.random.default_rng(seed).normal(size=shape).cumsum(0).cumsum(1)
    Z = Z.astype(np.float32)
    for sl in holes:
        Z[sl] = np.nan
    return Z


SOUNDNESS_CASES = [
    # (shape, NaN holes, lookups, fast)
    ((130, 260), [np.s_[60:64, 120:130]], (1, 2, 7, 12, 33, 300), False),
    ((97, 45), [], (1, 2, 7, 12, 33, 120), False),
    ((257, 389), [np.s_[100:120, 40:90], np.s_[200:203, :]],
     (1, 2, 7, 12, 33), False),
    # one hole deep in an interior block, far from every edge
    ((300, 420), [np.s_[150, 210]], (1, 2, 7, 12, 33), False),
    ((257, 389), [np.s_[100:120, 40:90]], (7, 12, 33, 50), True),
]


@pytest.mark.parametrize("shape,holes,lookups,fast", SOUNDNESS_CASES)
def test_routing_is_sound(shape, holes, lookups, fast):
    Z = _raster(shape, 1, holes)
    Zt = torch.from_numpy(Z)
    grid = cs._grid(*shape)
    for lk in lookups:
        ladder = cs._ladder(lk, fast)
        bad = _bad_blocks(Z, ladder, grid, (0, 0))
        dyn = cs.route_table(Zt, lk, fast, specialize=False).numpy()
        stat = cs.route_table(Zt, lk, fast, specialize=True).numpy()
        assert not (dyn & bad).any(), f"dynamic route, lookup {lk}"
        assert not (stat & bad).any(), f"static plan, lookup {lk}"
        # the plan's safe set lies inside the predicate's
        assert not (stat & ~dyn).any()
        # a window that is on the raster is taken (not vacuous)
        if lk <= 12:
            assert dyn.any() and stat.any()
        if lk > max(shape):
            assert not dyn.any() and not stat.any()


@pytest.mark.parametrize("fast", [False, True])
def test_shard_block_routing_is_sound(fast):
    """K4's grid (the core of an R-haloed block) and K3's origin entry
    (the whole block, halo too) against brute force in global
    coordinates: corner, edge, interior and NaN-hole origins."""
    Z = _raster((150, 233), 2, [np.s_[70:74, 100:130], np.s_[20, 200]])
    H, W = Z.shape
    for lk in (2, 7, 12, 33):
        Zp = np.pad(Z, lk, constant_values=np.nan)
        ladder = cs._ladder(lk, fast)
        for (oy, ox), (bh, bw) in (((0, 0), (75, 117)), ((75, 116),
                                                         (75, 117)),
                                   ((40, 60), (64, 96)), ((60, 90),
                                                          (33, 50))):
            blk = np.ascontiguousarray(
                Zp[oy:oy + bh + 2 * lk, ox:ox + bw + 2 * lk])
            bt = torch.from_numpy(blk)
            k4 = cs.route_table(bt, lk, fast, origin=(oy, ox),
                                global_shape=(H, W), core=lk).numpy()
            bad = _bad_blocks(blk, ladder, cs._grid(bh, bw), (lk, lk),
                              (oy - lk, ox - lk), (H, W))
            assert not (k4 & bad).any(), f"K4 at {(oy, ox)} lookup {lk}"
            k3 = cs.route_table(bt, lk, fast, origin=(oy - lk, ox - lk),
                                global_shape=(H, W)).numpy()
            bad = _bad_blocks(blk, ladder, cs._grid(*blk.shape), (0, 0),
                              (oy - lk, ox - lk), (H, W))
            assert not (k3 & bad).any(), f"K3 at {(oy, ox)} lookup {lk}"
            if lk <= 7 and bh >= 64:
                assert k4.any() and k3.any()


NAN_LAYOUTS = [
    # (name, NaN cells): a hole, a full band, one NaN deep in the interior,
    # a whole thread block of NaN
    ("hole", [np.s_[60:70, 100:140]]),
    ("band", [np.s_[90:93, :]]),
    ("deep", [np.s_[75, 117]]),
    ("block", [np.s_[48:56, 64:96]]),
]


@pytest.mark.parametrize("name,holes", NAN_LAYOUTS)
def test_maskless_body_skips_nan_as_the_masked_one(name, holes):
    """The routed plain versions take the maskless body on blocks whose
    window holds NaN, and still equal the masked body everywhere: extrema
    by value, counts and codes exactly.  This is why the kernels need no
    per-block NaN test."""
    Z = _raster((150, 233), 6, holes)
    Zt = torch.from_numpy(Z)
    for lk, fast in ((3, False), (12, False), (23, True)):
        tbl = cs.route_table(Zt, lk, fast).numpy()
        near = np.zeros(tbl.shape[1:], dtype=bool)
        by, bx = cs.BLOCK
        rr, cc = np.nonzero(np.isnan(Z))
        Rmax = cs._ladder(lk, fast)[-1]
        for i in range(near.shape[0]):
            for j in range(near.shape[1]):
                near[i, j] = ((rr >= i * by - Rmax) & (rr < i * by + by + Rmax)
                              & (cc >= j * bx - Rmax)
                              & (cc < j * bx + bx + Rmax)).any()
        # not vacuous: some maskless pair's window holds a NaN
        assert (tbl & near[None]).any(), f"lookup {lk}"
        kw = dict(cellsize=2.0, lookup_pixels=lk, fast=fast)
        for a, b in zip(cs.directional_extrema_torch(Zt, route="dynamic",
                                                     **kw),
                        cs.directional_extrema_torch(Zt, **kw)):
            assert torch.equal(a, b)
        for route in ("dynamic", "static"):
            a = cs.openness_counts_torch(Zt, threshold_angle=1.0,
                                         route=route, **kw)
            b = cs.openness_counts_torch(Zt, threshold_angle=1.0, **kw)
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_wrongly_safe_pair_shows_in_routed_plain():
    """The routed plain version is a real check: a table that marks every
    pair safe (edge blocks too) changes the extrema, since the maskless
    body then reads +inf off the array and skips the epilogue."""
    Z = _raster((40, 70), 7)
    Zt = torch.from_numpy(Z)
    kw = dict(cellsize=2.0, lookup_pixels=5, fast=False, how_fast=20)
    everywhere = torch.ones((8, *cs._grid(*Z.shape)), dtype=torch.bool)
    for (d, mx, mn), (_, pmx, pmn) in zip(
            cs._ladder_extrema(Zt, safe=everywhere, **kw),
            cs._ladder_extrema(Zt, **kw)):
        assert not torch.equal(mx, pmx) or not torch.equal(mn, pmn), d


# ----------------------------------------------------------------------
# (c) routed plain versions against the JAX static plan
# ----------------------------------------------------------------------
def _counts_all_routes(Z, **kw):
    Zt = torch.from_numpy(Z)
    return [cs.openness_counts_torch(Zt, route=route, **kw)
            for route in (None, "dynamic", "static")]


@pytest.mark.parametrize("fast", [False, True])
def test_9patch_counts_match_jax(fast):
    """tests/test_pallas.py::test_9patch_specialization_matches_dynamic:
    130 x 260, a NaN hole in a geometrically safe tile, lookup 12."""
    rng = np.random.default_rng(11)
    Z = rng.normal(size=(130, 260)).cumsum(axis=1).astype(np.float32)
    Z[60:64, 120:130] = np.nan
    kw = dict(cellsize=3.0, lookup_pixels=12, threshold_angle=1.0,
              fast=fast)
    jp, jn = jps.openness_counts_pallas(Z, tile=(40, 128), specialize=True,
                                        **kw)
    for np_, nn_ in _counts_all_routes(Z, **kw):
        np.testing.assert_array_equal(np_.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(nn_.numpy(), np.asarray(jn))


def test_9patch_reductions_match_jax():
    """tests/test_pallas.py::test_9patch_fused_reductions_match_dynamic:
    96 x 260, lookup 10, the three modes of the fused reduction."""
    rng = np.random.default_rng(13)
    Z = (rng.random((96, 260)) * 100).astype(np.float32)
    Z[40:44, 100:110] = np.nan
    Zt = torch.from_numpy(Z)
    kw = dict(cellsize=2.0, lookup_pixels=10)
    jpos, jneg = jps.openness_pallas(Z, tile=(32, 128), specialize=True, **kw)
    jsvf = jps.skyview_pallas(Z, tile=(32, 128), specialize=True, **kw)
    jcode = jps.ternary_pallas(Z, threshold_angle=1.0, tile=(32, 128),
                               specialize=True, **kw)
    for route in (None, "dynamic", "static"):
        pos, neg = cs.openness_degrees(*cs.openness_reduced_torch(
            Zt, "openness", route=route, **kw))
        for ours, ref in ((pos, jpos), (neg, jneg)):
            ref = np.asarray(ref)
            np.testing.assert_array_equal(np.isinf(ours.numpy()),
                                          np.isinf(ref))
            np.testing.assert_allclose(ours.numpy(), ref,
                                       atol=OPENNESS_ATOL, rtol=0)
        (s,) = cs.openness_reduced_torch(Zt, "svf", route=route, **kw)
        np.testing.assert_allclose(cs.skyview_from_sum(s).numpy(),
                                   np.asarray(jsvf), atol=SVF_ATOL, rtol=0)
        (code,) = cs.openness_reduced_torch(Zt, "ternary",
                                            threshold_angle=1.0,
                                            route=route, **kw)
        np.testing.assert_array_equal(code.int().numpy(),
                                      np.asarray(jcode).astype(np.int32))


def test_nan_hole_in_safe_block_matches_jax():
    """tests/test_pallas.py::test_nan_hole_in_safe_tile: a hole deep in
    the interior, lookup 2.  The JAX maskless body propagates NaN, so its
    plan masks the hole's tiles; the port's maskless body skips a NaN read
    (``fmaxf`` / ``torch.fmax``), so the hole's blocks stay maskless and
    every class still equals the JAX one."""
    rng = np.random.default_rng(5)
    Z = rng.normal(size=(640, 640)).cumsum(axis=0).astype(np.float32)
    Z[200:210, 300:320] = np.nan
    kw = dict(cellsize=2, lookup_pixels=2)
    ref = np.asarray(jps.geomorphons_pallas(Z, tile=(64, 128),
                                            specialize=True, **kw))
    for counts in _counts_all_routes(Z, threshold_angle=1, **kw):
        np.testing.assert_array_equal(
            tvis.classes_from_counts(*counts).numpy(), ref)
    # the hole's blocks really take the maskless body, as most others do
    tbl = cs.route_table(torch.from_numpy(Z), 2, specialize=True)
    assert tbl[:, 200 // 8, 300 // 32].all()
    assert float(tbl.float().mean()) > 0.8


def test_9patch_single_region_degenerate_matches_jax():
    """tests/test_pallas.py::test_9patch_single_region_degenerate: a
    raster smaller than one ladder reach, every block all masked."""
    rng = np.random.default_rng(12)
    Z = rng.normal(size=(24, 40)).cumsum(axis=0).astype(np.float32)
    kw = dict(cellsize=1.0, lookup_pixels=30)
    jp, jn = jps.openness_counts_pallas(Z, tile=(24, 128), specialize=True,
                                        **kw)
    for np_, nn_ in _counts_all_routes(Z, **kw):
        np.testing.assert_array_equal(np_.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(nn_.numpy(), np.asarray(jn))
    assert not cs.plan_safe(24, 40, 30).any()


def test_routed_extrema_and_block_counts_equal_plain():
    """K3 (whole raster and origin entry) and K4 on the dynamic route, in
    plain ops: equal to the unrouted plain versions (extrema by value)."""
    Z = _raster((150, 233), 3, [np.s_[70:74, 100:130]])
    H, W = Z.shape
    Zt = torch.from_numpy(Z)
    kw = dict(cellsize=2.0, lookup_pixels=7)
    for a, b in zip(cs.directional_extrema_torch(Zt, route="dynamic", **kw),
                    cs.directional_extrema_torch(Zt, **kw)):
        assert torch.equal(a, b)
    lk = 7
    Zp = np.pad(Z, lk, constant_values=np.nan)
    for (oy, ox) in ((0, 0), (40, 60), (75, 116)):
        blk = torch.from_numpy(np.ascontiguousarray(
            Zp[oy:oy + 75 + 2 * lk, ox:ox + 117 + 2 * lk]))
        org = dict(origin=(oy - lk, ox - lk), global_shape=(H, W))
        for a, b in zip(
                cs.directional_extrema_torch(blk, route="dynamic", **org,
                                             **kw),
                cs.directional_extrema_torch(blk, **org, **kw)):
            assert torch.equal(a, b)
        args = (blk, (oy, ox), (H, W), lk)
        for fast in (False, True):
            a = cs.openness_counts_block_torch(*args, fast=fast,
                                               route="dynamic")
            b = cs.openness_counts_block_torch(*args, fast=fast)
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="whole rasters"):
        cs.openness_counts_block_torch(blk, (0, 0), (H, W), lk,
                                       route="static")


# ----------------------------------------------------------------------
# (d) the public entry point
# ----------------------------------------------------------------------
def test_openness_pair_specialize_changes_nothing_on_cpu():
    Z = _raster((90, 130), 4, [np.s_[40:44, 60:70]])
    outs = [tvis.openness_pair(Z, cellsize=2, lookup_pixels=9,
                               specialize=spec, device="cpu")
            for spec in (None, True, False)]
    for pos, neg in outs[1:]:
        assert torch.equal(pos, outs[0][0]) and torch.equal(neg, outs[0][1])


# ----------------------------------------------------------------------
# both routes of the kernels against the plain version, on the card only
# ----------------------------------------------------------------------
@pytest.fixture
def card_raster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    Z = _raster((257, 389), 3, [np.s_[100:120, 40:90], np.s_[180, 200]])
    return torch.from_numpy(Z).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("lookup,fast", [(1, False), (12, False),
                                         (23, True), (300, False)])
def test_counts_routes_match_plain_on_card(card_raster, lookup, fast):
    kw = dict(cellsize=2.0, lookup_pixels=lookup, threshold_angle=1.0,
              fast=fast)
    plain = cs.openness_counts_torch(card_raster, **kw)
    for fn in (cs.openness_counts_cuda, cs.openness_counts_plan_cuda):
        got = fn(card_raster, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["openness", "svf", "ternary"])
def test_reduced_routes_match_plain_on_card(card_raster, mode):
    kw = dict(cellsize=2.0, lookup_pixels=23, threshold_angle=1.0)
    dyn = cs.openness_reduced_cuda(card_raster, mode, **kw)
    stat = cs.openness_reduced_plan_cuda(card_raster, mode, **kw)
    plain = cs.openness_reduced_torch(card_raster, mode, **kw)
    torch.cuda.synchronize()
    if mode == "openness":  # in degrees, as the tolerance is stated
        dyn, stat, plain = (cs.openness_degrees(*o) for o in (dyn, stat,
                                                              plain))
    for a, b, c in zip(dyn, stat, plain):
        if mode == "ternary":
            assert torch.equal(a.int(), b.int())
            assert torch.equal(a.int(), c.int())
        else:
            assert torch.equal(a, b)
            torch.testing.assert_close(
                a, c, rtol=0,
                atol=5e-5 if mode == "openness" else SVF_ATOL)
