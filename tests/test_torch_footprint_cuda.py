"""Footprint statistics as one kernel launch
(``neilpy_tpu_torch/ops/surface.py``: ``binary_footprint_sum``,
``_footprint_cuda``, ``_footprint_sum_torch``, ``_footprint_plan``;
``ops/stats.py``: ``rasterGi``, ``_raster_gi_cuda``, ``_raster_gi_torch``,
``_footprint_gi_cuda``; ``csrc/footprint_sum.cu``).

On the CPU: the table the wrappers build from a footprint holds its runs
as ``_runs`` lists them, split into bands where a table is full; a numpy
model of the kernel's walk over that table (tiles, staged batches,
partial levels, pieces, bands) equals the plain version bit for bit; the
wrappers refuse what the kernel does not take; a CPU tensor takes the
plain versions (the ``stats.rasterGi`` span's ``path`` reads ``torch``)
and launches nothing; and the reader of ``footprint.gi_kernel_pct``.
The ``cuda`` tests hold the kernel to the plain version on the card bit
for bit (footprint sums, Z, P and bins); they need no JAX:
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_footprint_cuda.py -m cuda``.
"""

import json
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import neilpy_tpu_torch as ntt
from neilpy_tpu_torch import profiling
from neilpy_tpu_torch.ops import stats, surface

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
SMEM = 232_448  # an H100's opt-in shared memory a block


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def raster(shape, seed=0, device=CPU):
    """A terrain-like float32 raster (a 2-D random walk) with NaN voids,
    an infinity and a patch of -0.0, where the shape allows."""
    rng = np.random.default_rng(seed)
    Z = (rng.normal(size=shape).cumsum(0).cumsum(1) * 0.1).astype(np.float32)
    H, W = shape
    if H >= 8 and W >= 8:
        Z[H // 3:H // 3 + max(1, H // 9), W // 4:W // 4 + max(1, W // 7)] = \
            np.nan
        Z[rng.integers(0, H, 9), rng.integers(0, W, 9)] = np.nan
        Z[H - 2, 1] = np.inf
        Z[1:4, W - 5:W - 1] = -0.0
    return torch.from_numpy(Z).to(device)


def ring(r_out, r_in):
    return np.asarray(ntt.disk(r_out)) & ~np.pad(
        np.asarray(ntt.disk(r_in)), r_out - r_in).astype(bool)


def box7(centre):
    fp = np.ones((7, 7), bool)
    fp[3, 3] = centre
    return fp


FOOTPRINTS = {**{f"disk{r}": ntt.disk(r) for r in range(14)},
              "box7": box7(True), "box7_no_centre": box7(False),
              "ring": ring(6, 3), "empty": np.zeros((5, 5), bool),
              "asymmetric": np.array([[0, 0, 0, 1, 1], [0, 0, 0, 0, 0],
                                      [1, 0, 1, 0, 0], [0, 0, 0, 0, 0]],
                                     bool)}


# ----------------------------------------------------------------------
# the table
# ----------------------------------------------------------------------
def decode(fp, plan):
    """The runs and pieces a plan holds, in the kernel's reading order:
    [(footprint row, c0, width)], [(footprint row, [(log2 width,
    offset)])]."""
    kh, kw = np.shape(fp)
    runs, pieces = [], []
    for band in plan:
        rows, row0, col0, n, cs, levels = (int(v) for v in band["head"][:6])
        assert col0 == -(kw // 2)
        start, piece = band["start"], band["piece"]
        assert len(start) == rows + 1 and start[-1] == len(piece)
        assert int(band["head"][8]) == len(piece)
        for r in range(rows):
            dr = row0 + kh // 2 + r
            run = []
            for e in piece[start[r]:start[r + 1]].tolist():
                word = e & ~surface._FS_LAST
                assert word % cs == 0
                lv, off = divmod(word // cs, n)
                assert lv < levels and off + (1 << lv) <= n
                run.append((lv, off))
                if e & surface._FS_LAST:
                    c0 = run[0][1]
                    width = sum(1 << lv for lv, _ in run)
                    # the pieces tile the run left to right, widest first
                    offs = [c0 + sum(1 << lv for lv, _ in run[:i])
                            for i in range(len(run))]
                    assert [off for _, off in run] == offs
                    assert [lv for lv, _ in run] == sorted(
                        {lv for lv, _ in run}, reverse=True)
                    runs.append((dr, c0, width))
                    pieces.append((dr, run))
                    run = []
            assert run == []
    return runs, pieces


@pytest.mark.parametrize("name", sorted(FOOTPRINTS))
def test_the_table_holds_the_runs_in_order(name):
    fp = np.asarray(FOOTPRINTS[name]) != 0
    plan = surface._footprint_plan(fp, SMEM)
    runs, pieces = decode(fp, plan)
    assert runs == surface._runs(fp)
    assert pieces == [(dr, surface._run_pieces(c0, w))
                      for dr, c0, w in surface._runs(fp)]
    assert len(plan) == 1
    head = [int(v) for v in plan[0]["head"]]
    span = max((c0 + w for _, c0, w in runs), default=1)
    wmax = max((w for _, _, w in runs), default=1)
    n, cs, levels, rb = head[3:7]
    assert n == surface._FS_COLS + span - 1
    assert levels == wmax.bit_length()
    # the tile's whole window in one batch where it fits; an odd stride
    nr = surface._FS_ROWS + head[0] - 1 if runs else 1
    assert cs == rb | 1 and rb == nr
    assert plan[0]["smem"] == surface._fs_smem(levels, n, rb, nr) == 4 * (
        2 * surface._FS_GUARD + levels * n * cs + rb * n)
    assert plan[0]["smem"] <= surface._FS_SMEM_TARGET
    assert head[7] == int(fp.sum())
    if runs:
        # the rows before the first run and after the last are left out
        used = sorted({dr for dr, _, _ in runs})
        assert head[0] == used[-1] - used[0] + 1
        assert head[1] == used[0] - fp.shape[0] // 2
    else:
        assert head[0] == 0 and plan[0]["piece"].size == 0


def test_the_plan_is_cached_per_footprint_and_device_limit():
    fp = np.asarray(ntt.disk(5)) != 0
    first = surface._footprint_plan(fp, SMEM)
    assert surface._footprint_plan(fp.copy(), SMEM) is first
    assert surface._footprint_plan(fp.astype(np.float32) != 0,
                                   SMEM) is first
    assert surface._footprint_plan(fp, SMEM - 1) is not first


def test_a_window_past_the_target_is_staged_in_batches():
    """disk 40's 81 rows: 112 input rows a tile do not fit in one batch;
    the batch is the most rows that fit with two raw buffers."""
    fp = np.asarray(ntt.disk(40)) != 0
    (band,) = surface._footprint_plan(fp, SMEM)
    head = [int(v) for v in band["head"]]
    n, cs, levels, rb = head[3:7]
    nr = surface._FS_ROWS + 81 - 1
    assert rb < nr and cs == rb | 1
    assert band["smem"] == surface._fs_smem(levels, n, rb, nr) == 4 * (
        2 * surface._FS_GUARD + levels * n * cs + 2 * rb * n)
    assert band["smem"] <= surface._FS_SMEM_TARGET
    assert surface._fs_smem(levels, n, rb + 1, nr) > surface._FS_SMEM_TARGET


@pytest.mark.parametrize("case", ["rows", "pieces"])
def test_a_footprint_past_one_table_runs_in_row_bands(case):
    """600 rows: bands of 256, 256 and 88 rows; 60 pieces a row: bands of
    12 rows (720 pieces) until the last."""
    if case == "rows":
        fp = np.ones((600, 3), bool)
        fp[::7, 0] = False
        sizes = [256, 256, 88]
    else:
        fp = np.zeros((40, 119), bool)
        fp[:, ::2] = True   # 60 runs of one column a row
        sizes = [12, 12, 12, 4]
    plan = surface._footprint_plan(fp, SMEM)
    assert [int(b["head"][0]) for b in plan] == sizes
    firsts = np.cumsum([0] + sizes[:-1]) - fp.shape[0] // 2
    assert [int(b["head"][1]) for b in plan] == firsts.tolist()
    assert all(b["piece"].size <= surface._FS_MAX_PIECES for b in plan)
    assert decode(fp, plan)[0] == surface._runs(fp)
    assert sum(int(b["head"][7]) for b in plan) == int(fp.sum())


@pytest.mark.parametrize("name,const", [
    ("kCols", "_FS_COLS"), ("kRows", "_FS_ROWS"), ("kGroups", None),
    ("kPer", None), ("kMaxRows", "_FS_MAX_ROWS"),
    ("kMaxPieces", "_FS_MAX_PIECES"), ("kGuard", "_FS_GUARD")])
def test_the_host_and_the_kernel_share_the_tiling(name, const):
    """The plan lays out what csrc/footprint_sum.cu reads: its constants
    here, the numpy model's row groups and rows a thread."""
    src = (Path(surface.__file__).parents[1] / "csrc"
           / "footprint_sum.cu").read_text()
    consts = {k: v for k, v in re.findall(
        r"constexpr int (k\w+) = ([\w *]+);", src)}
    value = eval(consts[name], {}, {k: eval(v, {}, {})
                                    for k, v in consts.items()
                                    if v.isdigit()})
    want = {"kGroups": GROUPS, "kPer": PER}.get(name)
    assert value == (getattr(surface, const) if const else want)
    assert re.search(r"kLast = 1u << 31;", src)
    assert surface._FS_LAST == 1 << 31


@pytest.mark.parametrize("fp,what", [
    (np.ones((3, surface._FS_MAX_SPAN + 1), bool), "spans 2049 columns"),
    (np.ones((3, 2000), bool), "shared memory")])
def test_a_footprint_the_kernel_cannot_take_raises(fp, what):
    with pytest.raises(ValueError, match=what):
        surface._footprint_plan(fp, 100_000)


# ----------------------------------------------------------------------
# the kernel's walk, modelled in numpy
# ----------------------------------------------------------------------
GROUPS, PER = 8, 4  # csrc/footprint_sum.cu: kGroups, kPer
TILE_ROWS = GROUPS * PER


def source(c, n, reflect):
    if reflect:
        k = c % (2 * n)
        return k if k < n else 2 * n - 1 - k
    return min(max(c, 0), n - 1)


def kernel_model(X, fp, mode, channels=1):
    """What ``footprint_sum_launch`` (one channel: the sums of X) or the
    two-channel kernel (the sums of X where finite, and the finite counts)
    computes, band by band, tile by tile, batch by batch, as the kernel
    walks the table over its column-major partials: each row group's
    footprint rows d0 <= dr < d1 of a batch, each piece serving the
    group's rows whose input row is staged; the non-finite indicator built
    and read only in batches that have a non-finite pixel (float32 adds in
    numpy; a staged entry no level builds reads NaN, so a read past what
    was built shows)."""
    X = X.numpy()
    H, W = X.shape
    reflect = mode == "reflect"
    cols = surface._FS_COLS
    out, count = np.zeros((H, W), np.float32), np.zeros((H, W), np.float32)
    for k, band in enumerate(surface._footprint_plan(fp, SMEM)):
        rows, row0, col0, n, cs, levels, rb, cells, _ = (
            int(v) for v in band["head"])
        start, piece = band["start"], band["piece"]
        prev, prev_count = out.copy(), count.copy()
        for i0 in range(0, H, TILE_ROWS):
            for j0 in range(0, W, cols):
                acc = np.zeros((TILE_ROWS, cols), np.float32)
                cnt = np.zeros((TILE_ROWS, cols), np.float32)
                if k:
                    for a, b in ((acc, prev), (cnt, prev_count)):
                        tile = b[i0:i0 + TILE_ROWS, j0:j0 + cols]
                        a[:tile.shape[0], :tile.shape[1]] = tile
                cnt += np.float32(cells)
                nr = TILE_ROWS + rows - 1 if rows else 0
                xc = [source(j0 + c + col0, W, reflect) for c in range(n)]
                tx = np.arange(cols) * cs
                for b0 in range(0, nr, rb):
                    nrows = min(rb, nr - b0)
                    raw = X[[source(i0 + b0 + r + row0, H, reflect)
                             for r in range(nrows)]][:, xc]
                    val = np.full((levels, n, cs), np.nan, np.float32)
                    ind = np.full((levels, n, cs), np.nan, np.float32)
                    fin = np.isfinite(raw)
                    val[0, :, :nrows] = (np.where(fin, raw, 0) if channels
                                         == 2 else raw).T
                    ind[0, :, :nrows] = (~fin).T
                    voids = channels == 2 and not fin.all()
                    for lv in range(1, levels):
                        half, cnt_c = 1 << (lv - 1), n - (1 << lv) + 1
                        for a in (val, ind) if voids else (val,):
                            a[lv, :cnt_c, :nrows] = (
                                a[lv - 1, :cnt_c, :nrows]
                                + a[lv - 1, half:half + cnt_c, :nrows])
                    fval, find = val.reshape(-1), ind.reshape(-1)
                    for ty in range(GROUPS):
                        base = ty * PER - b0
                        for dr in range(max(0, -base - PER + 1),
                                        min(rows, nrows - base)):
                            s = base + dr
                            ok = [0 <= s + u < nrows for u in range(PER)]
                            run = [np.float32(0)] * PER
                            fresh = True
                            for e in piece[start[dr]:start[dr + 1]].tolist():
                                word = e & ~surface._FS_LAST
                                last = bool(e & surface._FS_LAST)
                                for u in range(PER):
                                    if not ok[u]:
                                        continue
                                    v = fval[word + tx + s + u]
                                    run[u] = (np.float32(0) if fresh
                                              else run[u]) + v
                                    if last:
                                        t = ty * PER + u
                                        acc[t] = acc[t] + run[u]
                                    if voids:
                                        t = ty * PER + u
                                        cnt[t] = cnt[t] - find[word + tx
                                                               + s + u]
                                fresh = last
                for a, b in ((out, acc), (count, cnt)):
                    tile = a[i0:i0 + TILE_ROWS, j0:j0 + cols]
                    tile[...] = b[:tile.shape[0], :tile.shape[1]]
    return torch.from_numpy(out), torch.from_numpy(count)


MODEL_CASES = [("disk5", (40, 150)), ("disk13", (37, 130)),
               ("box7_no_centre", (33, 260)), ("ring", (5, 7)),
               ("asymmetric", (34, 129)), ("empty", (9, 9)),
               ("disk3", (1, 1))]


@pytest.fixture(params=["window", "batches"])
def staging(request, monkeypatch):
    """The tile's whole window in one batch (the plan's choice here), or in
    batches of a few rows (a shared-memory target the window passes)."""
    if request.param == "batches":
        monkeypatch.setattr(surface, "_FS_SMEM_TARGET", 40_000)
    surface._plan_cached.cache_clear()
    yield request.param
    surface._plan_cached.cache_clear()


@pytest.mark.parametrize("mode", ["nearest", "reflect"])
@pytest.mark.parametrize("name,shape", MODEL_CASES)
def test_the_kernels_walk_equals_the_plain_version(name, shape, mode,
                                                    staging):
    fp = np.asarray(FOOTPRINTS[name]) != 0
    head = surface._footprint_plan(fp, SMEM)[0]["head"]
    nr = surface._FS_ROWS + int(head[0]) - 1 if head[0] else 1
    assert (int(head[6]) == nr) == (staging == "window" or name == "empty")
    X = raster(shape, seed=len(name))
    X0 = torch.where(torch.isfinite(X), X, 0.0)  # a NaN read would show
    got = kernel_model(X0, fp, mode)[0]
    want = surface._footprint_sum_torch(X0, fp, mode)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # two channels: the values where finite, and the finite counts
    values, counts = kernel_model(X, fp, mode, channels=2)
    assert torch.equal(values.view(torch.int32), want.view(torch.int32))
    assert torch.equal(counts, surface._footprint_sum_torch(
        torch.isfinite(X).float(), fp, mode))


@pytest.mark.parametrize("mode", ["nearest", "reflect"])
def test_the_kernels_walk_over_row_bands_equals_the_plain_version(
        monkeypatch, mode):
    """Tables of 4 rows and 9 pieces: a 13-row footprint in several bands,
    each adding to the sums and counts the band before stored."""
    monkeypatch.setattr(surface, "_FS_MAX_ROWS", 4)
    monkeypatch.setattr(surface, "_FS_MAX_PIECES", 9)
    surface._plan_cached.cache_clear()
    try:
        fp = ring(6, 2)
        plan = surface._footprint_plan(fp, SMEM)
        assert len(plan) >= 4
        assert all(int(b["head"][0]) <= 4 and b["piece"].size <= 9
                   for b in plan)
        X = raster((45, 140), 3)
        X0 = torch.where(torch.isfinite(X), X, 0.0)
        want = surface._footprint_sum_torch(X0, fp, mode)
        got = kernel_model(X0, fp, mode)[0]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        values, counts = kernel_model(X, fp, mode, channels=2)
        assert torch.equal(values.view(torch.int32), want.view(torch.int32))
        assert torch.equal(counts, surface._footprint_sum_torch(
            torch.isfinite(X).float(), fp, mode))
    finally:
        surface._plan_cached.cache_clear()


# ----------------------------------------------------------------------
# the wrappers' refusals and the CPU dispatch
# ----------------------------------------------------------------------
REFUSED = [(torch.zeros(8, 8, dtype=torch.float64), "float32"),
           (torch.zeros(2, 8, 8), "2-D float32"),
           (torch.zeros(8, 9).T, "contiguous"),
           (torch.zeros(8, 8), "CUDA tensor")]


@pytest.mark.parametrize("which", ["sum", "gi"])
@pytest.mark.parametrize("case", range(len(REFUSED)))
def test_the_kernel_wrappers_refuse_what_they_do_not_take(which, case):
    X, what = REFUSED[case]
    fp = np.asarray(ntt.disk(2)) != 0
    before = (surface._footprint_cuda.launches,
              stats._footprint_gi_cuda.launches)
    with pytest.raises(ValueError, match=what):
        if which == "sum":
            surface._footprint_cuda(X, fp)
        else:
            s = torch.zeros(())
            stats._footprint_gi_cuda(X, fp, "nearest", True, s, s, s)
    assert (surface._footprint_cuda.launches,
            stats._footprint_gi_cuda.launches) == before


def test_an_unknown_mode_raises_on_both_paths():
    X = raster((9, 9))
    with pytest.raises(ValueError, match="unsupported mode"):
        surface._reflect("wrap")
    with pytest.raises(ValueError, match="unsupported mode"):
        surface.binary_footprint_sum(X, ntt.disk(1), mode="wrap", device=CPU)


def test_cpu_tensors_take_the_plain_versions():
    X = raster((40, 50), seed=4)
    launches = (surface._footprint_cuda.launches,
                stats._footprint_gi_cuda.launches)
    got = surface.binary_footprint_sum(X, ntt.disk(3), device=CPU)
    fp = np.asarray(ntt.disk(3)) != 0
    assert same_bits(got, surface._footprint_sum_torch(X, fp, "nearest"))
    with _profile():
        pass
    profiling.clear_spans()
    with _profile():
        Z, P, sig = ntt.rasterGi(X, ntt.disk(2), star=True, device=CPU)
        mask = ntt.shi_landslides(X, (2, 3), 10, device=CPU)
    gi = [s for s in profiling.spans() if s.name == "stats.rasterGi"]
    assert [s.attr["path"] for s in gi] == ["torch"] * 3
    assert [s.attr["star"] for s in gi] == [True] * 3
    want = stats._raster_gi_torch(X, np.asarray(ntt.disk(2)) != 0,
                                  "nearest", False, True, None, None, None)
    for g, w in zip((Z, P, sig), want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert mask.dtype == torch.bool and mask.shape == X.shape
    assert (surface._footprint_cuda.launches,
            stats._footprint_gi_cuda.launches) == launches


# ----------------------------------------------------------------------
# footprint.gi_kernel_pct
# ----------------------------------------------------------------------
MS = 1_000_000
METRIC = "footprint.gi_kernel_pct"


def reader():
    from portbench import harness
    return harness.load_module(harness.BASE / "metrics" / f"{METRIC}.py",
                               f"portbench.metrics.{METRIC}").read


def span(name, t, sid, attr):
    return types.SimpleNamespace(name=name, start_ns=t * MS,
                                 end_ns=(t + 1) * MS, id=sid, parent=None,
                                 root=sid, device_ms=1.0, attr=attr,
                                 thread="MainThread")


def gi(path, t, sid):
    attr = {"footprint": (11, 11), "star": True}
    if path:
        attr["path"] = path
    return span("stats.rasterGi", t, sid, attr)


@pytest.mark.parametrize("paths,want", [
    (["cuda", "cuda", "cuda", "cuda"], 100.0),
    (["cuda", "torch", "cuda", "cuda"], 75.0),
    (["torch", "torch"], 0.0),
    ([None, None], None)])
def test_the_gi_kernel_share_reader(monkeypatch, paths, want):
    from portbench import harness
    read = reader()
    spans = [gi(p, 2 * i, i + 1) for i, p in enumerate(paths)]
    # outside the window, and a span of another name, count for nothing
    spans += [gi("torch", 500, 90),
              span("surface.hillshade", 3, 91, None)]
    trace = types.SimpleNamespace(window=(0, 100 * MS), jobs=[(0, 10 * MS)])
    run = harness.Run(jobs=[], trace=trace)
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    got = read(run)
    assert got == (None if want is None else pytest.approx(want))
    assert read(harness.Run(jobs=[], trace=None)) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(run) is None


def test_the_manifest_appends_the_gi_kernel_share():
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    # later metrics may follow it
    (entry,) = [m for m in man["per_layer"] if m["name"] == METRIC]
    assert man["per_layer"].index(entry) == 34 and entry == {
        "name": METRIC, "unit": "%", "better": "higher",
        "source": "program_span", "layer": "footprint statistics",
        "moves": "raster_mpix_s", "workloads": ["dem_products.resident"]}
    assert [m["name"] for m in man["per_layer"]].count(METRIC) == 1


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


CARD_FOOTPRINTS = ["disk5", "disk13", "box7", "ring"]
CARD_SHAPES = [(1, 1), (7, 8193), (4196, 4196)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("mode", ["nearest", "reflect"])
@pytest.mark.parametrize("name", CARD_FOOTPRINTS)
def test_footprint_sum_kernel_equals_plain_on_card(card, name, mode, shape):
    fp = np.asarray(FOOTPRINTS[name]) != 0
    X = raster(shape, seed=sum(shape), device=card)
    for x in (X, torch.where(torch.isfinite(X), X, 0.0)):
        launches = surface._footprint_cuda.launches
        got = surface.binary_footprint_sum(x, fp, mode=mode)
        torch.cuda.synchronize(card)
        assert surface._footprint_cuda.launches == launches + 1
        assert same_bits(got, surface._footprint_sum_torch(x, fp, mode))


GI_CARD = [dict(footprint="disk5", star=True),
           dict(footprint="disk13", star=True),
           dict(footprint="disk13", star=True, mode="reflect"),
           dict(footprint=2, star=False),
           dict(footprint="box7_no_centre"),
           dict(footprint="ring", star=True, apply_correction=True),
           dict(footprint=3, star=False, apply_correction=True),
           dict(footprint=3, star=True, global_mean=3.0, global_var=40.0,
                global_n=5000),
           dict(footprint="disk5", star=True, global_mean="t",
                global_var="t", global_n="t")]


def gi_kwargs(case, X):
    kw = dict(case)
    if isinstance(kw["footprint"], str):
        kw["footprint"] = FOOTPRINTS[kw["footprint"]]
    if kw.get("global_mean") == "t":
        fin = X[torch.isfinite(X)]
        kw.update(global_mean=fin.mean(), global_var=fin.var() * 1.5,
                  global_n=(fin.numel() * 1.1) * torch.ones((), device=X.device))
    return kw


def p_and_bins_within_an_ulp(got, want):
    """(P pixels one ulp off, bin pixels off); P off by one ulp at most,
    a bin off only where P lies within an ulp of .1, .05 or .01."""
    (gz, gp, gs), (wz, wp, ws) = got, want
    dp = (gp.view(torch.int32).long() - wp.view(torch.int32).long()).abs()
    nanp = torch.isnan(gp) & torch.isnan(wp)
    assert bool(((dp <= 1) | nanp).all())
    off = ~((gs == ws) | (torch.isnan(gs) & torch.isnan(ws)))
    for e in (.1, .05, .01):
        ulp = float(np.spacing(np.float32(e)))
        off &= ~((wp - e).abs() <= 2 * ulp)
    assert not bool(off.any())
    return int(((dp > 0) & ~nanp).sum()), int((gs.view(torch.int32)
                                               != ws.view(torch.int32)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (7, 8193), (1023, 1537)])
@pytest.mark.parametrize("case", range(len(GI_CARD)))
def test_rastergi_kernel_equals_plain_on_card(card, case, shape):
    X = raster(shape, seed=case, device=card)
    kw = gi_kwargs(GI_CARD[case], X)
    launches = (surface._footprint_cuda.launches,
                stats._footprint_gi_cuda.launches)
    got = ntt.rasterGi(X, **kw)
    torch.cuda.synchronize(card)
    assert (surface._footprint_cuda.launches,
            stats._footprint_gi_cuda.launches) == (launches[0],
                                                   launches[1] + 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stats, "_raster_gi_cuda", stats._raster_gi_torch)
        want = ntt.rasterGi(X, **kw)
    assert stats._footprint_gi_cuda.launches == launches[1] + 1
    assert same_bits(got[0], want[0])
    p_and_bins_within_an_ulp(got, want)


@pytest.mark.cuda
def test_shi_landslides_through_the_kernel_equals_plain_on_card(card):
    """The cell's call on an 8192^2 DEM with voids: two Gi* launches, the
    mask, Z, P and bins of each radius as the plain version's."""
    X = raster((8192, 8192), seed=11, device=card) * 40.0
    launches = stats._footprint_gi_cuda.launches
    mask = ntt.shi_landslides(X, (5, 13), 10)
    torch.cuda.synchronize(card)
    assert stats._footprint_gi_cuda.launches == launches + 2
    ktan = ntt.evans_curvature(X, 10)[3]
    p_off = 0
    for r in (5, 13):
        fp = np.asarray(ntt.disk(r)) != 0
        got = ntt.rasterGi(ktan, fp, star=True)
        want = stats._raster_gi_torch(ktan, fp, "nearest", False, True,
                                      None, None, None)
        assert same_bits(got[0], want[0])
        p_off += p_and_bins_within_an_ulp(got, want)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stats, "_raster_gi_cuda", stats._raster_gi_torch)
        plain = ntt.shi_landslides(X, (5, 13), 10)
    if p_off == 0:
        assert torch.equal(mask, plain)
    else:
        assert float((mask != plain).double().mean()) < 1e-6


@pytest.mark.cuda
def test_row_bands_equal_plain_on_card(card):
    """A 601-row footprint: three launches, each band adding to the one
    before, for the sum and for Gi."""
    fp = np.ones((601, 5), bool)
    fp[::3, 1] = False
    X = raster((700, 300), seed=5, device=card)
    launches = surface._footprint_cuda.launches
    got = surface.binary_footprint_sum(X, fp)
    assert surface._footprint_cuda.launches == launches + 3
    assert same_bits(got, surface._footprint_sum_torch(X, fp, "nearest"))
    launches = stats._footprint_gi_cuda.launches
    got = ntt.rasterGi(X, fp, mode="reflect")
    assert stats._footprint_gi_cuda.launches == launches + 3
    want = stats._raster_gi_torch(X, fp, "reflect", False, True, None, None,
                                  None)
    assert same_bits(got[0], want[0])
    p_and_bins_within_an_ulp(got, want)


@pytest.mark.cuda
def test_moran_and_the_sharded_gi_run_the_sum_kernel_on_card(card):
    X = raster((600, 700), seed=6, device=card)
    launches = surface._footprint_cuda.launches
    lag = ntt.local_morans_i(X, 3)
    assert surface._footprint_cuda.launches == launches + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(surface, "_footprint_cuda", surface._footprint_sum_torch)
        want = ntt.local_morans_i(X, 3)
    assert same_bits(lag, want)
    mesh = ntt.dist.make_mesh([card] * 4)
    z, p, s = ntt.dist.sharded_rastergi(X, ntt.disk(5), mesh, star=True)
    assert surface._footprint_cuda.launches == launches + 1 + 2 * 4


@pytest.mark.cuda
def test_rastergi_makes_no_sync_with_device_moments_on_card(card):
    X = raster((512, 640), seed=8, device=card)
    fin = X[torch.isfinite(X)]
    kw = dict(star=True, global_mean=fin.mean(), global_var=fin.var(),
              global_n=torch.tensor(float(fin.numel()), device=card))
    ntt.rasterGi(X, ntt.disk(5), **kw)
    ntt.shi_landslides(X, (5, 13), 10)
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ntt.rasterGi(X, ntt.disk(5), **kw)
        ntt.shi_landslides(X, (5, 13), 10)
        surface.binary_footprint_sum(X, ntt.disk(13))
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_the_kernel_wrappers_refuse_on_card(card):
    fp = np.asarray(ntt.disk(2)) != 0
    s = torch.zeros((), device=card)
    before = (surface._footprint_cuda.launches,
              stats._footprint_gi_cuda.launches)
    with pytest.raises(ValueError, match="float32"):
        surface._footprint_cuda(torch.zeros(5, 5, device=card,
                                            dtype=torch.float64), fp)
    with pytest.raises(ValueError, match="contiguous"):
        surface._footprint_cuda(torch.zeros(5, 6, device=card).T, fp)
    with pytest.raises(ValueError, match="spans"):
        surface.binary_footprint_sum(torch.zeros(5, 5, device=card),
                                 np.ones((1, 3000)))
    with pytest.raises(ValueError, match="0-d float32"):
        stats._footprint_gi_cuda(torch.zeros(5, 5, device=card), fp,
                                 "nearest", True, s.double(), s, s)
    with pytest.raises(ValueError, match="0-d float32"):
        stats._footprint_gi_cuda(torch.zeros(5, 5, device=card), fp,
                                 "nearest", True, s.cpu(), s, s)
    assert (surface._footprint_cuda.launches,
            stats._footprint_gi_cuda.launches) == before
