"""The springs fill's conjugate gradients as CUDA graphs
(``neilpy_tpu_torch/ops/inpaint.py``: ``_cg_start``, ``_cg_step``,
``_SpringsGraphs``, ``_GraphCache``).

On the CPU: the shared iteration body, as ``_cg`` runs it and as the
fixed state of ``_SpringsGraphs`` runs it under ``_iterate``, gives the
bits, iterations and host syncs of the loop it replaced (a copy of which
is kept here); and only a multigrid fill on a CUDA device takes the
graphs.  The ``cuda`` tests hold the replays to the eager loop on the
card; they need no JAX: ``python3 -m pytest --noconftest -p
no:cacheprovider tests/test_torch_inpaint_graph.py -m cuda``.
"""

import threading

import numpy as np
import pytest
import torch

import neilpy_tpu_torch as ntt
from neilpy_tpu_torch import profiling
from neilpy_tpu_torch.dist.api import make_mesh
from neilpy_tpu_torch.ops import inpaint

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cg_before(apply_fn, b, x0, precond, tol, maxiter, flexible,
              check_every):
    """``inpaint._cg`` as it was before its body became ``_cg_step``, on
    one tensor: the reference of the tests below."""
    if precond is None:
        precond = lambda r: r
    bnorm = torch.sqrt(torch.sum(b * b))
    atol2 = (tol * torch.clamp_min(bnorm, 1e-30)) ** 2
    x = x0
    r = b - apply_fn(x0)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    it = torch.zeros((), dtype=torch.int64, device=bnorm.device)
    done = ~(torch.sum(r * r) > atol2)
    syncs = iterations = 0
    for n in range(1, int(maxiter) + 1):
        Ap = apply_fn(p)
        alpha = rz / torch.sum(p * Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = torch.sum(r_new * z)
        if flexible:
            beta = (rz_new - torch.sum(r * z)) / rz
        else:
            beta = rz_new / rz
        p_new = z + beta * p
        x = torch.where(done, x, x_new)
        r = torch.where(done, r, r_new)
        p = torch.where(done, p, p_new)
        rz = torch.where(done, rz, rz_new)
        it = it + (~done).to(it.dtype)
        done = done | ~(torch.sum(r * r) > atol2)
        if n % check_every == 0 or n == maxiter:
            syncs += 1
            stop, iterations = torch.stack([done.to(it.dtype), it]).tolist()
            if stop:
                break
    return x, iterations, syncs


def raster(shape, case, seed=0, dtype=torch.float32, device=CPU):
    """A test raster: ``holes`` a rough surface with two blocks and ~29%
    scattered cells unknown; ``flat`` a constant surface with a block
    unknown (the warm start is the answer: stops before the first
    iteration's check); ``none`` nothing unknown."""
    H, W = shape
    rng = np.random.default_rng(seed)
    if case == "flat":
        A = np.full(shape, 7.0)
    else:
        A = rng.normal(size=shape).cumsum(0).cumsum(1) * 0.1
    if case != "none":
        A[H // 5:H // 2, W // 6:W // 2] = np.nan
    if case == "holes":
        A[2 * H // 3:, 2 * W // 3:] = np.nan
        A[rng.random(shape) < 0.2] = np.nan
    return torch.from_numpy(A).to(device, dtype)


def system(A):
    """What ``_springs_core`` hands its CG: (apply_fn, b, x0, unknown,
    deg, nanmask)."""
    nanmask = torch.isnan(A)
    unknown = nanmask.to(A.dtype)
    known_vals = torch.where(nanmask, 0.0, A)
    deg = inpaint._degree(A.shape, dtype=A.dtype, device=A.device)

    def apply_fn(x):
        x = x * unknown
        return (deg * x - inpaint._neighbor_sum(x)) * unknown

    b = inpaint._neighbor_sum(known_vals * (1.0 - unknown)) * unknown
    mean = torch.nansum(known_vals) / torch.clamp_min(
        torch.sum(1.0 - unknown), 1.0)
    return apply_fn, b, unknown * mean, unknown, deg, nanmask


SHAPES = [(64, 64), (65, 130), (257, 193)]
CASES = [(s, c) for s in SHAPES for c in ("holes", "flat", "none")]


@pytest.mark.parametrize("shape,case", CASES,
                         ids=[f"{s[0]}x{s[1]}-{c}" for s, c in CASES])
def test_shared_body_on_fixed_state_equals_the_loop_it_replaced(shape,
                                                                 case):
    """The multigrid CG three ways on the CPU: the old loop, ``_cg`` over
    ``_cg_step``, and ``_SpringsGraphs``' fixed state driven eagerly by
    ``_iterate`` (what the graphs capture), bit for bit, with the same
    iterations and host syncs; ``_springs_core`` returns that fill."""
    A = raster(shape, case, seed=shape[0])
    apply_fn, b, x0, unknown, deg, nanmask = system(A)
    levels = inpaint._build_levels(unknown, deg)

    def precond(r):
        return inpaint._kcycle(r, levels, 0)

    check = inpaint.CHECK_EVERY_MULTIGRID
    x_old, it_old, syncs_old = cg_before(apply_fn, b, x0, precond, 1e-7,
                                         4000, True, check)
    x_new, it_new, syncs_new = inpaint._cg(apply_fn, b, x0, precond, 1e-7,
                                           4000, True, check)
    assert torch.equal(x_new, x_old)
    assert (it_new, syncs_new) == (it_old, syncs_old)

    g = inpaint._SpringsGraphs()
    g.load(unknown, deg, levels, b, x0, inpaint._atol2(b, 1e-7))
    g.start()
    it, syncs, steps = inpaint._iterate(g.step, lambda: g.flag, 4000, check)
    assert torch.equal(g.state[0], x_old)
    assert (it, syncs, steps) == (it_old, syncs_old, syncs_old)

    filled, info = inpaint._springs_core(A, 1e-7, 4000)
    assert torch.equal(filled, torch.where(nanmask, x_old, A))
    assert info == {"iterations": it_old, "host_syncs": syncs_old,
                    "graph": "eager", "replays": 0, "kcycle": "torch"}
    if case != "holes":
        assert it_old == 0 and syncs_old == 1
    else:
        assert it_old > 1


def test_fixed_state_takes_a_new_mask_of_its_shape():
    """A second ``load`` of the same fixed tensors (a new mask, levels,
    right-hand side) gives that fill's own answer, as the replays of a
    captured shape do."""
    g = inpaint._SpringsGraphs()
    for seed in (3, 4):
        A = raster((96, 80), "holes", seed=seed)
        apply_fn, b, x0, unknown, deg, _ = system(A)
        levels = inpaint._build_levels(unknown, deg)
        want = cg_before(apply_fn, b, x0,
                         lambda r: inpaint._kcycle(r, levels, 0), 1e-7,
                         4000, True, 1)
        g.load(unknown, deg, levels, b, x0, inpaint._atol2(b, 1e-7))
        g.start()
        it, syncs, _ = inpaint._iterate(g.step, lambda: g.flag, 4000, 1)
        assert torch.equal(g.state[0], want[0])
        assert (it, syncs) == want[1:]


@pytest.mark.parametrize("check_every,maxiter", [(16, 4000), (7, 4000),
                                                 (16, 5)])
def test_plain_cg_equals_the_loop_it_replaced(check_every, maxiter):
    """The Jacobi-preconditioned and the unpreconditioned CG (``cg_solve``,
    fda) over ``_cg_step`` give the old loop's bits, iterations and syncs,
    a read every k iterations and at ``maxiter``."""
    A = raster((40, 50), "holes", seed=5)
    apply_fn, b, x0, unknown, deg, _ = system(A)
    for precond in (lambda r: r * torch.where(deg > 0, 1.0 / deg, 0.0)
                    * unknown, None):
        want = cg_before(apply_fn, b, x0, precond, 1e-7, maxiter, False,
                         check_every)
        got = inpaint._cg(apply_fn, b, x0, precond, 1e-7, maxiter, False,
                          check_every)
        assert torch.equal(got[0], want[0]) and got[1:] == want[1:]


class NoGraphs:
    """A stand-in for ``inpaint._GRAPHS`` that records every fill it is
    asked for and raises."""

    def __init__(self):
        self.calls = 0

    def fill(self, *args):
        self.calls += 1
        raise LookupError("graph path taken")


PATHS = {
    # (shape, graphs_on, the call, graph path taken)
    "cpu_multigrid": ((96, 80), None, "springs", False),
    "jacobi": ((40, 63), True, "springs", False),
    "sharded": ((96, 80), True, "sharded", False),
    "multigrid": ((96, 80), True, "springs", True),
}


@pytest.mark.parametrize("name", sorted(PATHS))
def test_graph_path_only_for_a_multigrid_fill_on_cuda(monkeypatch, name):
    """The graphs are asked for only where ``_graphs_on`` (a CUDA device)
    holds and the multigrid branch runs: not on the CPU, not on the
    Jacobi branch (a side under 64), not by the sharded fill, whose CG
    runs on its layout of blocks."""
    shape, on, call, taken = PATHS[name]
    stub = NoGraphs()
    monkeypatch.setattr(inpaint, "_GRAPHS", stub)
    if on is not None:
        monkeypatch.setattr(inpaint, "_graphs_on", lambda device: on)
    A = raster(shape, "holes", seed=7)
    if call == "sharded":
        out = ntt.dist.sharded_springs_fill(A.numpy(), make_mesh([CPU] * 4),
                                            mg_min_block=16)
        assert not torch.isnan(torch.as_tensor(out)).any()
    elif taken:
        with pytest.raises(LookupError, match="graph path taken"):
            inpaint._springs_core(A, 1e-7, 4000)
    else:
        _, info = inpaint._springs_core(A, 1e-7, 4000)
        assert info["graph"] == "eager" and info["replays"] == 0
    assert stub.calls == int(taken)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def graphs(card, monkeypatch):
    """A fresh cache of graphs, and ``eager(A)``: the same fill through
    the eager loop."""
    cache = inpaint._GraphCache()
    monkeypatch.setattr(inpaint, "_GRAPHS", cache)

    def eager(A, tol=1e-7, maxiter=4000):
        with monkeypatch.context() as m:
            m.setattr(inpaint, "_graphs_on", lambda device: False)
            return inpaint._springs_core(A, tol, maxiter)

    return cache, eager


def same(got, want):
    (a, ia), (b, ib) = got, want
    assert torch.equal(a, b)
    assert (ia["iterations"], ia["host_syncs"]) == (ib["iterations"],
                                                    ib["host_syncs"])
    assert ib["graph"] == "eager"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_replay_equals_the_eager_loop_on_card(graphs, card, dtype):
    _, eager = graphs
    A = raster((1031, 777), "holes", seed=11, dtype=dtype, device=card)
    tol = 1e-7 if dtype == torch.float32 else 1e-12
    want = eager(A, tol, 100_000)
    for how in ("captured", "replayed"):
        got = inpaint._springs_core(A, tol, 100_000)
        same(got, want)
        assert got[1]["graph"] == how
        assert got[1]["replays"] == 1 + got[1]["host_syncs"]


@pytest.mark.cuda
def test_a_new_mask_of_a_captured_shape_on_card(graphs, card):
    """Three masks of one shape: the second and third fills replay the
    first one's graphs with their own levels and equal the eager loop."""
    _, eager = graphs
    for seed, how in ((1, "captured"), (2, "replayed"), (3, "replayed")):
        A = raster((600, 900), "holes", seed=seed, device=card)
        got = inpaint._springs_core(A, 1e-7, 4000)
        same(got, eager(A))
        assert got[1]["graph"] == how


@pytest.mark.cuda
def test_shapes_stops_and_eviction_on_card(graphs, card):
    """Two shapes in turns, fills that stop at once (a flat surface,
    nothing unknown) and one cut at ``maxiter``: the counts and bits of
    the eager loop; a cache of two shapes evicts the least recently used
    and captures it again when it returns."""
    cache, eager = graphs
    cache.size = 2
    runs = [((300, 300), "holes", 4000, "captured"),
            ((301, 450), "holes", 4000, "captured"),
            ((300, 300), "flat", 4000, "replayed"),
            ((301, 450), "none", 4000, "replayed"),
            ((300, 300), "holes", 2, "replayed"),
            ((129, 64), "holes", 4000, "captured"),
            ((301, 450), "holes", 4000, "captured"),
            ((300, 300), "holes", 4000, "captured")]
    for shape, case, maxiter, how in runs:
        A = raster(shape, case, seed=shape[1], device=card)
        got = inpaint._springs_core(A, 1e-7, maxiter)
        same(got, eager(A, 1e-7, maxiter))
        assert got[1]["graph"] == how, (shape, case)
        if case != "holes":
            assert got[1]["iterations"] == 0 and got[1]["host_syncs"] == 1
        if maxiter == 2:
            assert got[1]["iterations"] == 2
    assert len(cache._entries) == 2


@pytest.mark.cuda
def test_threads_share_a_shape_on_card(graphs, card):
    """Four threads fill masks of one shape at once, each on its own
    stream: each gets its eager answer (the entry's lock and event keep
    them off each other's fixed tensors)."""
    _, eager = graphs
    masks = [raster((500, 400), "holes", seed=s, device=card)
             for s in range(8)]
    want = [eager(A)[0] for A in masks]
    got = [None] * len(masks)

    def work(k):
        with torch.cuda.stream(torch.cuda.Stream(card)):
            for i in range(k, len(masks), 4):
                got[i] = inpaint._springs_core(masks[i], 1e-7, 4000)[0]
            torch.cuda.current_stream(card).synchronize()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_smrf_through_graphs_equals_eager_on_card(graphs, card):
    """``smrf`` on a synthetic lidar tile (the benchmark's recipe): the
    labels and the DTM through the graph path equal the eager path's."""
    from portbench.systems.smrf_isprs import lidar_tile
    _, _ = graphs
    x, y, z = lidar_tile(np.random.default_rng(8), 400_000, 600.0)
    kw = dict(cellsize=1, windows=18, slope_threshold=.15,
              elevation_threshold=.5, elevation_scaler=1.25, device=card)
    got = ntt.smrf(x, y, z, **kw)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(inpaint, "_graphs_on", lambda device: False)
        want = ntt.smrf(x, y, z, **kw)
    assert torch.equal(got[3], want[3])
    assert torch.equal(torch.nan_to_num(got[0], nan=-1.0),
                       torch.nan_to_num(want[0], nan=-1.0))


@pytest.mark.cuda
def test_span_attr_reads_captured_then_replayed_on_card(graphs, card):
    A = raster((700, 500), "holes", seed=21, device=card)
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        infos = [inpaint._springs_core(A, 1e-7, 4000)[1] for _ in range(2)]
    fills = [s for s in profiling.spans() if s.name == "inpaint.springs"]
    profiling.clear_spans()
    assert [s.attr for s in fills] == infos
    assert [s.attr["graph"] for s in fills] == ["captured", "replayed"]
    assert all(s.device_ms > 0 for s in fills)
