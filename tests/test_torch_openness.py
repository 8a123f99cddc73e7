"""The PyTorch port's openness family (``neilpy_tpu_torch``: openness,
openness_pair, skyview_factor, ternary codes, geomorphons2,
directional_ratio_extrema) held against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side runs as its own tests run it: the Pallas kernels in interpret
mode (``tile=(64, 128)`` where the entry takes one) and the XLA path.

Tolerances (the port follows the Pallas kernels' arithmetic,
``neilpy_tpu_torch/ops/cuda_scan.py``):
- extrema ``mx``/``mn`` and ternary codes: exact against Pallas; against
  XLA, which divides, extrema within atol 1e-5 (tests/test_pallas.py) and
  codes equal on these fixtures (only an f32 decision tie could differ);
- openness (degrees): atol 1e-4 against both, the JAX package's own
  engine tolerance; +inf where a pixel saw nothing, exactly;
- skyview factor: atol 1e-6 against both.

The code tables these functions read (``core/codes.py``) are held equal
to the JAX package's in ``tests/test_torch_core_io.py``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import neilpy_tpu
import neilpy_tpu_torch
from neilpy_tpu.core import codes as jcodes
from neilpy_tpu.ops import pallas_scan as jps
from neilpy_tpu.ops import visibility as jvis
from neilpy_tpu_torch.core import codes as tcodes
from neilpy_tpu_torch.ops import cuda_scan
from neilpy_tpu_torch.ops import visibility as tvis

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TILE = (64, 128)
OPENNESS_ATOL = 1e-4
EXTREMA_XLA_ATOL = 1e-5
SVF_ATOL = 1e-6


@pytest.fixture(scope="module")
def Z():
    """100x140 terrain with a NaN hole, as test_torch_visibility's."""
    r = np.random.default_rng(7)
    Z = r.normal(size=(100, 140)).cumsum(axis=0).cumsum(axis=1).astype(
        np.float32)
    Z[30:40, 50:70] = np.nan
    return Z


def close_with_inf(ours, ref, atol):
    """Finite values within ``atol``; +inf (unseen) at the same pixels."""
    ours = np.asarray(ours)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isposinf(ours), np.isposinf(ref))
    assert np.isfinite(ref[~np.isposinf(ref)]).all()
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("lookup,fast", [(7, False), (23, True)])
def test_directional_ratio_extrema(Z, lookup, fast):
    mx, mn, seen = tvis.directional_ratio_extrema(
        Z, cellsize=2.0, lookup_pixels=lookup, fast=fast, device="cpu")
    assert mx.shape == (8, *Z.shape) and mx.dtype == torch.float32
    pmx, pmn = jps.directional_extrema_pallas(
        Z, cellsize=2.0, lookup_pixels=lookup, fast=fast, tile=TILE)
    np.testing.assert_array_equal(mx.numpy(), np.asarray(pmx))
    np.testing.assert_array_equal(mn.numpy(), np.asarray(pmn))
    xmx, xmn, xseen = jvis.directional_ratio_extrema(
        Z, cellsize=2.0, lookup_pixels=lookup, fast=fast)
    np.testing.assert_allclose(mx.numpy(), np.asarray(xmx),
                               atol=EXTREMA_XLA_ATOL, rtol=0)
    np.testing.assert_allclose(mn.numpy(), np.asarray(xmn),
                               atol=EXTREMA_XLA_ATOL, rtol=0)
    np.testing.assert_array_equal(seen.numpy(), np.asarray(xseen))


def test_directional_ratio_extrema_subset_and_shards(Z):
    mx, mn, seen = tvis.directional_ratio_extrema(
        Z, lookup_pixels=3, directions=(5, 1), device="cpu")
    full, full_mn, _ = tvis.directional_ratio_extrema(Z, lookup_pixels=3,
                                                      device="cpu")
    assert mx.shape == (2, *Z.shape)
    assert torch.equal(mx, full[[5, 1]]) and torch.equal(mn, full_mn[[5, 1]])
    # a shard block that is the whole raster is the raster; in a larger
    # raster only the edge-replication epilogue moves (tests/test_torch_dist.py
    # holds shard blocks against the JAX package)
    whole, _, _ = tvis.directional_ratio_extrema(
        Z, lookup_pixels=3, device="cpu", origin=(0, 0), global_shape=Z.shape)
    assert torch.equal(whole, full)
    inner, _, inner_seen = tvis.directional_ratio_extrema(
        Z, lookup_pixels=3, device="cpu", origin=(10, 10),
        global_shape=(Z.shape[0] + 20, Z.shape[1] + 20))
    assert torch.equal(inner[:, 3:-3, 3:-3], full[:, 3:-3, 3:-3])
    assert (inner_seen.sum() <= (full > -np.inf).sum()).item()


def test_openness_pair(Z, lookup=7):
    pos, neg = tvis.openness_pair(Z, cellsize=2.0, lookup_pixels=lookup,
                                  device="cpu")
    assert pos.dtype == torch.float32 and pos.shape == Z.shape
    pp, pn = jps.openness_pallas(Z, cellsize=2.0, lookup_pixels=lookup,
                                 tile=TILE)
    xp, xn = jvis.openness_pair(Z, cellsize=2.0, lookup_pixels=lookup,
                                engine="xla")
    for ours, pallas, xla in ((pos, pp, xp), (neg, pn, xn)):
        close_with_inf(ours.numpy(), pallas, OPENNESS_ATOL)
        close_with_inf(ours.numpy(), xla, OPENNESS_ATOL)
    # negative openness is the positive openness of -Z
    close_with_inf(neg.numpy(), tvis.openness(-Z, cellsize=2.0,
                                              lookup_pixels=lookup,
                                              device="cpu").numpy(), 1e-5)


@pytest.mark.parametrize("neighbors", [None, [1, 5], [2]])
def test_openness(Z, neighbors):
    ours = tvis.openness(Z, cellsize=2.0, lookup_pixels=7,
                         neighbors=neighbors, skyview=True,
                         device="cpu").numpy()
    close_with_inf(ours, jvis.openness(Z, cellsize=2.0, lookup_pixels=7,
                                       neighbors=neighbors, engine="xla"),
                   OPENNESS_ATOL)
    if neighbors is None:  # the JAX package's Pallas engine: K2's plane
        ref, _ = jps.openness_pallas(Z, cellsize=2.0, lookup_pixels=7,
                                     tile=TILE)
    else:  # K3's planes
        ref = jvis.openness(Z, cellsize=2.0, lookup_pixels=7,
                            neighbors=neighbors, engine="pallas")
    close_with_inf(ours, ref, OPENNESS_ATOL)


def test_openness_unseen_is_inf():
    """An isolated pixel in NaN: every ray sees only NaN, so both
    openness planes are +inf there, as test_pallas.py demands."""
    Z = np.full((32, 140), np.nan, dtype=np.float32)
    Z[16, 70] = 5.0
    pos, neg = tvis.openness_pair(Z, lookup_pixels=3, device="cpu")
    assert np.isposinf(pos[16, 70].item()) and np.isposinf(neg[16, 70].item())
    pp, pn = jps.openness_pallas(Z, lookup_pixels=3)
    np.testing.assert_array_equal(np.isposinf(pos.numpy()),
                                  np.isposinf(np.asarray(pp)))
    np.testing.assert_array_equal(np.isposinf(neg.numpy()),
                                  np.isposinf(np.asarray(pn)))
    s = tvis.skyview_factor(Z, lookup_pixels=3, device="cpu")
    assert s[16, 70].item() == 1.0
    tc = tvis.ternary_pattern_from_openness(Z, lookup_pixels=3,
                                            device="cpu")
    assert int(tc[16, 70]) == 3280  # all digits 1


def test_fast_ladder_openness():
    """The progressive ladder (lookup 23 -> Rmax 21) through the fused
    openness, on a non-tile-aligned 70x90 raster."""
    Z = np.random.default_rng(11).normal(size=(70, 90)).cumsum(
        axis=0).astype(np.float32)
    ours = tvis.openness(Z, cellsize=2, lookup_pixels=23, fast=True,
                         device="cpu").numpy()
    p, _ = jps.openness_pallas(Z, cellsize=2, lookup_pixels=23, fast=True,
                               tile=(32, 128))
    close_with_inf(ours, p, OPENNESS_ATOL)
    close_with_inf(ours, jvis.openness(Z, cellsize=2, lookup_pixels=23,
                                       fast=True, engine="xla"),
                   OPENNESS_ATOL)


def test_lookup_exceeding_raster():
    """lookup 40 on 64x90: most rays leave the raster before Rmax."""
    Z = np.random.default_rng(11).normal(size=(64, 90)).cumsum(
        axis=0).astype(np.float32)
    pos, neg = tvis.openness_pair(Z, lookup_pixels=40, device="cpu")
    p, n = jps.openness_pallas(Z, lookup_pixels=40, tile=(32, 128))
    close_with_inf(pos.numpy(), p, OPENNESS_ATOL)
    close_with_inf(neg.numpy(), n, OPENNESS_ATOL)
    close_with_inf(pos.numpy(), jvis.openness(Z, lookup_pixels=40,
                                              engine="xla"), OPENNESS_ATOL)
    s = tvis.skyview_factor(Z, lookup_pixels=40, device="cpu").numpy()
    np.testing.assert_allclose(
        s, np.asarray(jvis.skyview_factor(Z, lookup_pixels=40,
                                          engine="xla")),
        atol=SVF_ATOL, rtol=0)


def test_skyview_factor(Z, lookup=7):
    s = tvis.skyview_factor(Z, cellsize=2.0, lookup_pixels=lookup,
                            device="cpu")
    assert s.dtype == torch.float32 and s.shape == Z.shape
    ps = jps.skyview_pallas(Z, cellsize=2.0, lookup_pixels=lookup,
                            tile=TILE)
    xs = jvis.skyview_factor(Z, cellsize=2.0, lookup_pixels=lookup,
                             engine="xla")
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), atol=SVF_ATOL,
                               rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(xs), atol=SVF_ATOL,
                               rtol=0)


def test_svf_from_extrema(Z):
    mx, _, _ = tvis.directional_ratio_extrema(Z, cellsize=2.0,
                                              lookup_pixels=7, device="cpu")
    np.testing.assert_allclose(
        tvis.svf_from_extrema(mx).numpy(),
        np.asarray(jvis.svf_from_extrema(mx.numpy())), atol=SVF_ATOL,
        rtol=0)
    np.testing.assert_allclose(
        tvis.svf_from_extrema(mx).numpy(),
        tvis.skyview_factor(Z, cellsize=2.0, lookup_pixels=7,
                            device="cpu").numpy(),
        atol=SVF_ATOL, rtol=0)


@pytest.mark.parametrize("neg_mode", [True, False])
@pytest.mark.parametrize("threshold", [0.0, 2.0])
def test_ternary_pattern(Z, neg_mode, threshold):
    kw = dict(cellsize=2.0, lookup_pixels=7, threshold_angle=threshold,
              use_negative_openness=neg_mode)
    tc = tvis.ternary_pattern_from_openness(Z, device="cpu", **kw)
    assert tc.dtype == torch.uint16 and tc.shape == Z.shape
    np.testing.assert_array_equal(
        tc.numpy(), np.asarray(jps.ternary_pallas(Z, tile=TILE, **kw)))
    np.testing.assert_array_equal(
        tc.numpy(), np.asarray(jvis.ternary_pattern_from_openness(
            Z, engine="xla", **kw)))


def test_ternary_lowest(Z):
    kw = dict(cellsize=2.0, lookup_pixels=7, threshold_angle=0.0,
              use_negative_openness=True)
    tc = tvis.ternary_pattern_from_openness(Z, lowest=True, device="cpu",
                                            **kw)
    assert tc.dtype == torch.uint16
    np.testing.assert_array_equal(
        tc.numpy(), np.asarray(jvis.ternary_pattern_from_openness(
            Z, lowest=True, engine="xla", **kw)))
    # the Pallas codes through the JAX package's own table
    np.testing.assert_array_equal(
        tc.numpy(), jcodes.lowest_equivalent_table()[np.asarray(
            jps.ternary_pallas(Z, tile=TILE, **kw)).astype(np.int64)])
    # the micro-oracle of tests/test_visibility.py: 2240 -> 160
    assert tcodes.lowest_equivalent_table()[2240] == 160


@pytest.mark.parametrize("use_negative_openness", [True, False])
def test_geomorphons2(Z, tmp_path, use_negative_openness):
    """Both branches, with the PNG and worldfile bytes equal to the JAX
    package's ``outfile`` output."""
    kw = dict(cellsize=2.0, lookup_pixels=7, threshold_angle=1,
              use_negative_openness=use_negative_openness)
    ours_fn = str(tmp_path / "ours.png")
    jax_fn = str(tmp_path / "jax.png")
    G = tvis.geomorphons2(
        Z, outfile=ours_fn, device="cpu",
        out_transform=neilpy_tpu_torch.from_origin(5e5, 4.2e6, 2, 2), **kw)
    assert G.dtype == torch.uint8 and G.shape == Z.shape
    ref = jvis.geomorphons2(
        Z, outfile=jax_fn, engine="pallas",
        out_transform=neilpy_tpu.from_origin(5e5, 4.2e6, 2, 2), **kw)
    np.testing.assert_array_equal(G.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        G.numpy(), np.asarray(jvis.geomorphons2(Z, engine="xla", **kw)))
    assert (tmp_path / "ours.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    assert (tmp_path / "ours.pgw").read_bytes() == \
        (tmp_path / "jax.pgw").read_bytes()


def test_geotiff_openness_slice(tmp_path):
    """GeoTIFF -> imread -> openness_pair -> imwrite (float32) -> read
    back, against the JAX package on the same file."""
    rng = np.random.default_rng(21)
    Z = (rng.normal(size=(90, 120)).cumsum(axis=0).cumsum(axis=1)
         + 500.0).astype(np.float32)
    fn = str(tmp_path / "dem.tif")
    neilpy_tpu.write_geotiff(
        fn, Z, transform=neilpy_tpu.from_origin(500000.0, 4200000.0, 10, 10),
        crs=32618, nodata=-9999.0)
    Zt, meta = neilpy_tpu_torch.imread(fn)
    pos, neg = neilpy_tpu_torch.openness_pair(
        Zt, cellsize=meta["cellsize"], lookup_pixels=20, device="cpu")
    Zj, meta_j = neilpy_tpu.imread(fn)
    jp, jn = neilpy_tpu.openness_pair(Zj, cellsize=meta_j["cellsize"],
                                      lookup_pixels=20)
    close_with_inf(pos.numpy(), jp, OPENNESS_ATOL)
    close_with_inf(neg.numpy(), jn, OPENNESS_ATOL)
    out = str(tmp_path / "openness.tif")
    neilpy_tpu_torch.imwrite(out, pos, meta)
    back, meta_b = neilpy_tpu.imread(out)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, pos.numpy())
    assert tuple(meta_b["transform"]) == tuple(meta["transform"])
    back_t, _ = neilpy_tpu_torch.imread(out)
    np.testing.assert_array_equal(back_t, pos.numpy())


def test_public_names_match_the_jax_package():
    for name in ("openness", "openness_pair", "skyview_factor",
                 "geomorphons2", "ternary_pattern_from_openness"):
        assert callable(getattr(neilpy_tpu_torch, name))
        assert callable(getattr(neilpy_tpu, name))
    assert set(jvis.__all__) <= set(tvis.__all__)


def test_engine_cuda_on_cpu_tensor_raises(Z):
    Zt = torch.from_numpy(Z)
    for call in (lambda: tvis.openness_pair(Zt, engine="cuda"),
                 lambda: tvis.skyview_factor(Zt, engine="cuda"),
                 lambda: tvis.ternary_pattern_from_openness(Zt,
                                                            engine="cuda"),
                 lambda: tvis.openness(Zt, neighbors=[1], engine="cuda"),
                 lambda: tvis.geomorphons2(Zt, use_negative_openness=False,
                                           engine="cuda"),
                 lambda: cuda_scan.openness_cuda(Zt),
                 lambda: cuda_scan.directional_extrema_cuda(Zt)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    with pytest.raises(ValueError, match="mode"):
        cuda_scan.openness_reduced_torch(Zt, "slope")
    with pytest.raises(ValueError, match="lookup_pixels"):
        tvis.openness_pair(Zt, lookup_pixels=0)


def test_cpu_path_launches_no_kernel(Z):
    counters = (cuda_scan.openness_reduced_cuda,
                cuda_scan.directional_extrema_cuda,
                cuda_scan.openness_counts_cuda)
    before = [fn.launches for fn in counters]
    Zt = torch.from_numpy(Z)
    tvis.openness_pair(Zt, lookup_pixels=2)
    tvis.openness(Zt, lookup_pixels=2, neighbors=[3])
    tvis.geomorphons2(Zt, lookup_pixels=2, use_negative_openness=False)
    assert [fn.launches for fn in counters] == before


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One nvcc per ``csrc/*.cu`` (started together), then one link of
    their objects into the library, with the shared header in the hash."""
    from neilpy_tpu_torch import _build
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    for name in ("a.cu", "b.cu", "shared.cuh"):
        (src_dir / name).write_text(f"// {name}\n")
    calls = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{calls}"\n'
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then touch "$2"; fi\n'
        "  shift\n"
        "done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "SOURCE_DIR", src_dir)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    first = _build.library_path()
    lib = _build.build()
    assert lib == first and lib.is_file()
    lines = calls.read_text().splitlines()
    assert len(lines) == 3
    assert all("-c" in ln.split() and "-fmad=false" in ln for ln in lines[:2])
    assert sorted(ln.split()[-1] for ln in lines[:2]) == [
        str(src_dir / "a.cu"), str(src_dir / "b.cu")]
    assert "-shared" in lines[2].split()
    assert not list((tmp_path / "build").glob("*.o"))
    (src_dir / "shared.cuh").write_text("// changed\n")
    assert _build.library_path() != first


def test_import_needs_no_jax_for_the_openness_family():
    """The openness family's modules import neither jax nor the JAX
    package (a subprocess: this process has jax loaded already)."""
    code = ("import sys; "
            "from neilpy_tpu_torch.ops import cuda_scan, visibility; "
            "from neilpy_tpu_torch import openness_pair, geomorphons2, "
            "skyview_factor, ternary_pattern_from_openness; "
            "assert 'jax' not in sys.modules; "
            "assert 'neilpy_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_fold_bound_counts_the_tpu_kernels_atan():
    """``chip_smoke.py``'s bound of K2 and K5/reduced counts the fold from
    the TPU kernel's own body (``pallas_scan.py:reduce_dir``):
    ``_atan_f32`` at the number of equations of its jaxpr less its
    multiplies whose one use is an add or a subtract (each such pair one
    FMA), openness two of them and 8 more operations per pixel and
    direction, added to the ladder's operations."""
    import jax
    import jax.extend.core
    import jax.numpy as jnp
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke
    x = jnp.zeros((8, 128), jnp.float32)
    eqns = jax.make_jaxpr(jps._atan_f32)(x).jaxpr.eqns
    uses = {}
    for e in eqns:
        for v in e.invars:
            if not isinstance(v, jax.extend.core.Literal):
                uses.setdefault(v, []).append(e.primitive.name)
    fmas = sum(e.primitive.name == "mul"
               and uses.get(e.outvars[0]) in (["add"], ["sub"])
               for e in eqns)
    assert chip_smoke.ATAN_OPS == len(eqns)
    assert chip_smoke.ATAN_FMAS == fmas
    assert chip_smoke.FOLD_OPS["openness", True] == (
        2 * (chip_smoke.ATAN_OPS - chip_smoke.ATAN_FMAS) + 8)
    px = 8192 * 8192
    steps = 50 * 8 * px
    ladder_only, side = chip_smoke.bound(steps, 12 * px)
    with_fold, side_fold = chip_smoke.bound(
        steps, 12 * px, chip_smoke.fold_ops("openness", px))
    assert side == side_fold == "operations"
    assert with_fold == pytest.approx(
        ladder_only + 56 * 8 * px / chip_smoke.PEAK_F32_OPS * 1e3)
    assert chip_smoke.fold_ops("ternary", 1, neg_mode=False) == 8 * 11
    assert chip_smoke.fold_ops("svf", 1, neg_mode=False) == 8 * 5


# ----------------------------------------------------------------------
# kernels against their plain versions, on the card only
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def card_raster(cuda_device):
    rng = np.random.default_rng(3)
    Z = rng.normal(size=(257, 389)).cumsum(axis=0).cumsum(axis=1).astype(
        np.float32)
    Z[100:120, 40:90] = np.nan
    return torch.from_numpy(Z).to(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_extrema_kernel_matches_plain_on_card(card_raster, fast):
    kw = dict(cellsize=2.0, lookup_pixels=23, fast=fast)
    k = cuda_scan.directional_extrema_cuda(card_raster, **kw)
    p = cuda_scan.directional_extrema_torch(card_raster, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,neg_mode,fast", [
    ("openness", True, False), ("openness", True, True),
    ("svf", True, False), ("ternary", True, False),
    ("ternary", False, False)])
def test_reduced_kernel_matches_plain_on_card(card_raster, mode, neg_mode,
                                              fast):
    kw = dict(cellsize=2.0, lookup_pixels=23, threshold_angle=1.0,
              neg_mode=neg_mode, fast=fast)
    k = cuda_scan.openness_reduced_cuda(card_raster, mode, **kw)
    p = cuda_scan.openness_reduced_torch(card_raster, mode, **kw)
    torch.cuda.synchronize()
    if mode == "openness":  # compared in degrees, as the tolerance is
        k, p = cuda_scan.openness_degrees(*k), cuda_scan.openness_degrees(*p)
    for a, b in zip(k, p):
        if mode == "ternary":
            assert torch.equal(a.int(), b.int())
        elif mode == "svf":
            torch.testing.assert_close(a, b, atol=SVF_ATOL, rtol=0)
        else:
            assert torch.equal(torch.isinf(a), torch.isinf(b))
            torch.testing.assert_close(a, b, atol=5e-5, rtol=0)
