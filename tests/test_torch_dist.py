"""The PyTorch port's mesh-sharded openness path (``neilpy_tpu_torch.dist``:
make_mesh, pad_to_mesh, halo_exchange_2d, sharded_apply,
sharded_geomorphons, sharded_openness, sharded_skyview; K4's block
entry; ``directional_ratio_extrema(origin=, global_shape=)``) held
against the JAX package on the CPU.

The JAX side runs on the 8-device virtual CPU mesh that
``tests/conftest.py`` makes (2 x 4), mostly through its XLA engine and
the Pallas interpret engine for a few small cases.  The port side runs
on a mesh that names the host eight times
(``make_mesh([torch.device('cpu')] * 8, shape=...)``), through the plain
PyTorch versions of the kernels.  Inputs are seeded numpy arrays at
``tests/test_dist.py``'s sizes.

Tolerances:
- K4's counts and every sharded class map: exact, against the Pallas
  block kernel, JAX's sharded path (both engines) and the port's
  single-device ``geomorphons``;
- extrema of a haloed block: ``seen`` exact, ``mx``/``mn`` within 1e-5
  of the XLA function (which divides; the port multiplies by
  ``cuda_scan._ladder_scales``), and exactly the port's single-device
  extrema on the block's core;
- sharded openness within 1e-4 degrees, skyview within 1e-6
  (``tests/test_dist.py``);
- halos and ``sharded_apply`` box sums exact; ``gradient2d`` through the
  ``linear`` halo within one ulp of the terrain's magnitude (the
  extrapolated value rounds before the central difference).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from neilpy_tpu.core.shift import gradient2d as jgradient2d
from neilpy_tpu.dist import api as japi
from neilpy_tpu.dist.halo import halo_exchange_2d as jhalo_exchange_2d
from neilpy_tpu.ops import visibility as jvis
from neilpy_tpu.ops.pallas_scan import openness_counts_pallas_block
from neilpy_tpu_torch.core.shift import gradient2d
from neilpy_tpu_torch.dist import (block_origin, halo_exchange_2d,
                                   make_mesh, pad_to_mesh, sharded_apply,
                                   sharded_geomorphons, sharded_openness,
                                   sharded_skyview)
from neilpy_tpu_torch.ops import cuda_scan
from neilpy_tpu_torch.ops import visibility as tvis

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
EXTREMA_XLA_ATOL = 1e-5
OPENNESS_ATOL = 1e-4
SVF_ATOL = 1e-6


def cpu_mesh(shape=None):
    return make_mesh(CPU8, shape=shape)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest should force 8 CPU devices"
    return japi.make_mesh()  # 2 x 4


@pytest.fixture(scope="module")
def big_terrain():
    """tests/test_dist.py's fixture."""
    rng = np.random.default_rng(3)
    return rng.normal(size=(96, 128)).cumsum(axis=0).cumsum(axis=1).astype(
        np.float32)


def walk(seed, shape, axis=0):
    return np.random.default_rng(seed).normal(size=shape).cumsum(
        axis=axis).astype(np.float32)


def close_with_inf(ours, ref, atol):
    """Finite values within ``atol``; +inf (unseen) at the same pixels."""
    ours = np.asarray(ours)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isposinf(ours), np.isposinf(ref))
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


# ----------------------------------------------------------------------
# mesh
# ----------------------------------------------------------------------
def test_make_mesh():
    m = cpu_mesh()
    assert m.devices.shape == (2, 4)
    assert m.shape["ty"] == 2 and m.shape["tx"] == 4
    assert all(d == torch.device("cpu") for d in m.devices.ravel())
    assert make_mesh(CPU8[:4]).devices.shape == (2, 2)
    assert make_mesh(CPU8[:7]).devices.shape == (1, 7)
    assert cpu_mesh((8, 1)).devices.shape == (8, 1)
    with pytest.raises(ValueError, match="needs 9 devices"):
        cpu_mesh((3, 3))


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_geomorphons(np.zeros((8, 8), np.float32))


def test_pad_to_mesh():
    Zp, orig = pad_to_mesh(torch.zeros(50, 70), cpu_mesh())
    assert orig == (50, 70) and tuple(Zp.shape) == (50, 72)
    assert torch.isnan(Zp[:, 70:]).all() and (Zp[:, :70] == 0).all()
    assert block_origin((25, 18), (1, 3)) == (25, 54)


# ----------------------------------------------------------------------
# K4's block entry against the Pallas block kernel
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def block_raster():
    Z = np.random.default_rng(5).normal(size=(48, 72)).cumsum(
        axis=0).cumsum(axis=1).astype(np.float32)
    Z[20:26, 30:40] = np.nan
    return Z


@pytest.mark.parametrize("origin,R,fast", [
    ((0, 0), 5, False),      # top-left corner block
    ((0, 24), 5, False),     # top edge
    ((16, 24), 5, False),    # interior, around the NaN hole
    ((32, 48), 5, False),    # bottom-right corner
    ((16, 24), 9, True),     # fast ladder
    ((16, 24), 20, False),   # R larger than the 16 x 24 block
])
def test_block_counts_match_pallas_block(block_raster, origin, R, fast):
    bh, bw = 16, 24
    oy, ox = origin
    Zp = np.pad(block_raster, R, constant_values=np.nan)
    block = np.ascontiguousarray(Zp[oy:oy + bh + 2 * R, ox:ox + bw + 2 * R])
    kw = dict(cellsize=2.0, threshold_angle=1.0, fast=fast)
    ours = cuda_scan.openness_counts_block(torch.from_numpy(block), origin,
                                           block_raster.shape, R, **kw)
    ref = openness_counts_pallas_block(block, origin, block_raster.shape, R,
                                       interpret=True, **kw)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.uint8 and tuple(a.shape) == (bh, bw)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and the single-device counts on the block's core
    single = cuda_scan.openness_counts_torch(
        torch.from_numpy(block_raster), lookup_pixels=R, **kw)
    for a, s in zip(ours, single):
        assert torch.equal(a, s[oy:oy + bh, ox:ox + bw])


def test_block_counts_on_cpu_tensor_with_cuda_engine_raises(block_raster):
    block = torch.from_numpy(np.pad(block_raster, 3,
                                    constant_values=np.nan))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        cuda_scan.openness_counts_block(block, (0, 0), block_raster.shape, 3,
                                        engine="cuda")
    with pytest.raises(ValueError, match="cannot carry a halo"):
        cuda_scan.openness_counts_block_torch(block[:5], (0, 0),
                                              block_raster.shape, 3)


# ----------------------------------------------------------------------
# directional_ratio_extrema on a haloed block
# ----------------------------------------------------------------------
@pytest.mark.parametrize("origin,fast", [((0, 0), False), ((16, 24), False),
                                         ((32, 48), True)])
def test_block_extrema_match_xla(block_raster, origin, fast):
    R, bh, bw = 6, 16, 24
    oy, ox = origin
    Zp = np.pad(block_raster, R, constant_values=np.nan)
    block = np.ascontiguousarray(Zp[oy:oy + bh + 2 * R, ox:ox + bw + 2 * R])
    kw = dict(cellsize=2.0, lookup_pixels=R, fast=fast,
              origin=(oy - R, ox - R), global_shape=block_raster.shape)
    mx, mn, seen = tvis.directional_ratio_extrema(block, device="cpu", **kw)
    assert tuple(mx.shape) == (8, bh + 2 * R, bw + 2 * R)
    xmx, xmn, xseen = jvis.directional_ratio_extrema(block, **kw)
    np.testing.assert_array_equal(seen.numpy(), np.asarray(xseen))
    np.testing.assert_allclose(mx.numpy(), np.asarray(xmx),
                               atol=EXTREMA_XLA_ATOL, rtol=0)
    np.testing.assert_allclose(mn.numpy(), np.asarray(xmn),
                               atol=EXTREMA_XLA_ATOL, rtol=0)
    smx, smn, _ = tvis.directional_ratio_extrema(
        block_raster, cellsize=2.0, lookup_pixels=R, fast=fast, device="cpu")
    core = (slice(None), slice(R, R + bh), slice(R, R + bw))
    glob = (slice(None), slice(oy, oy + bh), slice(ox, ox + bw))
    assert torch.equal(mx[core], smx[glob])
    assert torch.equal(mn[core], smn[glob])


# ----------------------------------------------------------------------
# sharded_geomorphons
# ----------------------------------------------------------------------
def check_geomorphons(Z, tmesh, jmesh, engine="xla", **kw):
    """Port sharded == port single-device == JAX sharded, exactly."""
    tiled = sharded_geomorphons(Z, tmesh, engine="torch", **kw)
    single = tvis.geomorphons(Z, device="cpu", **kw)
    assert tiled.dtype == torch.uint8 and tiled.shape == single.shape
    assert torch.equal(tiled, single)
    ref = np.asarray(japi.sharded_geomorphons(Z, jmesh, engine=engine, **kw))
    np.testing.assert_array_equal(tiled.numpy(), ref)


@pytest.mark.parametrize("lookup", [1, 5, 11])
def test_sharded_geomorphons(jmesh, big_terrain, lookup):
    check_geomorphons(big_terrain, cpu_mesh(), jmesh, cellsize=2,
                      lookup_pixels=lookup)


def test_sharded_geomorphons_nan_hole(jmesh, big_terrain):
    Z = big_terrain.copy()
    Z[40:50, 60:80] = np.nan
    check_geomorphons(Z, cpu_mesh(), jmesh, lookup_pixels=4)


def test_sharded_geomorphons_non_divisible(jmesh):
    check_geomorphons(walk(0, (45, 53)), cpu_mesh(), jmesh, lookup_pixels=3)


@pytest.mark.parametrize("lookup", [12, 30])
def test_sharded_geomorphons_multihop(jmesh, lookup):
    """8 x 8 blocks on the 2 x 4 mesh: lookup 12 gathers from two blocks,
    30 spans the whole mesh."""
    check_geomorphons(walk(0, (16, 32)), cpu_mesh(), jmesh,
                      lookup_pixels=lookup)


@pytest.mark.parametrize("shape", [(1, 8), (8, 1), (4, 2), (2, 4)])
def test_sharded_geomorphons_mesh_shapes(shape):
    check_geomorphons(walk(11, (64, 96)), cpu_mesh(shape),
                      japi.make_mesh(shape=shape), cellsize=2,
                      lookup_pixels=3)


def test_sharded_geomorphons_fast_ladder(jmesh, big_terrain):
    check_geomorphons(big_terrain, cpu_mesh(), jmesh, cellsize=2,
                      lookup_pixels=9, threshold_angle=1, fast=True)


@pytest.mark.parametrize("case", ["big_lookup4", "multihop_lookup12"])
def test_sharded_geomorphons_vs_pallas_engine(jmesh, big_terrain, case):
    if case == "big_lookup4":
        check_geomorphons(big_terrain, cpu_mesh(), jmesh, engine="pallas",
                          cellsize=2, lookup_pixels=4, threshold_angle=1)
    else:
        check_geomorphons(walk(0, (16, 32)), cpu_mesh(), jmesh,
                          engine="pallas", lookup_pixels=12)


def test_sharded_geomorphons_axis_names(big_terrain):
    """axis_names reversed shards rows over the mesh's second axis."""
    m = cpu_mesh((2, 4))
    a = sharded_geomorphons(big_terrain, m, lookup_pixels=5,
                            axis_names=("tx", "ty"))
    assert torch.equal(a, tvis.geomorphons(big_terrain, lookup_pixels=5,
                                           device="cpu"))
    with pytest.raises(ValueError, match="do not name"):
        sharded_geomorphons(big_terrain, m, axis_names=("a", "b"))


# ----------------------------------------------------------------------
# sharded_openness / sharded_skyview
# ----------------------------------------------------------------------
def test_sharded_openness(jmesh, big_terrain):
    kw = dict(cellsize=1.5, lookup_pixels=7)
    tiled = sharded_openness(big_terrain, cpu_mesh(), **kw)
    assert tiled.dtype == torch.float32 and tiled.shape == big_terrain.shape
    close_with_inf(tiled, tvis.openness(big_terrain, device="cpu", **kw),
                   OPENNESS_ATOL)
    ref = jax.jit(lambda A: japi.sharded_openness(A, jmesh, **kw))(
        jnp.asarray(big_terrain))
    close_with_inf(tiled, ref, OPENNESS_ATOL)


@pytest.mark.parametrize("R", [3, 14])
def test_sharded_skyview(jmesh, R):
    Z = walk(11, (45, 67))
    kw = dict(cellsize=2.0, lookup_pixels=R)
    tiled = sharded_skyview(Z, cpu_mesh(), **kw).numpy()
    assert tiled.shape == Z.shape
    np.testing.assert_allclose(
        tiled, tvis.skyview_factor(Z, device="cpu", **kw).numpy(),
        atol=SVF_ATOL, rtol=0)
    np.testing.assert_allclose(
        tiled, np.asarray(jax.jit(lambda A: japi.sharded_skyview(
            A, jmesh, **kw))(jnp.asarray(Z))),
        atol=SVF_ATOL, rtol=0)


# ----------------------------------------------------------------------
# halo_exchange_2d / sharded_apply
# ----------------------------------------------------------------------
def box3(p):
    """3 x 3 box sum of a radius-1 padded block, in one fixed order."""
    h, w = p.shape[0] - 2, p.shape[1] - 2
    return sum(p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))


def torch_halos(Z, mesh_shape, radius, mode):
    """Every padded block of the port's exchange, tiled as one array."""
    ny, nx = mesh_shape
    bh, bw = Z.shape[0] // ny, Z.shape[1] // nx
    blocks = [[torch.from_numpy(Z[y * bh:(y + 1) * bh, x * bw:(x + 1) * bw])
               for x in range(nx)] for y in range(ny)]
    padded = halo_exchange_2d(blocks, radius, mode)
    return torch.cat([torch.cat(row, dim=1) for row in padded]).numpy()


def jax_halos(Z, jmesh, radius, mode):
    spec = P("ty", "tx")
    f = shard_map(lambda b: jhalo_exchange_2d(b, radius, ("ty", "tx"),
                                              (2, 4), mode),
                  mesh=jmesh, in_specs=(spec,), out_specs=spec)
    return np.asarray(jax.jit(f)(jnp.asarray(Z)))


def jax_sharded_apply(fn, Z, jmesh, radius, mode):
    """The JAX package's ``sharded_apply`` under one ``jit`` (one compile
    instead of an eager shard_map op by op)."""
    return np.asarray(jax.jit(lambda A: japi.sharded_apply(
        fn, A, jmesh, radius=radius, mode=mode))(jnp.asarray(Z)))


@pytest.mark.parametrize("mode,radius", [
    ("symmetric", 1), ("edge", 1), ("linear", 1), ("zero", 1), ("nan", 1),
    ("none", 1), ("edge", 3),
    ("zero", 12), ("nan", 12), ("none", 12),   # multi-hop: 8 x 8 blocks
])
def test_halo_exchange_matches_jax(jmesh, mode, radius):
    Z = walk(0, (16, 32))
    np.testing.assert_array_equal(torch_halos(Z, (2, 4), radius, mode),
                                  jax_halos(Z, jmesh, radius, mode))


def linear_pad(Z, r):
    """Linear extrapolation by ``r`` on every side, columns first, in f32
    as the halo computes it."""
    def along(A, axis):
        A = np.moveaxis(A, axis, 0)
        d = np.arange(1, r + 1, dtype=np.float32)[:, None]
        head = A[0] + d[::-1] * (A[0] - A[1])
        tail = A[-1] + d * (A[-1] - A[-2])
        return np.moveaxis(np.concatenate([head, A, tail]), 0, axis)
    return along(along(Z, 1), 0)


@pytest.mark.parametrize("mode", ["symmetric", "edge", "linear"])
def test_halo_exchange_wide_reflect_family(mode):
    """At radius 2 the port's halos beyond the mesh are np.pad's
    'symmetric' / 'edge' and the linear extrapolation on every side.  (The
    JAX package's end-side 'symmetric' and 'linear' fills repeat the
    start side's order at radius >= 2; ROADMAP Queue 3.)"""
    Z = walk(2, (16, 32))
    r, (ny, nx), (bh, bw) = 2, (2, 4), (8, 8)
    full = (linear_pad(Z, r) if mode == "linear"
            else np.pad(Z, r, mode=mode))
    tiled = torch_halos(Z, (ny, nx), r, mode)
    for y in range(ny):
        for x in range(nx):
            got = tiled[y * (bh + 2 * r):(y + 1) * (bh + 2 * r),
                        x * (bw + 2 * r):(x + 1) * (bw + 2 * r)]
            want = full[y * bh:y * bh + bh + 2 * r, x * bw:x * bw + bw + 2 * r]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["edge", "symmetric", "zero"])
def test_sharded_apply_box_sum(jmesh, big_terrain, mode):
    ours = sharded_apply(box3, big_terrain, cpu_mesh(),
                         radius=1, mode=mode)
    ref = jax_sharded_apply(box3, big_terrain, jmesh, 1, mode)
    assert ours.shape == big_terrain.shape
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axis", [0, 1])
def test_sharded_apply_gradient_linear(jmesh, big_terrain, axis):
    ulp = float(np.spacing(np.abs(big_terrain).max()))
    ours = sharded_apply(lambda p: gradient2d(p)[axis], big_terrain,
                         cpu_mesh(), radius=1, mode="linear").numpy()
    single = gradient2d(torch.from_numpy(big_terrain))[axis].numpy()
    ref = jax_sharded_apply(lambda p: jgradient2d(p)[axis], big_terrain,
                            jmesh, 1, "linear")
    np.testing.assert_allclose(ours, single, atol=ulp, rtol=0)
    np.testing.assert_allclose(ours, ref, atol=ulp, rtol=0)


def test_sharded_apply_multihop_reflect_raises():
    with pytest.raises(ValueError, match="multi-hop|fewer shards"):
        sharded_apply(lambda p: p, walk(0, (16, 32)), cpu_mesh(), radius=12,
                      mode="symmetric")
    with pytest.raises(ValueError, match="not divisible"):
        sharded_apply(lambda p: p, walk(0, (15, 32)), cpu_mesh(), radius=1)
    with pytest.raises(ValueError, match="unknown halo mode"):
        sharded_apply(lambda p: p, walk(0, (16, 32)), cpu_mesh(), radius=1,
                      mode="wrap")


# ----------------------------------------------------------------------
# kernels against their plain versions on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_block_kernel_matches_plain_on_card(cuda_device, fast):
    Z = walk(3, (257, 389))
    Z[100:120, 40:90] = np.nan
    R, bh, bw = 23, 128, 194
    Zp = torch.from_numpy(np.pad(Z, R, constant_values=np.nan))
    for oy, ox in ((0, 0), (128, 0), (0, 194), (128, 194)):
        block = Zp[oy:oy + bh + 2 * R, ox:ox + bw + 2 * R].contiguous().to(
            cuda_device)
        args = (block, (oy, ox), Z.shape, R)
        kw = dict(cellsize=2.0, threshold_angle=1.0, fast=fast)
        k = cuda_scan.openness_counts_block_cuda(*args, **kw)
        p = cuda_scan.openness_counts_block_torch(*args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_extrema_origin_entry_matches_plain_on_card(cuda_device):
    Z = walk(3, (150, 230))
    Z[60:70, 40:90] = np.nan
    Zd = torch.from_numpy(Z).to(cuda_device)
    kw = dict(cellsize=2.0, lookup_pixels=17, origin=(-17, 40),
              global_shape=(140, 300))
    k = cuda_scan.directional_extrema_cuda(Zd, **kw)
    p = cuda_scan.directional_extrema_torch(Zd, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
