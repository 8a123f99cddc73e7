"""The PyTorch port's sharded SMRF (``neilpy_tpu_torch.dist``:
``sharded_springs_fill``, ``sharded_progressive_filter``,
``sharded_smrf``) held against the JAX package's sharded functions and
the port's single-device ones on the CPU.

The JAX side runs on conftest's 8-device virtual CPU mesh (2 x 4), each
reference computed once per module (its functions jit themselves: a few
seconds of compile each).  The port side runs on a mesh naming the host
eight times (2 x 4), on a 1 x 1 mesh and on a 3 x 3 mesh that divides
none of the rasters (its padding is masked out of the domain).  Inputs
are ``tests/test_dist.py``'s seeded fixtures and
``tests/test_smrf.py``'s building scene.

Tolerances (``tests/test_dist.py``): the ladder bit for bit; the springs
fill within 1e-4 of the single-device fill and of JAX's sharded fill
(the block-summed inner products round differently, so CG may stop at
another iteration); ``sharded_smrf`` object cells and point labels equal
on >= 99.9%, ``Zpro`` within 1e-3.
"""

import inspect

import numpy as np
import pytest
import torch

import neilpy_tpu as nt
import neilpy_tpu_torch as ntt
from neilpy_tpu.dist import smrf as jsmrf
from neilpy_tpu.dist.api import make_mesh as jmake_mesh
from neilpy_tpu_torch.dist import make_mesh
from neilpy_tpu_torch.dist import smrf as tsmrf
from neilpy_tpu_torch.ops import inpaint

torch.set_num_threads(1)
CPU = "cpu"
FILL_ATOL = 1e-4
ZPRO_ATOL = 1e-3
AGREE = 0.999


def cpu_mesh(n, shape=None):
    return make_mesh([CPU] * n, shape=shape)


MESHES = {"2x4": lambda: cpu_mesh(8), "1x1": lambda: cpu_mesh(1),
          "3x3": lambda: cpu_mesh(9, (3, 3))}


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh()  # 2 x 4 over conftest's 8 CPU devices


def hole_fixture():
    """tests/test_dist.py:102-111: 70 x 90, two holes."""
    A = np.random.default_rng(3).normal(size=(70, 90)).astype(
        np.float32).cumsum(axis=0)
    A[10:20, 30:50] = np.nan
    A[40:42, 5:80] = np.nan
    return A


def big_hole_fixture():
    """tests/test_dist.py:113-127: 128 x 128, one large hole."""
    A = np.random.default_rng(9).normal(size=(128, 128)).astype(
        np.float32).cumsum(axis=0)
    A[20:90, 35:100] = np.nan
    A[5, 5] = np.nan
    return A


def building_scene(seed=12345, n=4000):
    """tests/test_smrf.py:140-156's scene: 50 x 40 m, a 6 m box."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 50, n)
    y = rng.uniform(0, 40, n)
    z = rng.normal(0, 0.1, n) + 0.02 * x
    return x, y, z + 6.0 * ((x > 15) & (x < 25) & (y > 10) & (y < 25))


FILLS = {"holes": (hole_fixture, 256), "big_hole": (big_hole_fixture, 8)}


@pytest.fixture(scope="module")
def jax_fills(jmesh):
    return {name: np.asarray(jsmrf.sharded_springs_fill(
        make(), jmesh, mg_min_block=mgb))
        for name, (make, mgb) in FILLS.items()}


# ----------------------------------------------------------------------
# the springs fill
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fixture", list(FILLS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_springs_fill_matches_single_and_jax(fixture, mesh, jax_fills):
    make, mgb = FILLS[fixture]
    A = make()
    got = ntt.dist.sharded_springs_fill(A, MESHES[mesh](),
                                        mg_min_block=mgb)
    single = ntt.inpaint_nans_by_springs(A, device=CPU)
    assert got.shape == A.shape and got.dtype == torch.float32
    known = np.isfinite(A)
    np.testing.assert_array_equal(got.numpy()[known], A[known])
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=FILL_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), jax_fills[fixture],
                               atol=FILL_ATOL, rtol=0)


def test_small_min_block_keeps_sharded_levels():
    """With ``mg_min_block=8`` the 128^2 fixture's 64 x 32 blocks coarsen
    twice before the hand-off, so the halo-exchanged coarse applies and
    the gather run (the default keeps one sharded level)."""
    L, blocks, _ = tsmrf._layout(big_hole_fixture(), cpu_mesh(8), ("ty",
                                                                   "tx"))
    unknown = [torch.isnan(b).float() for b in blocks]
    deg = [L.degree(b.shape, o, b.device)
           for b, o in zip(blocks, L.origins)]
    slevels, clevels = tsmrf._sharded_mg_levels(L, unknown, deg, 8)
    assert [tuple(lv[3][0].shape) for lv in slevels] == [(64, 32), (32, 16),
                                                         (16, 8)]
    assert tuple(clevels[0][3].shape) == (32, 32)
    assert min(clevels[-1][3].shape) <= 4
    default, _ = tsmrf._sharded_mg_levels(L, unknown, deg)
    assert len(default) == 1


def test_fill_reads_the_stop_flag_every_check():
    """The CG loop syncs with the host every CHECK_EVERY_MULTIGRID
    iterations, as the single-device solve does, and reports its
    iterations."""
    _, info = tsmrf._sharded_fill(hole_fixture(), cpu_mesh(8), ("ty", "tx"),
                                  1e-7, 4000, 256)
    assert 0 < info["iterations"] < 4000
    assert info["host_syncs"] == -(-info["iterations"]
                                   // inpaint.CHECK_EVERY_MULTIGRID)


def test_fill_mesh_padding_is_never_inpainted():
    """A raster the mesh does not divide: the padded cells lie outside the
    domain, so a fill of a raster with no NaN changes nothing."""
    A = np.random.default_rng(5).normal(size=(31, 45)).astype(np.float32)
    got = ntt.dist.sharded_springs_fill(A, cpu_mesh(9, (3, 3)))
    np.testing.assert_array_equal(got.numpy(), A)


# ----------------------------------------------------------------------
# the progressive filter
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ladder_raster():
    """tests/test_dist.py:129-138."""
    return np.random.default_rng(4).normal(size=(96, 112)).astype(
        np.float32).cumsum(axis=1)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_progressive_filter_bit_exact(mesh, ladder_raster, jmesh):
    w = np.arange(1, 8)
    got = ntt.dist.sharded_progressive_filter(ladder_raster, w,
                                              MESHES[mesh](), 1, .15)
    single = ntt.progressive_filter(ladder_raster, w, 1, .15, device=CPU)
    assert got.dtype == torch.bool
    assert torch.equal(got, single)
    if mesh == "2x4":
        want = np.asarray(jsmrf.sharded_progressive_filter(
            ladder_raster, w, jmesh, 1, .15))
        np.testing.assert_array_equal(got.numpy(), want)


def test_progressive_filter_radius_beyond_a_block():
    """Windows wider than a 3 x 3 mesh's blocks take multi-hop halos and
    still equal the single-device ladder, with NaN holes and a cellsize."""
    Z = np.random.default_rng(6).normal(size=(40, 47)).cumsum(axis=0)
    Z = Z.astype(np.float32)
    Z[10:14, 20:30] = np.nan
    w = np.array([1, 3, 9, 18])
    got = ntt.dist.sharded_progressive_filter(Z, w, cpu_mesh(9, (3, 3)),
                                              cellsize=2.5)
    assert torch.equal(got, ntt.progressive_filter(Z, w, cellsize=2.5,
                                                   device=CPU))


# ----------------------------------------------------------------------
# the whole pipeline
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_smrf(jmesh):
    x, y, z = building_scene()
    return tuple(np.asarray(a) if i != 1 else a for i, a in enumerate(
        jsmrf.sharded_smrf(x, y, z, 1, 6, .15, .5, 1.25, mesh=jmesh)))


@pytest.mark.parametrize("mesh", ["2x4", "3x3"])
def test_sharded_smrf_matches(mesh, jax_smrf):
    x, y, z = building_scene()
    Zp, t, cells, pts = ntt.dist.sharded_smrf(x, y, z, 1, 6, .15, .5, 1.25,
                                              mesh=MESHES[mesh]())
    sZp, st, scells, spts = ntt.smrf(x, y, z, 1, 6, .15, .5, 1.25,
                                     device=CPU)
    jZp, jt, jcells, jpts = jax_smrf
    assert tuple(t) == tuple(st) == tuple(jt)
    assert pts.shape == (x.size,) and pts.dtype == torch.bool
    for want_cells, want_pts, want_Zp in ((scells.numpy(), spts.numpy(),
                                           sZp.numpy()),
                                          (jcells, jpts, jZp)):
        assert (cells.numpy() == want_cells).mean() >= AGREE
        assert (pts.numpy() == want_pts).mean() >= AGREE
        np.testing.assert_allclose(Zp.numpy(), want_Zp, atol=ZPRO_ATOL,
                                   rtol=0)
    # the box is found and the ground kept
    box = (x > 16) & (x < 24) & (y > 11) & (y < 24)
    assert pts.numpy()[box].mean() > 0.9
    assert pts.numpy()[~box & ((x < 13) | (x > 27))].mean() < 0.1


def test_sharded_smrf_low_outlier_refill_and_stage_hook():
    """``low_outlier_fill=True`` runs the refill; the stage hook sees
    every stage once, the fills with their CG counts."""
    x, y, z = building_scene(seed=7, n=3000)
    z = z.copy()
    z[::97] -= 15.0   # low outliers
    seen = []
    out = tsmrf._sharded_smrf_run(
        x, y, z, 1, 5, .15, .5, 1.25, 5, True, cpu_mesh(8), ("ty", "tx"),
        1e-7, 4000, 256, mark=lambda stage, **info: seen.append((stage,
                                                                  info)))
    single = ntt.smrf(x, y, z, 1, 5, low_outlier_fill=True, device=CPU)
    assert (out[2].numpy() == single[2].numpy()).mean() >= AGREE
    assert (out[3].numpy() == single[3].numpy()).mean() >= AGREE
    assert [s for s, _ in seen] == [
        "gridding", "springs_fill", "low_outlier_opening", "springs_refill",
        "ladder", "springs_fill_dtm", "spline_coefficients", "points"]
    assert all(info["iterations"] > 0 for s, info in seen
               if s.startswith("springs"))


# ----------------------------------------------------------------------
# the public names
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sharded_smrf", "sharded_springs_fill",
                                  "sharded_progressive_filter"])
def test_sharded_smrf_names_match_the_jax_package(name):
    """The JAX arguments and defaults in order, then ``device=None``."""
    ours = inspect.signature(getattr(ntt.dist, name)).parameters
    theirs = inspect.signature(getattr(nt.dist, name)).parameters
    assert list(ours) == list(theirs) + ["device"]
    for p in theirs:
        assert ours[p].default == theirs[p].default, p
    assert ours["device"].default is None


def test_mesh_defaults():
    """``mesh=None`` with ``device=`` is a 1 x 1 mesh of that device;
    without either it takes the CUDA devices and raises on a host without
    one."""
    A = hole_fixture()
    got = ntt.dist.sharded_springs_fill(A, device=CPU)
    np.testing.assert_allclose(got.numpy(), ntt.inpaint_nans_by_springs(
        A, device=CPU).numpy(), atol=FILL_ATOL, rtol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ntt.dist.sharded_progressive_filter(A, [1, 2])


# ----------------------------------------------------------------------
# on the card only
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sharded_smrf_on_card_matches_cpu(cuda_device):
    x, y, z = building_scene()
    mesh = make_mesh([cuda_device] * 4)
    Zp, _, cells, pts = ntt.dist.sharded_smrf(x, y, z, 1, 6, mesh=mesh)
    cZp, _, ccells, cpts = ntt.dist.sharded_smrf(x, y, z, 1, 6,
                                                 mesh=cpu_mesh(4))
    assert pts.is_cuda
    assert (pts.cpu() == cpts).float().mean() >= AGREE
    assert (cells.cpu() == ccells).float().mean() >= AGREE
    torch.testing.assert_close(Zp.cpu(), cZp, atol=ZPRO_ATOL, rtol=0)
