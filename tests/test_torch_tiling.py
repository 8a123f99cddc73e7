"""The PyTorch port's out-of-core stream (``neilpy_tpu_torch``:
``tiled_apply``, ``apply_parallel``, ``TileCheckpoint``,
``mosaic_terrain_products`` and ``GeoTiffSource``'s array surface) held
against the JAX package and against the port's untiled functions on the
CPU (``device='cpu'``: plain copies, the plain versions of K1 and K2).

Every ``tests/test_tiling.py`` case with a counterpart here has one.  The
JAX references are computed once per module: three mosaics (the exact
wire of all six products, the compact wire with uint8 Moran bins, the
uint16 upload) and four jitted tile programs (``_make_product_body``)
whose wire bytes the port's must equal bit for bit.

Tolerances: classes, object cells and Gi bins exactly; Moran's I within
1e-5 of JAX and 1e-6 of the port's untiled ``local_morans_i``; openness
within 1e-4 degrees of JAX (XLA divides where the port multiplies by
``cuda_scan._ladder_scales``), bf16 planes within one bf16 step; every
wire byte equal; tiled == untiled in the interior (``overlap`` px from
the edge); resumed == uninterrupted, bit for bit.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import neilpy_tpu as nt
import neilpy_tpu_torch as ntt
from neilpy_tpu.dist.tiling import (TileCheckpoint as JTileCheckpoint,
                                    _unpack_host as junpack)
from neilpy_tpu.io.geotiff import GeoTiffSource as JGeoTiffSource
from neilpy_tpu.pipelines import mosaic as jmosaic
from neilpy_tpu_torch.dist import make_mesh, tiling
from neilpy_tpu_torch.dist.tiling import TileCheckpoint, tiled_apply
from neilpy_tpu_torch.pipelines import mosaic
from neilpy_tpu_torch.pipelines.mosaic import (mosaic_terrain_products,
                                               required_overlap)

torch.set_num_threads(1)
CPU = "cpu"
SIX = ("geomorphons", "objects", "moran", "gi", "openness_pos",
       "openness_neg")
KW = dict(cellsize=1, lookup_pixels=4, windows=np.array([1, 2]),
          gi_radius=2, tile_size=48)
OV = 6                     # required_overlap(4, [1, 2], 2)
MORAN_ATOL = 1e-5
OPENNESS_ATOL = 1e-4


def walk(seed, shape, axis=0):
    return np.random.default_rng(seed).normal(size=shape).cumsum(
        axis=axis).astype(np.float32)


@pytest.fixture(scope="module")
def Z1():
    """100 x 110 with a NaN hole across a tile seam (tests/test_tiling.py's
    Gi* fixture shape)."""
    Z = walk(1, (100, 110))
    Z[40:43, 50:55] = np.nan
    return Z


def same(a, b):
    """Bit-for-bit equality of host arrays, NaN where NaN."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


def assert_products(got, want, openness_atol=OPENNESS_ATOL,
                    moran_atol=MORAN_ATOL):
    """The port's six products against JAX's at the stated tolerances."""
    assert len(got) == len(want)
    for p, g, w in zip(SIX, got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, p
        if p in ("geomorphons", "objects", "gi"):
            np.testing.assert_array_equal(g, w, err_msg=p)
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            atol = moran_atol if p == "moran" else openness_atol
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=p)


# ----------------------------------------------------------------------
# the JAX references, once per module
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_exact(Z1):
    return jmosaic.mosaic_terrain_products(Z1, products=SIX, wire="exact",
                                           **KW)


@pytest.fixture(scope="module")
def jax_compact(Z1):
    return jmosaic.mosaic_terrain_products(Z1, products=SIX, wire="compact",
                                           float_wire="uint8", **KW)


@pytest.fixture(scope="module")
def port_exact(Z1):
    return mosaic_terrain_products(Z1, products=SIX, wire="exact",
                                   device=CPU, **KW)


# ----------------------------------------------------------------------
# tiled_apply
# ----------------------------------------------------------------------
def test_tiled_hillshade_matches_interior():
    Z = walk(2, (100, 130))
    full = ntt.hillshade(Z, cellsize=2, device=CPU).numpy()
    tiled = tiled_apply(lambda b: ntt.hillshade(b, cellsize=2), Z,
                        tile_size=40, overlap=4, device=CPU)
    assert tiled.dtype == np.uint8
    np.testing.assert_array_equal(tiled[4:-4, 4:-4], full[4:-4, 4:-4])


def test_tiled_geomorphons_matches_interior():
    Z = walk(3, (90, 110)).cumsum(axis=1)
    full = ntt.geomorphons(Z, lookup_pixels=5, device=CPU).numpy()
    tiled = tiled_apply(lambda b: ntt.geomorphons(b, lookup_pixels=5), Z,
                        tile_size=40, overlap=5, device=CPU)
    np.testing.assert_array_equal(tiled[5:-5, 5:-5], full[5:-5, 5:-5])


def test_checkpoint_resume(tmp_path):
    Z = walk(4, (60, 60))
    ck = str(tmp_path / "tiles.json")
    calls = []

    def fn(b):
        calls.append(1)
        return b * 2

    out1 = tiled_apply(fn, Z, tile_size=20, overlap=2, checkpoint=ck,
                       device=CPU)
    assert len(calls) == 9
    out2 = tiled_apply(fn, Z, tile_size=20, overlap=2, checkpoint=ck,
                       out=out1, device=CPU)
    assert len(calls) == 9 and out2 is out1
    np.testing.assert_array_equal(out1, Z * 2)
    with open(ck) as f:
        assert json.load(f) == [[ty, tx] for ty in range(3)
                                for tx in range(3)]


def test_partial_resume(tmp_path):
    Z = walk(5, (40, 40))
    ck = str(tmp_path / "t.json")
    TileCheckpoint(ck).mark((0, 0))
    out = np.zeros_like(Z)
    tiled_apply(lambda b: b + 1, Z, tile_size=20, overlap=0, out=out,
                checkpoint=ck, device=CPU)
    assert (out[:20, :20] == 0).all()
    np.testing.assert_array_equal(out[20:, 20:], Z[20:, 20:] + 1)


def test_completed_checkpoint_without_out_raises(tmp_path):
    Z = np.ones((20, 20), dtype=np.float32)
    ck = str(tmp_path / "c.json")
    tiled_apply(lambda b: b, Z, tile_size=20, overlap=0, checkpoint=ck,
                device=CPU)
    with pytest.raises(ValueError, match="every tile done"):
        tiled_apply(lambda b: b, Z, tile_size=20, overlap=0, checkpoint=ck,
                    device=CPU)


def test_checkpoint_file_is_shared_with_the_jax_package(tmp_path):
    """A sidecar written by the JAX package's TileCheckpoint is read by the
    port's, and the port writes the same bytes."""
    keys = [(2, 1), (0, 3), (1, 0)]
    jc = JTileCheckpoint(str(tmp_path / "jax.json"))
    tc = TileCheckpoint(str(tmp_path / "port.json"))
    for k in keys:
        jc.mark(k)
        tc.mark(k)
    assert TileCheckpoint(str(tmp_path / "jax.json")).done == set(keys)
    assert JTileCheckpoint(str(tmp_path / "port.json")).done == set(keys)
    assert (tmp_path / "jax.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()
    assert not (tmp_path / "port.json.tmp").exists()


def test_apply_parallel_reference_signature():
    """skimage.util.apply_parallel drop-in: interior pixels equal the
    untiled result, only the depth-wide band feels the padding."""
    Z = walk(0, (120, 150))
    fn = lambda b: ntt.geomorphons(b, cellsize=2, lookup_pixels=5)
    full = fn(torch.from_numpy(Z)).numpy()
    tiled = ntt.apply_parallel(fn, Z, 64, 5, device=CPU)
    band = np.zeros(Z.shape, bool)
    band[:5, :] = band[-5:, :] = band[:, :5] = band[:, -5:] = True
    assert not ((tiled != full) & ~band).any()
    np.testing.assert_array_equal(ntt.apply_parallel(fn, Z, device=CPU),
                                  full)
    fn2 = lambda b, cs, lookup_pixels=1: ntt.geomorphons(
        b, cellsize=cs, lookup_pixels=lookup_pixels)
    t2 = ntt.apply_parallel(fn2, Z, (64, 64), 5, extra_arguments=(2,),
                            extra_keywords={"lookup_pixels": 5}, device=CPU)
    np.testing.assert_array_equal(t2, tiled)
    with pytest.raises(ValueError, match="square tiles"):
        ntt.apply_parallel(fn, Z, (64, 32), 5, device=CPU)


def test_tiled_apply_lazy_source_streaming(tmp_path):
    Z = walk(6, (70, 90))
    fn = str(tmp_path / "z.tif")
    ntt.write_geotiff(fn, Z)
    got = tiled_apply(lambda a: a * 2 + 1, ntt.GeoTiffSource(fn),
                      tile_size=32, overlap=4, device_input=False,
                      device=CPU)
    np.testing.assert_array_equal(got, Z * 2 + 1)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float64])
@pytest.mark.parametrize("device_input", [False, "auto", True])
def test_tiled_apply_preserves_input_dtype(dt, device_input):
    """The tile reaches ``fn`` in the source's dtype on every path (uint16
    travels as int16 and is viewed back)."""
    Z = (np.random.default_rng(7).random((70, 90)) * 100).astype(dt)
    seen = set()

    def fn(a):
        seen.add(np.asarray(a).dtype)
        return a

    got = tiled_apply(fn, Z, tile_size=32, overlap=4,
                      device_input=device_input, device=CPU)
    assert seen == {np.dtype(dt)} and got.dtype == np.dtype(dt)
    np.testing.assert_array_equal(got, Z)


def test_auto_device_input_follows_the_jax_dtype_rule(monkeypatch):
    """'auto' puts an input on the device only within the budget and only
    where the JAX package's device path keeps its dtype."""
    built = []
    real = tiling.pad_edge
    monkeypatch.setattr(tiling, "pad_edge",
                        lambda *a: built.append(1) or real(*a))
    for dt, budget, resident in ((np.float32, 4 << 30, True),
                                 (np.float32, 1000, False),
                                 (np.float64, 4 << 30, False),
                                 (np.int64, 4 << 30, False)):
        built.clear()
        Z = np.arange(40 * 50).reshape(40, 50).astype(dt)
        got = tiled_apply(lambda a: a, Z, 16, 2, device=CPU,
                          device_input_budget=budget)
        np.testing.assert_array_equal(got, Z)
        assert bool(built) == resident, (dt, budget)


def test_device_resident_stripes_span_row_chunks(tmp_path):
    """An overlap wider than the tile makes every stripe span several row
    chunks: stitching, edge replication and a resume that skips tiles
    inside rows equal the host streaming path."""
    Z = walk(8, (70, 90))

    def sten(b):
        return b + torch.roll(b, 1, 0) + torch.roll(b, -1, 1)

    want = tiled_apply(sten, Z, tile_size=16, overlap=20,
                       device_input=False, device=CPU)
    got = tiled_apply(sten, Z, tile_size=16, overlap=20, device_input=True,
                      device=CPU)
    np.testing.assert_array_equal(got, want)
    ck = str(tmp_path / "tiles.json")
    out = np.zeros_like(want)
    for ty, tx in ((0, 0), (1, 1), (2, 3)):
        sl = np.s_[ty * 16:(ty + 1) * 16, tx * 16:(tx + 1) * 16]
        out[sl] = want[sl]
        TileCheckpoint(ck).mark((ty, tx))
    got2 = tiled_apply(sten, Z, tile_size=16, overlap=20, out=out,
                       checkpoint=ck, device_input=True, device=CPU)
    np.testing.assert_array_equal(got2, want)


def test_prefetch_checkpoint_resume(tmp_path):
    Z = walk(9, (70, 90))
    want = Z * 3 + 2
    ck = str(tmp_path / "tiles.json")
    out = np.zeros_like(want)
    out[:32, :32] = want[:32, :32]
    TileCheckpoint(ck).mark((0, 0))
    got = tiled_apply(lambda a: a * 3 + 2, Z, tile_size=32, overlap=4,
                      out=out, checkpoint=ck, prefetch=True, device=CPU)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prefetch", [False, True])
def test_producer_errors_reach_the_caller(prefetch):
    class Boom:
        shape = (64, 64)
        dtype = np.dtype(np.float32)
        nbytes = 64 * 64 * 4

        def __getitem__(self, idx):
            raise RuntimeError("source read failed")

    with pytest.raises(RuntimeError, match="source read failed"):
        tiled_apply(lambda a: a + 1, Boom(), tile_size=32, overlap=4,
                    device_input=False, prefetch=prefetch, device=CPU)


def test_tuple_results_and_out_dtype():
    """A tuple-returning ``fn`` gives a tuple of outputs, ``out_dtype`` per
    product; numpy results pass through as they are."""
    Z = walk(10, (50, 70))
    a, b, c = tiled_apply(lambda t: (t > 0, t * 2, (t + 1).numpy()), Z,
                          tile_size=24, overlap=3, out_dtype=(None, np.float64,
                                                              None),
                          device=CPU)
    np.testing.assert_array_equal(a, Z > 0)
    assert b.dtype == np.float64 and c.dtype == np.float32
    np.testing.assert_array_equal(b, (Z * 2).astype(np.float64))
    np.testing.assert_array_equal(c, Z + 1)


def test_wire_fn_row_chunks_and_decode():
    """A ``wire_fn`` returning its wire buffer as row chunks (the JAX
    package's form) with ``wire_specs`` and ``decode``: the chunks land in
    one host buffer, decoded per tile."""
    Z = (np.random.default_rng(19).random((50, 70)) * 200).astype(np.uint8)
    ts, ov = 24, 3

    def wire_fn(b):
        core = b[ov:ov + ts, ov:ov + ts]
        return [core[:5], core[5:17], core[17:]]

    (got,) = tiled_apply(None, Z, ts, ov, wire_fn=wire_fn,
                         wire_specs=[(np.dtype(np.uint8), 1)],
                         decode=lambda res: (res[0] // 2,), device=CPU)
    np.testing.assert_array_equal(got, Z // 2)


def test_numpy_tiles_need_a_device():
    """The tiles live on ``device``, CUDA by default: without a card the
    call raises instead of running on the host unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tiled_apply(lambda a: a, np.zeros((8, 8), np.float32), 4, 1)


# ----------------------------------------------------------------------
# the mosaic against the JAX package
# ----------------------------------------------------------------------
def test_mosaic_exact_matches_jax(port_exact, jax_exact):
    assert_products(port_exact, jax_exact)


def test_mosaic_compact_matches_jax(Z1, jax_compact, port_exact):
    got = mosaic_terrain_products(Z1, products=SIX, wire="compact",
                                  float_wire="uint8", device=CPU, **KW)
    assert_products(got, jax_compact, openness_atol=0.5)
    # compact is exact where it is exact, bf16 of exact elsewhere
    for i in (0, 1, 3):
        assert same(got[i], port_exact[i])
    for i in (4, 5):
        bf = torch.from_numpy(port_exact[i]).to(torch.bfloat16).float()
        assert same(got[i], bf.numpy())
    fin = np.isfinite(port_exact[2])
    np.testing.assert_array_equal(np.isfinite(got[2]), fin)
    clipped = np.clip(port_exact[2][fin], -8.0, 8.0)
    assert np.max(np.abs(clipped - got[2][fin])) <= 16 / 254 / 2 + 1e-6


def test_mosaic_products_match_the_untiled_functions(Z1, port_exact):
    """tiled == untiled at least ``overlap`` px from the mosaic's edge;
    Moran and Gi* against the streamed global moments."""
    G, O, MI, S, OP, ON = port_exact
    s = np.s_[OV:-OV, OV:-OV]
    t = torch.from_numpy(Z1)
    m = np.isfinite(Z1)
    mean = Z1[m].astype(np.float64).sum() / m.sum()
    s2 = (Z1[m].astype(np.float64) ** 2).sum() / m.sum() - mean ** 2
    np.testing.assert_array_equal(
        G[s], ntt.geomorphons(t, 1, 4, 1).numpy()[s])
    np.testing.assert_array_equal(
        O[s], ntt.progressive_filter(t, [1, 2], 1, .15).numpy()[s])
    np.testing.assert_allclose(MI[s], ntt.local_morans_i(
        t, 2, mean=mean, s2=s2).numpy()[s], atol=1e-6, rtol=0)
    _, _, full = ntt.rasterGi(t, 2, star=True, global_mean=mean,
                              global_var=s2, global_n=int(m.sum()))
    assert same(S[s], full.numpy()[s])
    pos, neg = ntt.openness_pair(t, 1, 4)
    np.testing.assert_array_equal(OP[s], pos.numpy()[s])
    np.testing.assert_array_equal(ON[s], neg.numpy()[s])
    assert set(np.unique(S[np.isfinite(S)])) <= {-3., -2., -1., 0., 1., 2.,
                                                 3.}


@pytest.fixture(scope="module")
def jax_quantized(Z1):
    return jmosaic.mosaic_terrain_products(Z1, upload_dtype="uint16", **KW)


def test_mosaic_quantized_upload(Z1, jax_quantized):
    """``upload_dtype='uint16'``: equal bit for bit to the mosaic of the
    dequantized raster (the port decodes as ``dequantized`` rounds), within
    the JAX package's own tolerances of its quantized mosaic (it decodes
    with one fused multiply-add), the error bound kept and the holes
    kept."""
    Gq, Oq, Mq = mosaic_terrain_products(Z1, upload_dtype="uint16",
                                         device=CPU, **KW)
    fin = Z1[np.isfinite(Z1)]
    Zdq = mosaic._QuantizedSource(Z1, fin.min(), fin.max()).dequantized()
    assert np.array_equal(np.isnan(Zdq), np.isnan(Z1))
    bound = (float(fin.max()) - float(fin.min())) / 65534 * 0.505
    assert np.nanmax(np.abs(Zdq - Z1)) <= bound + 1e-6
    G2, O2, M2 = mosaic_terrain_products(Zdq, device=CPU, **KW)
    assert same(Gq, G2) and same(Oq, O2)
    np.testing.assert_allclose(Mq, M2, atol=1e-3, rtol=1e-3)
    jG, jO, jM = jax_quantized
    assert np.mean(Gq == jG) >= 0.9999 and np.mean(Oq == jO) >= 0.9999
    np.testing.assert_allclose(Mq, jM, atol=1e-3, rtol=1e-3)


def test_mosaic_quantized_noop_for_narrow_dtypes():
    Z = (walk(11, (70, 80)) * 50).astype(np.int16)
    kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
              gi_radius=1, tile_size=48, device=CPU)
    a = mosaic_terrain_products(Z, **kw)
    b = mosaic_terrain_products(Z, upload_dtype="uint16", **kw)
    c = mosaic_terrain_products(Z.astype(np.float32), **kw)
    for x, y, z in zip(a, b, c):
        assert same(x, y) and same(x, z)
    with pytest.raises(ValueError):
        mosaic_terrain_products(Z, upload_dtype="int8", **kw)


def test_mosaic_products_opt_in_and_errors(Z1, port_exact):
    kw = dict(KW, device=CPU)
    (G,) = mosaic_terrain_products(Z1, products=("geomorphons",), **kw)
    assert same(G, port_exact[0])
    (O,) = mosaic_terrain_products(Z1, products=("objects",), **kw)
    assert same(O, port_exact[1])
    (M,) = mosaic_terrain_products(Z1, products=("moran",), **kw)
    assert same(M, port_exact[2])
    trio = mosaic_terrain_products(Z1, **kw)
    assert len(trio) == 3 and all(same(a, b)
                                  for a, b in zip(trio, port_exact))
    six = mosaic_terrain_products(Z1, gi_star=True, openness=True, **kw)
    assert all(same(a, b) for a, b in zip(six, port_exact))
    assert required_overlap(4, np.array([1, 2]), 2, ("geomorphons",)) == 4
    assert required_overlap(4, np.array([1, 2]), 2, ("moran",)) == 3
    assert required_overlap(4, np.array([1, 2]), 2, ("objects",)) == 6
    assert required_overlap(4, np.array([1, 2, 3]), 2) == 12
    for bad, match in ((("nope",), "unknown"), (("openness_pos",), "pair"),
                       ((), "at least one")):
        with pytest.raises(ValueError, match=match):
            mosaic_terrain_products(Z1, products=bad, **kw)
    with pytest.raises(ValueError, match="float_wire"):
        mosaic_terrain_products(Z1, float_wire="float16", **kw)
    with pytest.raises(ValueError, match="CUDA"):
        mosaic_terrain_products(Z1, use_pallas=True, **kw)
    # 'auto' is the exact wire in the port; use_pallas=False is the plain
    # version, as None is on the CPU
    auto = mosaic_terrain_products(Z1, products=SIX, wire="auto",
                                   use_pallas=False, **kw)
    assert all(same(a, b) for a, b in zip(auto, port_exact))


def test_mosaic_objects_bitpacked_wire():
    Z = walk(12, (100, 88))
    kw = dict(cellsize=1, windows=np.array([1, 2]), tile_size=48,
              products=("objects",), device=CPU)
    (O1,) = mosaic_terrain_products(Z, wire="exact", **kw)
    (O2,) = mosaic_terrain_products(Z, wire="compact", **kw)
    assert same(O1, O2) and O1.dtype == bool
    assert mosaic._wire_specs(True, ("objects",), bitpack=True) == \
        [(np.dtype(np.uint8), 0.125)]


@pytest.mark.parametrize("variant", [
    dict(device_input=False), dict(device_input=True),
    dict(device_input=False, prefetch=True), dict(wire_chunks=3),
    dict(pipeline_depth=0)])
def test_mosaic_transport_variants_equal(Z1, port_exact, variant):
    """Resident and streamed input, the prefetch thread, the wire split
    into row chunks and no pipelining give the same bits."""
    ps = {}
    got = mosaic_terrain_products(Z1, products=SIX, wire="exact",
                                  phase_stats=ps, device=CPU, **variant,
                                  **KW)
    assert all(same(a, b) for a, b in zip(got, port_exact))
    assert ps["tiles"] == 9 and ps["total"] > 0
    for key in ("dispatch", "readback_wait", "store_wait", "upload"):
        assert key in ps, key


def test_moments_sidecar_is_tied_to_the_input(tmp_path):
    kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
              gi_radius=1, tile_size=48, device=CPU)
    A = walk(13, (96, 96))
    B = (walk(14, (96, 96), axis=1) * 50 + 1000.0).astype(np.float32)
    ck = str(tmp_path / "mosaic.json")
    mosaic_terrain_products(A, checkpoint=ck, **kw)
    assert os.path.exists(ck + ".moments")
    os.remove(ck)
    _, _, M_resumed = mosaic_terrain_products(B, checkpoint=ck, **kw)
    _, _, M_clean = mosaic_terrain_products(B, **kw)
    assert same(M_resumed, M_clean)
    with open(ck + ".moments") as f:
        mom = json.load(f)
    assert mom["input_fp"] == jmosaic._input_fingerprint(B)
    # the same input is read from the sidecar: doctored moments are used
    os.remove(ck)
    with open(ck + ".moments", "w") as f:
        json.dump(dict(mom, mean=mom["mean"] + 1.0), f)
    _, _, M_doctored = mosaic_terrain_products(B, checkpoint=ck, **kw)
    assert not np.allclose(M_doctored, M_clean, equal_nan=True)


def test_mosaic_resume_equals_uninterrupted(Z1, port_exact, tmp_path):
    """A run stopped after some tiles (their outputs stored, the rest
    zero) resumes the missing tiles only; the moments come from the
    sidecar."""
    ck = str(tmp_path / "m.json")
    kw = dict(products=SIX, wire="exact", device=CPU, **KW)
    mosaic_terrain_products(Z1, checkpoint=ck, **kw)
    outs = tuple(np.zeros_like(a) for a in port_exact)
    done = [(0, 1), (2, 2), (1, 0)]
    with open(ck, "w") as f:
        json.dump(sorted(done), f)
    for ty, tx in done:
        sl = np.s_[ty * 48:(ty + 1) * 48, tx * 48:(tx + 1) * 48]
        for o, a in zip(outs, port_exact):
            o[sl] = a[sl]
    ps = {}
    got = mosaic_terrain_products(Z1, checkpoint=ck, out=outs,
                                  phase_stats=ps, **kw)
    assert ps["tiles"] == 6
    assert all(same(a, b) for a, b in zip(got, port_exact))
    assert TileCheckpoint(ck).done == {(ty, tx) for ty in range(3)
                                       for tx in range(3)}


def test_mosaic_from_geotiff_source(tmp_path):
    Z = walk(15, (96, 80))
    fn = str(tmp_path / "dem.tif")
    ntt.write_geotiff(fn, Z, compress="deflate", tiled=True, tile_size=32)
    kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
              gi_radius=1, tile_size=48, device=CPU)
    a = mosaic_terrain_products(Z, **kw)
    b = mosaic_terrain_products(ntt.GeoTiffSource(fn), **kw)
    assert all(same(x, y) for x, y in zip(a, b))


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh8():
    return make_mesh([CPU] * 8)


def test_mesh_matches_single(mesh8, Z1, port_exact):
    ps = {}
    got = mosaic_terrain_products(Z1, products=SIX, wire="exact",
                                  mesh=mesh8, phase_stats=ps, **KW)
    assert all(same(a, b) for a, b in zip(got, port_exact))
    for key in ("host_read", "upload", "dispatch", "readback_wait",
                "store_wait", "tiles", "total"):
        assert key in ps, key
    assert ps["tiles"] == 9
    q1 = mosaic_terrain_products(Z1, upload_dtype="uint16", device=CPU, **KW)
    q2 = mosaic_terrain_products(Z1, upload_dtype="uint16", mesh=mesh8, **KW)
    assert all(same(a, b) for a, b in zip(q1, q2))
    c1 = mosaic_terrain_products(Z1, wire="compact", device=CPU, **KW)
    c2 = mosaic_terrain_products(Z1, wire="compact", mesh=make_mesh(
        [CPU] * 4), **KW)
    assert all(same(a, b) for a, b in zip(c1, c2))


def test_mesh_checkpoint_resume(mesh8, tmp_path):
    """Per-tile keys survive the grouped dispatch: a pre-marked subset (as
    a kill mid-group leaves) resumes only the missing tiles."""
    Z = walk(16, (190, 230))
    kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
              gi_radius=1, tile_size=48)
    full = mosaic_terrain_products(Z, device=CPU, **kw)
    c = TileCheckpoint(str(tmp_path / "partial.json"))
    done = [(0, 0), (1, 2), (2, 4), (3, 1), (0, 3)]
    for k in done:
        c.mark(k)
    outs = tuple(np.zeros_like(a) for a in full)
    for ty, tx in done:
        sl = np.s_[ty * 48:(ty + 1) * 48, tx * 48:(tx + 1) * 48]
        for o, f in zip(outs, full):
            o[sl] = f[sl]
    res = mosaic_terrain_products(Z, mesh=mesh8, checkpoint=str(
        tmp_path / "partial.json"), out=outs, **kw)
    assert all(same(a, b) for a, b in zip(res, full))


def test_mesh_from_lazy_source(mesh8, tmp_path):
    Z = walk(17, (140, 120))
    fn = str(tmp_path / "dem.tif")
    ntt.write_geotiff(fn, Z, compress="deflate")
    kw = dict(cellsize=1, lookup_pixels=3, windows=np.array([1]),
              gi_radius=1, tile_size=48)
    a = mosaic_terrain_products(Z, device=CPU, **kw)
    b = mosaic_terrain_products(ntt.GeoTiffSource(fn), mesh=mesh8, **kw)
    assert all(same(x, y) for x, y in zip(a, b))


# ----------------------------------------------------------------------
# the wire, byte for byte
# ----------------------------------------------------------------------
WIRES = {
    "exact6": dict(compact=False, products=SIX),
    "compact6_u8": dict(compact=True, products=SIX, float_wire="uint8"),
    "compact_split": dict(compact=True,
                          products=("geomorphons", "moran", "gi")),
    "bitpack": dict(compact=True, products=("objects",), bitpack=True),
}


def _body_args(Z1):
    m = np.isfinite(Z1)
    mean = Z1[m].astype(np.float64).sum() / m.sum()
    s2 = (Z1[m].astype(np.float64) ** 2).sum() / m.sum() - mean ** 2
    return mean, s2, int(m.sum())


def _jax_body(Z1, block, compact, products, float_wire="bf16",
              bitpack=False):
    body = jmosaic._make_product_body(1.0, 4, 1.0, (1, 2), 2, False, False,
                                      20, compact, 48, OV, products, False,
                                      float_wire, bitpack)
    mean, s2, n = _body_args(Z1)
    return np.asarray(jax.jit(body)(
        jnp.asarray(block), jnp.asarray([.15, .3], jnp.float32),
        jnp.float32(mean), jnp.float32(s2), jnp.float32(n),
        jnp.float32(0), jnp.float32(0)))


def _port_body(Z1, block, compact, products, float_wire="bf16",
               bitpack=False):
    body = mosaic._make_product_body(1.0, 4, 1.0, (1, 2), 2, False, False,
                                     20, compact, 48, OV, products, False,
                                     float_wire, bitpack)
    mean, s2, n = _body_args(Z1)
    return body(torch.from_numpy(block), torch.tensor([.15, .3]), mean, s2,
                n, torch.tensor(0.0), torch.tensor(0.0)).numpy()


@pytest.fixture(scope="module")
def jax_wires(Z1):
    block = np.ascontiguousarray(Z1[20:80, 30:90])   # the hole inside
    return block, {k: _jax_body(Z1, block, **v) for k, v in WIRES.items()}


@pytest.mark.parametrize("wire", list(WIRES))
def test_wire_bytes_match_jax(Z1, jax_wires, wire):
    """The port's encoder, fed JAX's exact products of a tile, writes
    JAX's wire bytes; where no openness plane rides (the only products
    whose f32 bits differ) the port's whole tile program does too."""
    block, jw = jax_wires
    cfg = WIRES[wire]
    want = jw[wire]
    exact = junpack(jw["exact6"], jmosaic._wire_specs(False, SIX))
    vals = {p: torch.from_numpy(np.ascontiguousarray(a))
            for p, a in zip(SIX, exact)}
    enc = mosaic._encode(vals, cfg["products"], cfg["compact"], 48, 0,
                         cfg.get("float_wire", "bf16"),
                         cfg.get("bitpack", False)).numpy()
    assert enc.dtype == np.uint8 and np.array_equal(enc, want)
    got = _port_body(Z1, block, **cfg)
    assert got.shape == want.shape
    if "openness_pos" in cfg["products"]:
        n_open = 4 if not cfg["compact"] else 2
        cols = want.shape[1] - 2 * n_open * 48
        assert np.array_equal(got[:, :cols], want[:, :cols])
    else:
        assert np.array_equal(got, want)
    # the host decode maps the port's wire to the JAX package's products
    specs = mosaic._wire_specs(cfg["compact"], cfg["products"],
                               cfg.get("float_wire", "bf16"),
                               cfg.get("bitpack", False))
    dec = mosaic._make_decode(cfg["compact"], cfg["products"],
                              cfg.get("float_wire", "bf16"),
                              cfg.get("bitpack", False))
    jspecs = jmosaic._wire_specs(cfg["compact"], cfg["products"],
                                 cfg.get("float_wire", "bf16"),
                                 cfg.get("bitpack", False))
    jdec = jmosaic._make_decode(cfg["compact"], cfg["products"],
                                cfg.get("float_wire", "bf16"),
                                cfg.get("bitpack", False))
    ours = tiling._unpack_host(enc, specs)
    theirs = junpack(want, jspecs)
    ours, theirs = (dec(ours) if dec else ours), (jdec(theirs) if jdec
                                                  else theirs)
    assert all(same(a, np.asarray(b)) for a, b in zip(ours, theirs))


# ----------------------------------------------------------------------
# GeoTiffSource's array surface
# ----------------------------------------------------------------------
@pytest.mark.parametrize("layout", [dict(), dict(tiled=True, tile_size=32),
                                    dict(compress="deflate", tiled=True,
                                         tile_size=16)])
def test_geotiff_source_array_surface(tmp_path, layout):
    """``src[r0:r1, c0:c1]``, ``np.asarray(src)``, ``nbytes`` and ``len``
    equal the JAX GeoTiffSource on a stripped and a tiled file written by
    the port."""
    Z = walk(18, (75, 93))
    fn = str(tmp_path / "z.tif")
    ntt.write_geotiff(fn, Z, **layout)
    ours, theirs = ntt.GeoTiffSource(fn), JGeoTiffSource(fn)
    assert ours.nbytes == theirs.nbytes == Z.nbytes
    assert len(ours) == len(theirs) == 75
    assert same(np.asarray(ours), np.asarray(theirs))
    assert same(np.asarray(ours), Z)
    assert np.asarray(ours, dtype=np.float64).dtype == np.float64
    for key in (np.s_[10:40, 5:77], np.s_[70:], np.s_[3], np.s_[:, 92],
                np.s_[-1, 10:20], np.s_[5:5, :], np.s_[60:90, 80:200]):
        assert same(ours[key], theirs[key]), key
    for bad in (np.s_[::2], np.s_[0, 0, 0], np.s_[200]):
        with pytest.raises(IndexError):
            ours[bad]


# ----------------------------------------------------------------------
# the public names
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["tiled_apply", "apply_parallel",
                                  "TileCheckpoint",
                                  "mosaic_terrain_products"])
def test_out_of_core_names_match_the_jax_package(name):
    """The JAX arguments and defaults in order; the functions add
    ``device=None``."""
    ours = inspect.signature(getattr(ntt, name)).parameters
    theirs = inspect.signature(getattr(nt, name)).parameters
    extra = [] if name == "TileCheckpoint" else ["device"]
    assert list(ours) == list(theirs) + extra
    for p in theirs:
        assert ours[p].default == theirs[p].default, p
    if extra:
        assert ours["device"].default is None


def test_dist_names_match_the_jax_package():
    """``ntt.dist`` has every public name of ``nt.dist`` (the tiling
    exports too) and one more, ``Mesh``: the port's mesh is a
    single-process grid of torch devices, a class of its own where the
    JAX package uses ``jax.sharding.Mesh``."""
    ours = {n for n in dir(ntt.dist) if not n.startswith("_")}
    theirs = {n for n in dir(nt.dist) if not n.startswith("_")}
    assert ours - theirs == {"Mesh"}
    assert theirs - ours == set()
    for name in ("tiled_apply", "apply_parallel", "TileCheckpoint"):
        assert getattr(ntt.dist, name) is getattr(ntt, name)
        assert name in ntt.dist.__all__


# ----------------------------------------------------------------------
# on the card only
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mosaic_on_card_matches_cpu(cuda_device, Z1, port_exact):
    got = mosaic_terrain_products(Z1, products=SIX, wire="exact",
                                  device=cuda_device, **KW)
    for p, g, w in zip(SIX, got, port_exact):
        if p in ("openness_pos", "openness_neg"):
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=0)
        else:
            assert same(g, w), p
