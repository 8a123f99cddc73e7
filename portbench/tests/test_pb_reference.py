"""The plain reference against the port at small sizes on the CPU (only
this test imports both), and the reference's own imports."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference import geomorphons_l50, mosaic_trio, plain

from .conftest import ROOT


@pytest.mark.parametrize("fast", [False, True])
def test_classes_equal_the_ports(fast):
    import neilpy_tpu_torch as ntt
    Z = inputs.bench_input(1, (120, 150), 3, "cpu")[0]
    Z[40:45, 60:90] = float("nan")
    cfg = {"cellsize": 10.0, "lookup_pixels": 23, "threshold_angle": 1.0,
           "enhance": False}
    call = {"fast": fast, "how_fast": 20}
    want = ntt.geomorphons(Z, cellsize=10, lookup_pixels=23, fast=fast,
                           device="cpu")
    got = geomorphons_l50.classes_of(Z, cfg, call)
    assert geomorphons_l50.class_diff_px(got, want) == 0
    low = geomorphons_l50.classes_of(Z, cfg, call, torch.bfloat16)
    assert geomorphons_l50.class_diff_px(low, want) > 0


def test_mosaic_reference_equals_the_ports_trio():
    import neilpy_tpu_torch as ntt
    cfg = json.loads((ROOT / "portbench/configs/mosaic_trio.json")
                     .read_text())
    cfg.update(extent=520, tile_size=200, lookup_pixels=9)
    Z = inputs.synth_dem(520, 9, "cpu").numpy()
    G, O, M = ntt.mosaic_terrain_products(
        Z, cellsize=10, lookup_pixels=9, windows=np.array(cfg["windows"]),
        gi_radius=3, slope_threshold=.15, tile_size=200, device="cpu",
        device_input=False)
    for (r0, r1, c0, c1), c, o, m in mosaic_trio.products(Z, cfg, "cpu"):
        assert np.array_equal(c.numpy(), G[r0:r1, c0:c1])
        assert np.array_equal(o.numpy(), O[r0:r1, c0:c1])
        np.testing.assert_allclose(M[r0:r1, c0:c1], m.numpy(), rtol=1e-4,
                                   atol=1e-3)


def test_overlap_is_the_ports():
    from neilpy_tpu_torch.pipelines.mosaic import required_overlap
    cfg = {"lookup_pixels": 50, "windows": [1, 2, 4], "gi_radius": 3}
    assert mosaic_trio.overlap(cfg) == required_overlap(50, [1, 2, 4], 3)
    cfg["lookup_pixels"] = 9
    assert mosaic_trio.overlap(cfg) == required_overlap(9, [1, 2, 4], 3)


def test_plain_pieces_are_the_ports():
    from neilpy_tpu_torch.core import codes, shift
    assert plain.OFFSETS == shift.OFFSETS
    assert np.array_equal(plain.js_table(),
                          codes.jasiewicz_stepinski_table())
    for R in (1, 7, 50, 120):
        assert plain.scan_ladder(R, True) == tuple(
            int(v) for v in codes.progressive_window(1, R, 20))
    X = torch.arange(30.0).reshape(5, 6)
    assert torch.equal(plain.pad_symmetric(X, 3),
                       torch.from_numpy(np.pad(X.numpy(), 3, "symmetric")))
    assert torch.equal(plain.pad_edge(X, 2),
                       torch.from_numpy(np.pad(X.numpy(), 2, "edge")))


def test_reference_imports_neither_jax_nor_the_packages():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.geomorphons_l50, "
            "portbench.reference.mosaic_trio, portbench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'neilpy_tpu', 'neilpy_tpu_torch'}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_reference_equals_the_kernels_on_the_card(cuda_device):
    import neilpy_tpu_torch as ntt
    Z = inputs.bench_input(1, (700, 900), 5, cuda_device)[0]
    cfg = {"cellsize": 10.0, "lookup_pixels": 50, "threshold_angle": 1.0,
           "enhance": False}
    for fast in (False, True):
        want = ntt.geomorphons(Z, cellsize=10, lookup_pixels=50, fast=fast)
        got = geomorphons_l50.classes_of(Z, cfg, {"fast": fast})
        assert geomorphons_l50.class_diff_px(got, want) == 0
