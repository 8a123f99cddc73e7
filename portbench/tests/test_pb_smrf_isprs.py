"""``smrf_isprs`` among the benchmark's CPU tests: its small size for the
cell-wide tests of ``test_pb_harness.py`` (registered when this module is
collected, as pytest collects a directory's modules before it runs any
test), and its reference against the port at that size.  The tier-1
tests of the cell are ``tests/test_torch_smrf_bench.py``."""

import json

from portbench.reference import smrf_isprs as reference
from portbench.systems import smrf_isprs as system

from . import conftest

# about 20,000 points over 130 m (a 133^2 grid), windows 18, two clouds
conftest.SMALL.setdefault("smrf_isprs", {
    "config": {"points": 20_000, "extent": 130.0},
    "traffic": {"inputs": 2}})


def test_the_port_agrees_with_the_reference_at_the_small_size():
    import numpy as np
    import neilpy_tpu_torch as ntt
    cfg = json.loads((conftest.ROOT / "portbench/configs/smrf_isprs.json")
                     .read_text())
    cfg.update(conftest.SMALL["smrf_isprs"]["config"])
    x, y, z = system.lidar_tile(np.random.default_rng(4), cfg["points"],
                                cfg["extent"])
    dtm, _, _, labels = ntt.smrf(x, y, z, cfg["cellsize"], cfg["windows"],
                                 cfg["slope_threshold"],
                                 cfg["elevation_threshold"],
                                 cfg["elevation_scaler"], device="cpu")
    got = system.compare(labels.numpy(), dtm.numpy(),
                         reference.smrf(x, y, z, cfg, "cpu"), "cpu",
                         cfg["dtm_tolerance_m"])
    assert all(v <= cfg["limits"][k] for k, v in got.items())
