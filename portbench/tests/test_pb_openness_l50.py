"""``openness_l50`` among the benchmark's CPU tests: its small size for
the cell-wide tests of ``test_pb_harness.py`` (registered when this module
is collected, as pytest collects a directory's modules before it runs any
test), and the port against its reference at that size.  The tier-1 tests
of the cell are ``tests/test_torch_openness_bench.py``."""

import json

from portbench import inputs
from portbench.reference import openness_l50 as reference

from . import conftest

# 96 x 128 at the cell's lookup 50, three sampled jobs
conftest.SMALL.setdefault("openness_l50", {
    "config": {"raster": [96, 128]}, "traffic": {"sample_outputs": 3}})


def test_the_port_agrees_with_the_reference_at_the_small_size():
    import neilpy_tpu_torch as ntt
    cfg = json.loads((conftest.ROOT / "portbench/configs/openness_l50.json")
                     .read_text())
    cfg.update(conftest.SMALL["openness_l50"]["config"])
    Z = inputs.bench_input(1, tuple(cfg["raster"]), 4, "cpu")[0]
    kw = dict(cellsize=cfg["cellsize"], lookup_pixels=cfg["lookup_pixels"],
              device="cpu")
    got = (*ntt.openness_pair(Z, **kw), ntt.skyview_factor(Z, **kw))
    numbers = reference.differences(got, reference.relief(Z, cfg))
    assert all(v <= cfg["limits"][k] for k, v in numbers.items())
