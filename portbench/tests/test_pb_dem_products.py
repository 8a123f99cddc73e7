"""``dem_products`` among the benchmark's CPU tests: its small size for
the cell-wide tests of ``test_pb_harness.py`` (registered when this module
is collected, as pytest collects a directory's modules before it runs any
test), its files found by name, and its place in the manifest.  The
tier-1 tests of the cell are ``tests/test_torch_dem_products_bench.py``."""

import json

from portbench import harness

from . import conftest

CELL = "dem_products.resident"
METRICS = ["dem_products_roofline", "device.idle_pct.dem_products",
           "dem_products.launches_per_job", "dem_products.gi_ms_per_job",
           "dem_products.curvature_ms_per_job",
           "dem_products.host_ms_per_job"]

# 263 x 257 with voids of radius 2-8, radii (2, 5), three sampled jobs
conftest.SMALL.setdefault("dem_products", {
    "config": {"raster": [263, 257], "radii": [2, 5],
               "voids": {"share": 0.01, "radius": [2, 8]}},
    "traffic": {"sample_outputs": 3}})


def test_the_cells_files_are_found_by_name():
    cell = harness.CellSpec(CELL)
    assert cell.config_entry["file"] == "portbench/configs/dem_products.json"
    assert cell.config["name"] == "dem_products"
    assert cell.system_path.name == "dem_products.py"
    assert cell.system_path.is_file() and cell.reference_path.is_file()
    assert cell.entry["traffic"] == "resident" and cell.traffic == {
        "placement": "device", "inputs": 4, "call": {}, "sample_outputs": 8}
    assert [m["name"] for m in cell.metrics("per_layer")] == METRICS
    for name in METRICS:
        assert cell.metric_path(name).is_file()
        reader = harness.load_module(cell.metric_path(name),
                                     f"portbench.metrics.{name}")
        assert reader.read(harness.Run(jobs=[], trace=None, work=None)) \
            is None


def test_the_cell_reports_the_resident_cells_metrics():
    man = json.loads((conftest.ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for name in ("raster_mpix_s", "job_p95_ms"):
        assert e2e[name]["workloads"][-1] == CELL
    assert {m["name"] for m in harness.CellSpec(CELL).metrics(
        "end_to_end")} == {"raster_mpix_s", "job_p95_ms", "setup_s"}


def test_at_most_a_quarter_of_the_cells_ask_for_four_chips():
    man = json.loads((conftest.ROOT / "BENCHMARK.json").read_text())
    cells = man["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    assert {w["name"]: w["chips"] for w in cells}[CELL] == 1
